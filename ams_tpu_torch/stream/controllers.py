"""Adaptive Sampling Rate (ASR) and Adaptive Training Rate (ATR) controllers
(a copy of ``ams_tpu/stream/controllers.py``, which is numpy only).

ASR (reference run.py:279-290): at every training event, measure the mean
temporal cross-mIoU ("phi score") between consecutive buffered teacher labels
over the frames received since the last event, then nudge the uplink sampling
rate:  send_rate -= 0.2 * tanh((phi - 0.6) * 20), clipped to [0.1, 1].

ATR (reference run.py:292-307, state init :121-130): a hibernation state
machine over the recent send-rate history (deque of 5): enter hibernation
when mean < 0.25, leave when mean > 0.35; while hibernating the training
period grows by +2 s per event up to 6x the base period, and the remaining
schedule is rewritten accordingly.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np


class ASRController:
    """phi-score driven sampling-rate controller."""

    GAIN = 0.2
    CENTER = 0.6
    SLOPE = 20.0
    LO, HI = 0.1, 1.0

    def __init__(self, initial_send_rate: float):
        self.send_rate = float(initial_send_rate)

    def update(self, cross_mious: List[float]) -> float:
        # A label pair with zero selected-class pixels yields a NaN phi
        # (all-zero cross confusion matrix -> all-NaN IoU); one such entry
        # would otherwise poison send_rate permanently and later crash
        # choose_frames (int(round(nan*n))).  Ignore non-finite entries;
        # with none left, hold the current rate.
        finite = [p for p in cross_mious if np.isfinite(p)]
        if not finite:
            return self.send_rate
        phi = float(np.mean(finite))
        self.send_rate = float(np.clip(
            self.send_rate - self.GAIN * np.tanh((phi - self.CENTER) * self.SLOPE),
            self.LO, self.HI))
        return self.send_rate


class ATRController:
    """Hibernation state machine scaling the training period."""

    ENTER_BELOW = 0.25
    EXIT_ABOVE = 0.35
    GROW_STEP = 2
    MAX_FACTOR = 6

    def __init__(self, base_train_period: int, history: int = 5):
        self.base = int(base_train_period)
        self.current = int(base_train_period)
        self.hibernating = False
        self.send_rate_history = deque(maxlen=history)

    def observe_send_rate(self, send_rate: float) -> None:
        self.send_rate_history.append(float(send_rate))

    def update(self) -> int:
        """Advance the state machine; returns the current training period."""
        mean = float(np.mean(list(self.send_rate_history))) \
            if self.send_rate_history else 1.0
        if mean < self.ENTER_BELOW:
            self.hibernating = True
        if mean > self.EXIT_ABOVE and self.hibernating:
            self.hibernating = False
            self.current = self.base
        if self.hibernating:
            self.current = min(self.current + self.GROW_STEP,
                               self.MAX_FACTOR * self.base)
        return self.current

    def rewrite_schedule(self, save_range: List[int], now_s: int,
                         end_s: int) -> List[int]:
        """Rebuild the remaining event schedule from ``now_s`` with the
        current period (run.py:303-307)."""
        idx = save_range.index(now_s)
        out = list(save_range[:idx])
        out.extend(range(now_s, end_s, self.current))
        if now_s not in out:
            raise RuntimeError("schedule rewrite lost second %d" % now_s)
        return out
