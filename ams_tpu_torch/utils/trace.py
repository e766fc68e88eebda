"""Tracing and per-phase timing.

Counterpart of ``ams_tpu/utils/trace.py``.  ``PhaseTimer`` records named
wall-clock spans with counts and totals; ``profile_trace`` wraps a block in
``torch.profiler`` (host, and the card when there is one) and writes a
Chrome trace into the trace directory (open it in Perfetto or
chrome://tracing); ``annotate`` names a region in that trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Named wall-clock span accumulator."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def summary(self) -> str:
        lines = ["%-28s %8s %10s %10s" % ("phase", "count", "total_s",
                                          "mean_ms")]
        for name in sorted(self.totals):
            n = self.counts[name]
            lines.append("%-28s %8d %10.2f %10.1f"
                         % (name, n, self.totals[name],
                            1000 * self.totals[name] / max(n, 1)))
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.last.clear()


GLOBAL_TIMER = PhaseTimer()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block, its Chrome trace written to
    ``trace_dir/trace_<pid>.json``; a no-op when trace_dir is empty."""
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          "trace_%d.json" % os.getpid()))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in profiler timelines."""
    import torch

    with torch.profiler.record_function(name):
        yield
