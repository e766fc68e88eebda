"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``perfbench/traffic/``, found by its name.

Keys every mix has: ``entry`` (the module of ``perfbench/entries/`` that
drives the program) and ``loop``: "closed" (the next request goes when the
last one is answered) or "open" (requests fall due at ``rate_per_s``,
``arrivals`` "fixed" or "poisson", and each is timed from when it was
due).  Serving mixes give ``pool_batches``: how many distinct batches of
frames the seed makes; request i takes batch ``order[i]`` of a seeded
sequence of permutations of the pool, so every seed offers the same sizes
in another order.  The window keeps one request in flight: a mix that
states ``in_flight`` other than 1 is refused, not run as one.  The rest
of a mix's keys are its entry's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from perfbench.lib import seeds


def load(root: Path, name: str) -> dict:
    with open(Path(root) / "perfbench" / "traffic" / (name + ".json")) as f:
        mix = json.load(f)
    if mix.get("loop") not in ("closed", "open"):
        raise ValueError("traffic %s: loop must be closed or open" % name)
    if mix.get("in_flight", 1) != 1:
        raise ValueError("traffic %s: the window keeps one request in "
                         "flight, not %r" % (name, mix["in_flight"]))
    return mix


class Schedule:
    """Which pool batch request i takes, and when it falls due (seconds
    after the window opens; 0 for a closed loop)."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.pool = int(mix.get("pool_batches", 1))
        self._rng = np.random.default_rng(seeds.sub(seed, "order"))
        self._order = []
        self._due = 0.0
        self._arrivals = np.random.default_rng(seeds.sub(seed, "arrivals"))

    def batch(self, i: int) -> int:
        while len(self._order) <= i:
            self._order.extend(self._rng.permutation(self.pool).tolist())
        return self._order[i]

    def next_due(self) -> float:
        """The due time of the next request of an open loop."""
        if self.mix["loop"] == "closed":
            return 0.0
        rate = float(self.mix["rate_per_s"])
        gap = 1.0 / rate if self.mix.get("arrivals", "fixed") == "fixed" \
            else float(self._arrivals.exponential(1.0 / rate))
        due, self._due = self._due, self._due + gap
        return due
