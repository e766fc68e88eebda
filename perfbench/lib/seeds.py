"""Every random stream of a run derives from ``--seed`` by a path of
names, so that the same seed gives the same inputs and weights, and two
purposes never share a stream."""

from __future__ import annotations

import zlib

import numpy as np


def sub(seed: int, *path) -> int:
    """A 63-bit seed for the stream named by ``path`` under ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [zlib.crc32(str(p).encode()) for p in path]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) & (2 ** 63 - 1)
