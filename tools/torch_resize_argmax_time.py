#!/usr/bin/env python3
"""Time the port's resize+argmax kernel (K1) of one checkout on the card.

    python3 tools/torch_resize_argmax_time.py [ROOT]

Imports ``ams_tpu_torch`` from the checkout at ROOT (default: this one),
which builds its K1 there, and times ``fused_resize_argmax`` at the edge
client's shape (B=8, C=19, 33x65 -> 512x1024, a float32 NCHW grid from
seed 0): per call by CUDA events over 100 back-to-back calls, and on the
device by torch.profiler's kernel durations over 100 calls (the
``cuda_ms`` and ``device_ms`` of this checkout's chip_smoke.py).  It
checks the ids against the checkout's ``resize_argmax_plain`` off near
ties and prints one JSON line with the card's name and power limit.

Every version of the port takes ``fused_resize_argmax(grid, out_hw)``, so
two checkouts (e.g. ``git archive`` of a parent commit) compare on one
card in one run: run this once per checkout, in turns.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from ams_tpu_torch.ops import fused_resize_argmax as fra

    b, c, gh, gw, h, w = 8, 19, 33, 65, 512, 1024
    gen = torch.Generator().manual_seed(0)
    grid = (torch.randn(b, c, gh, gw, generator=gen) * 3).cuda()
    got = fra.fused_resize_argmax(grid, (h, w))
    want = fra.resize_argmax_plain(grid, (h, w))
    off = int(((got != want) & ~smoke.near_ties(grid, (h, w))).sum())
    if off:
        print("%s: %d ids differ off ties" % (root, off), file=sys.stderr)
        return 1

    def kernel():
        return fra.fused_resize_argmax(grid, (h, w))

    row = {"root": root, "module": fra.__file__,
           "shape": [b, c, gh, gw, h, w],
           "ms": smoke.cuda_ms(kernel, 100),
           "device_ms": smoke.device_ms(kernel, 100),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smoke.nvidia_smi()}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
