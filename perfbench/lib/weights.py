"""Seeded weights under the TF variable names, made on the device in one
draw.

Convolution weights come from a normal truncated to [-2, 2], times
sqrt(1 / fan-in); BN scales from U(0.75, 1.25), offsets from U(1, 2),
so that a ReLU6 after a BN clips a few percent of its inputs (with
offsets near 0 it clips half, and a deep random network amplifies
rounding errors from layer to layer); the logits' bias is zero.  The
moving statistics are then set from seeded frames by the reference's
calibration (``reference.common.calibrate_bn``): left at (0, 1), seeded
weights make the logits of a deep network vanish and every pixel tie.
"""

from __future__ import annotations

import math

import torch

_LO, _HI = 0.5 * (1 + math.erf(-2 / math.sqrt(2))), \
    0.5 * (1 + math.erf(2 / math.sqrt(2)))


def init(specs, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for ``specs`` ([(name, shape,
    fan-in)]), from one uniform draw of a generator on the device."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, fan), n in zip(specs, sizes):
        x = u[at:at + n].view(shape)
        at += n
        if fan is not None:
            p = _LO + x * (_HI - _LO)
            out[name] = torch.erfinv(2 * p - 1) * (math.sqrt(2)
                                                   / math.sqrt(fan))
        elif name.endswith("/gamma"):
            out[name] = 0.75 + 0.5 * x
        elif name.endswith("/beta"):
            out[name] = 1.0 + x
        elif name.endswith("/moving_variance"):
            out[name] = torch.ones_like(x)
        else:            # moving means, biases
            out[name] = torch.zeros_like(x)
    return out
