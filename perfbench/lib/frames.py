"""Seeded frames and label maps, made on the device in bulk.

A frame is a level per channel (88-168: frames differ in light and
colour, as a camera's do over a day) plus four low-frequency sinusoids
per channel (amplitude 20-60, 0.5-6 periods across the frame, any
direction and phase) plus Gaussian noise of 8, clipped to uint8: random
pixels would average out in the trunk and give one class everywhere.  A
label map is the argmax over the classes of one sinusoid each (0.5-4
periods), so that regions are contiguous as a teacher's labels are.
"""

from __future__ import annotations

import math

import torch


def _grid(h, w, device):
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    return yy, xx


def _waves(gen, shape, h, w, lo, hi, device):
    """(frequency y, frequency x, phase) tensors of ``shape``."""
    def u(a, b):
        return a + (b - a) * torch.rand(shape, generator=gen, device=device)
    return u(lo, hi) / h, u(lo, hi) / w, u(0, 2 * math.pi)


def frames(n: int, h: int, w: int, seed: int, device, chunk: int = 8):
    """(n, h, w, 3) uint8 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    fy, fx, ph = _waves(gen, (n, 3, 4), h, w, 0.5, 6.0, device)
    amp = 20 + 40 * torch.rand((n, 3, 4), generator=gen, device=device)
    level = 88 + 80 * torch.rand((n, 3), generator=gen, device=device)
    yy, xx = _grid(h, w, device)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = level[s:e, :, None, None].expand(-1, -1, h, w).clone()
        for k in range(4):
            arg = 2 * math.pi * (fy[s:e, :, k, None, None] * yy
                                 + fx[s:e, :, k, None, None] * xx) \
                + ph[s:e, :, k, None, None]
            x += amp[s:e, :, k, None, None] * torch.sin(arg)
        x += 8 * torch.randn(x.shape, generator=gen, device=device)
        out[s:e] = x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out


def labels(n: int, h: int, w: int, num_classes: int, seed: int, device,
           chunk: int = 4):
    """(n, h, w) uint8 class ids in [0, num_classes) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    fy, fx, ph = _waves(gen, (n, num_classes), h, w, 0.5, 4.0, device)
    yy, xx = _grid(h, w, device)
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        arg = 2 * math.pi * (fy[s:e, :, None, None] * yy
                             + fx[s:e, :, None, None] * xx) \
            + ph[s:e, :, None, None]
        out[s:e] = torch.sin(arg).argmax(dim=1).to(torch.uint8)
    return out
