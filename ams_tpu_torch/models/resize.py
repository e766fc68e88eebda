"""TF1-compatible align-corners bilinear resizing in PyTorch.

Counterpart of ``ams_tpu/models/resize.py``.  ``torch.nn.functional.
interpolate(align_corners=True)`` samples the same points but rounds
differently, so the resize here is TF's separable gather + lerp with the
same formula order (``top + (bottom - top) * y_lerp``), which keeps float
rounding identical to the reference.

The public functions take channels-last ``(B, H, W, C)`` tensors like the
JAX package; ``resize_nchw`` is the same map on the port's internal
channels-first layout.
"""

from __future__ import annotations

import numpy as np
import torch


def _ac_scale(in_size: int, out_size: int) -> float:
    """align_corners scale factor: (in-1)/(out-1)."""
    if out_size > 1:
        return (in_size - 1) / (out_size - 1)
    return 0.0


def _lerp_weights(in_size: int, out_size: int):
    """(lo int32, hi int32, w float32) numpy tables: source coordinates in
    float64, the fraction cast to float32 (ams_tpu resize.py:25-31)."""
    src = np.arange(out_size, dtype=np.float64) * _ac_scale(in_size, out_size)
    lo = np.floor(src).astype(np.int32)
    lo = np.minimum(lo, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


def resize_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Align-corners bilinear resize of a (B, C, H, W) tensor, in f32."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    orig_dtype = x.dtype
    x = x.float()
    dev = x.device
    ylo, yhi, yw = (torch.from_numpy(a).to(dev) for a in _lerp_weights(h, oh))
    xlo, xhi, xw = (torch.from_numpy(a).to(dev) for a in _lerp_weights(w, ow))
    ylo, yhi, xlo, xhi = ylo.long(), yhi.long(), xlo.long(), xhi.long()

    top = x.index_select(2, ylo)
    bot = x.index_select(2, yhi)

    def h_lerp(rows):
        left = rows.index_select(3, xlo)
        right = rows.index_select(3, xhi)
        return left + (right - left) * xw

    top = h_lerp(top)
    bot = h_lerp(bot)
    out = top + (bot - top) * yw[:, None]
    return out.to(orig_dtype)


def resize_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """tf.image.resize_bilinear(align_corners=True, half_pixel_centers=False)
    on a (B, H, W, C) tensor; returns (B, out_h, out_w, C) of x.dtype."""
    return resize_nchw(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) dense align-corners lerp matrix, 2 nnz/row."""
    lo, hi, w = _lerp_weights(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m
