"""TF1-compatible align-corners bilinear resizing in PyTorch.

Counterpart of ``ams_tpu/models/resize.py``.  ``torch.nn.functional.
interpolate(align_corners=True)`` samples the same points but rounds
differently, so the resize here is TF's separable gather + lerp with the
same formula order (``top + (bottom - top) * y_lerp``), which keeps float
rounding identical to the reference.

The public functions take channels-last ``(B, H, W, C)`` tensors like the
JAX package; ``resize_nchw`` is the same map on the port's internal
channels-first layout.  ``resize_nearest_ac`` (TF's nearest-neighbour
resize) takes ``(..., H, W)``, so NCHW and bare ``(H, W)`` maps alike.
"""

from __future__ import annotations

import functools

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


def lerp_bands(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, 2) int32 [start, end) of the output rows whose ``lo`` is
    each input row: the rows that lerp between the same two input rows.
    Contiguous, since ``lo`` never decreases; empty when out_size <
    in_size skips the row; one row where ``lo == hi``."""
    lo, _, _ = _lerp_weights(in_size, out_size)
    g = np.arange(in_size)
    return np.stack([np.searchsorted(lo, g, "left"),
                     np.searchsorted(lo, g, "right")], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_lerp(in_size: int, out_size: int, device: torch.device):
    """(lo int64, hi int64, w f32) lerp tables on ``device``, one upload
    per shape: a host-to-device copy per call would wait for the device.
    Made outside inference mode, so that autograd may save them."""
    lo, hi, w = _lerp_weights(in_size, out_size)
    with torch.inference_mode(False):
        return (torch.from_numpy(lo).long().to(device),
                torch.from_numpy(hi).long().to(device),
                torch.from_numpy(w).to(device))


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


def resize_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Align-corners bilinear resize of a (B, C, H, W) tensor, in f32."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    orig_dtype = x.dtype
    x = x.float()
    ylo, yhi, yw = _device_lerp(h, oh, x.device)
    xlo, xhi, xw = _device_lerp(w, ow, x.device)

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


def resize_nchw_matmul(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``resize_nchw`` as two dense products ``R @ x @ C^T`` on a
    (B, C, H, W) tensor.  Forward values agree with the gather form to f32
    reassociation, not bit for bit; its backward is two more products."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    orig_dtype = x.dtype
    x = x.float()
    r = _device_matrix(h, oh, x.device)       # (oh, h)
    cm = _device_matrix(w, ow, x.device)      # (ow, w)
    t = torch.einsum("Hg,bcgw->bcHw", r, x)
    out = torch.einsum("Ww,bcHw->bcHW", cm, t)
    return out.to(orig_dtype)


def resize_bilinear_ac_matmul(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Counterpart of ``resize_bilinear_ac_matmul``: the align-corners map
    of ``resize_bilinear_ac`` as dense products, on (B, H, W, C)."""
    return resize_nchw_matmul(x.permute(0, 3, 1, 2),
                              out_hw).permute(0, 2, 3, 1)


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) dense align-corners lerp matrix, 2 nnz/row."""
    lo, hi, w = _lerp_weights(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


def _nearest_index(in_size: int, out_size: int, align_corners: bool
                   ) -> np.ndarray:
    """TF's nearest source index per output position, clamped to in-1.
    Under align_corners the source coordinate i * (in-1)/(out-1) rounds
    half AWAY from zero (C's ``roundf``), ``floor(src + 0.5)`` for these
    non-negative values: ``np.rint``'s half-to-even would pick another
    pixel wherever src lands on .5 (3 -> 5: src 0.5 maps to 1).  Otherwise
    it is ``floor(i * in / out)``."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        idx = np.floor(i * _ac_scale(in_size, out_size) + 0.5)
    else:
        idx = np.floor(i * in_size / out_size)
    return np.minimum(idx.astype(np.int64), in_size - 1)


def resize_nearest_ac(x: torch.Tensor, out_hw, align_corners: bool = True
                      ) -> torch.Tensor:
    """tf.image.resize_nearest_neighbor of the last two axes of ``x``
    (``(..., H, W)``), align_corners configurable (default True)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    yi = torch.from_numpy(_nearest_index(h, oh, align_corners)).to(x.device)
    xi = torch.from_numpy(_nearest_index(w, ow, align_corners)).to(x.device)
    return x.index_select(x.dim() - 2, yi).index_select(x.dim() - 1, xi)
