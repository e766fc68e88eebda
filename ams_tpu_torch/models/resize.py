"""TF1-compatible align-corners bilinear resizing in PyTorch.

Counterpart of ``ams_tpu/models/resize.py``.  ``torch.nn.functional.
interpolate(align_corners=True)`` samples the same points but rounds
differently, so the resize here is TF's separable gather + lerp with the
same formula order (``top + (bottom - top) * y_lerp``), which keeps float
rounding identical to the reference.

The public functions take channels-last ``(B, H, W, C)`` tensors like the
JAX package; ``resize_nchw`` is the same map on the port's internal
channels-first layout, and may compute a range of output columns alone
(a width shard's, ``parallel.spatial``).

The gathers' backward sums each source row's band of output rows in a
fixed order (``_banded_select``): ``index_select``'s own backward,
``index_add_``, adds them by atomics on the card, in an order that changes
from run to run, so two runs of the same round would differ.

``resize_nearest_ac`` (TF's nearest-neighbour resize) takes ``(..., H,
W)``, so NCHW and bare ``(H, W)`` maps alike.
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
def _device_bands(in_size: int, out_size: int, lo: int, hi: int,
                  device: torch.device):
    """For the lerp's two source-row tables (``lo`` and ``hi`` of
    ``_lerp_weights``, output positions ``lo:hi``): each source row's
    (in_size, band) positions in the table, padded with the table's length
    (a zero row the backward appends).  Both tables are non-decreasing,
    so a source row's positions are contiguous."""
    out = []
    for idx in _lerp_weights(in_size, out_size)[:2]:
        idx = idx[lo:hi]
        start = np.searchsorted(idx, np.arange(in_size), "left")
        count = np.searchsorted(idx, np.arange(in_size), "right") - start
        j = np.arange(max(int(count.max(initial=0)), 1))
        out.append(np.where(j[None, :] < count[:, None],
                            start[:, None] + j[None, :], len(idx)))
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in out)


class _BandedSelect(torch.autograd.Function):
    """``x.index_select(dim, idx)`` for a non-decreasing ``idx``; the
    backward gathers each source row's band of output gradients (zeros
    past its end) and sums over the band axis, in a fixed order."""

    @staticmethod
    def forward(ctx, x, dim, idx, table):
        ctx.dim = dim
        ctx.save_for_backward(table)
        return x.index_select(dim, idx)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        dim = ctx.dim
        zero = g.new_zeros(g.shape[:dim] + (1,) + g.shape[dim + 1:])
        picked = torch.cat([g, zero], dim).index_select(dim,
                                                        table.reshape(-1))
        shape = g.shape[:dim] + tuple(table.shape) + g.shape[dim + 1:]
        return picked.reshape(shape).sum(dim + 1), None, None, None


def _banded_select(x: torch.Tensor, dim: int, idx: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, idx)``, with the deterministic backward of
    ``_BandedSelect`` (``table`` from ``_device_bands``) when ``x`` needs a
    gradient."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(dim, idx)
    return _BandedSelect.apply(x, dim, idx, table)


@functools.lru_cache(maxsize=None)
def _device_matrix(in_size: int, out_size: int, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


def resize_nchw(x: torch.Tensor, out_hw, cols=None) -> torch.Tensor:
    """Align-corners bilinear resize of a (B, C, H, W) tensor, in f32;
    with ``cols=(lo, hi)``, only those output columns, each computed as
    in the whole resize."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    lo, hi = (0, ow) if cols is None else (int(cols[0]), int(cols[1]))
    if (oh, ow) == (h, w):
        return x if cols is None else x[..., lo:hi]
    orig_dtype = x.dtype
    x = x.float()
    ylo, yhi, yw = _device_lerp(h, oh, x.device)
    xlo, xhi, xw = (t[lo:hi] for t in _device_lerp(w, ow, x.device))
    ylo_t, yhi_t = _device_bands(h, oh, 0, oh, x.device)
    xlo_t, xhi_t = _device_bands(w, ow, lo, hi, x.device)

    top = _banded_select(x, 2, ylo, ylo_t)
    bot = _banded_select(x, 2, yhi, yhi_t)

    def h_lerp(rows):
        left = _banded_select(rows, 3, xlo, xlo_t)
        right = _banded_select(rows, 3, xhi, xhi_t)
        return left + (right - left) * xw

    top = h_lerp(top)
    bot = h_lerp(bot)
    out = top + (bot - top) * yw[:, None]
    return out.to(orig_dtype)


def resize_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """tf.image.resize_bilinear(align_corners=True, half_pixel_centers=False)
    on a (B, H, W, C) tensor; returns (B, out_h, out_w, C) of x.dtype."""
    return resize_nchw(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def resize_nchw_matmul(x: torch.Tensor, out_hw, cols=None) -> torch.Tensor:
    """``resize_nchw`` as two dense products ``R @ x @ C^T`` on a
    (B, C, H, W) tensor.  Forward values agree with the gather form to f32
    reassociation, not bit for bit; its backward is two more products.
    ``cols`` as in ``resize_nchw``."""
    h, w = x.shape[2], x.shape[3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    lo, hi = (0, ow) if cols is None else (int(cols[0]), int(cols[1]))
    if (oh, ow) == (h, w):
        return x if cols is None else x[..., lo:hi]
    orig_dtype = x.dtype
    x = x.float()
    r = _device_matrix(h, oh, x.device)       # (oh, h)
    cm = _device_matrix(w, ow, x.device)[lo:hi]     # (hi - lo, w)
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
