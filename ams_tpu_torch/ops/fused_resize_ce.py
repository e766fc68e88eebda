"""Fused align-corners bilinear upsample + masked softmax cross-entropy.

Counterpart of ``ams_tpu/ops/fused_resize_ce.py``.  The distillation loss
is the CE between the student's upsampled logits and the teacher's labels
at full resolution.  In plain tensor ops the full-resolution logits and
their cotangent hit device memory (10x19x256x512 f32 = 100 MB each per
training iteration); the kernels in ``csrc/resize_ce.cu`` read only the
grid logits, labels and weights, and write a scalar loss (forward) or the
grid-logit gradient (backward).

``fused_resize_ce`` is the wrapper, a ``torch.autograd.Function`` on the
card: a CPU tensor goes to the plain version, whose gradient autograd
supplies; a CUDA tensor launches the kernels, and nothing falls back from
one to the other.  ``resize_ce_plain`` is the plain version, the CPU path
and the kernels' oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ams_tpu_torch.models.resize import _lerp_weights, resize_nchw
from ams_tpu_torch.ops import build

SOURCE = "ams_tpu_torch/csrc/resize_ce.cu"
REPLACES = ("ams_tpu/ops/fused_resize_ce.py:37 (_make_kernel; custom_vjp "
            "fused_resize_ce :161, _fwd :175, _bwd :184)")
# Shared memory a block may use on Hopper, less the kernel's static arrays.
_SMEM_LIMIT = 232448 - 8192


def resize_ce_plain(grid: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, out_hw) -> torch.Tensor:
    """sum(CE(resize_bilinear_ac(grid), labels) * weights) /
    max(sum(weights), 1), with grid (B, C, gh, gw).  A label outside
    [0, C) has an all-zero one-hot row (CE 0), as ``jax.nn.one_hot``
    gives it in ``resize_ce_reference``."""
    full = resize_nchw(grid.float(), out_hw)
    logp = torch.log_softmax(full, dim=1)
    classes = torch.arange(full.shape[1], device=full.device)
    onehot = (labels.long()[:, None] == classes[None, :, None, None]).float()
    ce = -torch.sum(onehot * logp, dim=1)
    w = weights.float()
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def _ranges(lo: np.ndarray, hi: np.ndarray, n_in: int) -> np.ndarray:
    """(4 * n_in,) int32: for each input index g, [start, end) of the
    outputs whose ``lo`` is g, then [start, end) of those whose ``hi`` is
    g.  Both tables are non-decreasing, so each set is contiguous."""
    g = np.arange(n_in)
    out = np.stack([np.searchsorted(lo, g, "left"),
                    np.searchsorted(lo, g, "right"),
                    np.searchsorted(hi, g, "left"),
                    np.searchsorted(hi, g, "right")], axis=1)
    return out.astype(np.int32).reshape(-1)


@functools.lru_cache(maxsize=None)
def _tables(gh: int, gw: int, h: int, w: int, device: torch.device):
    """Device copies of the host-built lerp tables and their inverse
    ranges, one upload per shape: (ylo, yhi, yw, xlo, xhi, xw, yr, xr)."""
    ylo, yhi, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    host = (ylo, yhi, yw, xlo, xhi, xw, _ranges(ylo, yhi, gh),
            _ranges(xlo, xhi, gw))
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in host)


def _function(name, n_ptr):
    fn = getattr(build.load("resize_ce"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(err, name):
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))


def resize_ce_fwd(grid, labels, weights, out_hw):
    """Launch the forward kernel: -> (loss, total) 0-dim f32 tensors,
    total = max(sum(weights), 1)."""
    b, c, gh, gw = grid.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    tables = _tables(gh, gw, h, w, grid.device)
    partial = torch.empty(2 * b * h, dtype=torch.float32, device=grid.device)
    out = torch.empty(2, dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function("resize_ce_fwd_launch", 11)(
            grid.data_ptr(), labels.data_ptr(), weights.data_ptr(),
            *(t.data_ptr() for t in tables[:6]), partial.data_ptr(),
            out.data_ptr(), b, c, gh, gw, h, w, stream)
    _check(err, "resize_ce_fwd")
    resize_ce_fwd.launches += 1
    return out[0], out[1]


def resize_ce_bwd(grid, labels, weights, out_hw):
    """Launch the backward kernels: -> the unnormalized grid gradient
    (B, C, gh, gw), sum over pixels of R^T ((softmax - onehot) * w) C^T."""
    b, c, gh, gw = grid.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    tables = _tables(gh, gw, h, w, grid.device)
    scratch = torch.empty((b, c, h, gw), dtype=torch.float32,
                          device=grid.device)
    grad = torch.empty_like(grid)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function("resize_ce_bwd_launch", 13)(
            grid.data_ptr(), labels.data_ptr(), weights.data_ptr(),
            *(t.data_ptr() for t in tables), scratch.data_ptr(),
            grad.data_ptr(), b, c, gh, gw, h, w, stream)
    _check(err, "resize_ce_bwd")
    resize_ce_bwd.launches += 1
    return grad


resize_ce_fwd.launches = 0
resize_ce_bwd.launches = 0


class _ResizeCE(torch.autograd.Function):
    """The kernels as an autograd node: the backward recomputes the softmax
    from the grid logits instead of saving anything at full resolution,
    and scales the unnormalized gradient by g / total, as the JAX
    custom_vjp's ``_bwd`` does."""

    @staticmethod
    def forward(ctx, grid, labels, weights, out_hw):
        loss, total = resize_ce_fwd(grid, labels, weights, out_hw)
        ctx.save_for_backward(grid, labels, weights, total)
        ctx.out_hw = out_hw
        return loss

    @staticmethod
    def backward(ctx, g):
        grid, labels, weights, total = ctx.saved_tensors
        grad = resize_ce_bwd(grid, labels, weights, ctx.out_hw)
        return grad * (g / total), None, None, None


def fused_resize_ce(grid: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, out_hw) -> torch.Tensor:
    """Masked mean CE of the upsampled grid logits, without the
    full-resolution intermediate; differentiable in ``grid``.

    Args:
        grid: (B, C, gh, gw) float32 logits at the feature grid,
            class-major.
        labels: (B, H, W) int32 reduced ids in [0, C).
        weights: (B, H, W) float32 validity weights in {0, 1}.
        out_hw: (H, W) output size.

    Returns:
        0-dim float32 loss on grid's device.
    """
    h, w = int(out_hw[0]), int(out_hw[1])
    if grid.dim() != 4:
        raise ValueError("grid must be (B, C, gh, gw); got shape %s"
                         % (tuple(grid.shape),))
    b, c, gh, gw = grid.shape
    for name, t in (("labels", labels), ("weights", weights)):
        if tuple(t.shape) != (b, h, w):
            raise ValueError("%s must be (B, H, W) = %s; got %s"
                             % (name, (b, h, w), tuple(t.shape)))
        if t.device != grid.device:
            raise ValueError("%s on %s, grid on %s"
                             % (name, t.device, grid.device))
    if grid.device.type == "cpu":
        return resize_ce_plain(grid, labels, weights, (h, w))
    if grid.device.type != "cuda":
        raise ValueError("fused_resize_ce runs on cpu or cuda tensors, "
                         "not %s" % grid.device)
    if grid.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("grid and weights must be float32, got %s and %s"
                        % (grid.dtype, weights.dtype))
    if labels.dtype != torch.int32:
        raise TypeError("labels must be int32, got %s" % labels.dtype)
    if not (grid.is_contiguous() and labels.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("grid, labels and weights must be contiguous")
    if min(b, c, gh, gw, h, w) < 1:
        raise ValueError("empty resize-CE: grid %s -> %dx%d"
                         % (tuple(grid.shape), h, w))
    if 4 * (2 * c * gw + c * w) > _SMEM_LIMIT:
        raise ValueError("resize-CE row of %d classes x %d pixels does not "
                         "fit a block's shared memory" % (c, w))
    return _ResizeCE.apply(grid, labels, weights, (h, w))
