"""Fused align-corners bilinear upsample + masked softmax cross-entropy.

Counterpart of ``ams_tpu/ops/fused_resize_ce.py``.  The distillation loss
is the CE between the student's upsampled logits and the teacher's labels
at full resolution.  In plain tensor ops the full-resolution logits and
their cotangent hit device memory (10x19x256x512 f32 = 100 MB each per
training iteration); the kernel in ``csrc/resize_ce.cu`` reads only the
grid logits, labels and weights, and writes the scalar loss and, in the
same launch, the grid-logit gradient.

``fused_resize_ce`` is the wrapper.  A CPU tensor goes to the plain
version, whose gradient autograd supplies.  A CUDA tensor launches the
kernel, and nothing falls back from one to the other: under grad, with a
grid that needs a gradient, the forward computes the loss and the
gradient in one launch (``resize_ce_loss_grad``) and the backward only
scales it, as JAX's ``_fwd``/``_bwd`` do; otherwise the loss-only variant
runs (``resize_ce_loss``).  Under ``torch.func.vmap`` (the batched
multi-video round, ``parallel.sharded.make_vmapped_multi_video_round``) the
node's vmap rule launches the kernel once for all V videos, their V x B
images in V groups, each with its own masked mean and weight total;
anything else that reaches the kernel under ``vmap`` raises, as a batched
tensor has no data pointer.  ``resize_ce_plan`` cuts a shape into the
kernel's blocks, and ``class_plan`` picks the largest cut whose band
block fits the card's shared memory at a class count: any C up to 829
runs on an H100.
``resize_ce_plain`` is the plain version, the CPU path and the kernel's
oracle on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ams_tpu_torch.models.resize import (
    _lerp_weights,
    lerp_bands,
    resize_nchw,
)
from ams_tpu_torch.ops import build

SOURCE = "ams_tpu_torch/csrc/resize_ce.cu"
REPLACES = ("ams_tpu/ops/fused_resize_ce.py:37 (_make_kernel; custom_vjp "
            "fused_resize_ce :161, _fwd :175, _bwd :184)")
_MAX_THREADS = 128
_MAX_TILE_INTERVALS = 64
# (threads, grid intervals per tile) that class_plan tries in turn: each
# step needs less shared memory per band block than the one before (the
# 2C rows of threads + 1 column sums shrink with the threads, the 2C
# partial columns with the intervals)
PLAN_STEPS = ((128, 64), (64, 64), (32, 64), (32, 32), (32, 16), (32, 8),
              (32, 4), (32, 2), (32, 1))


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


class Plan(NamedTuple):
    """How the kernel cuts one (gh, gw) -> (h, w) shape into blocks: one
    block per (image, band, tile), one thread per column of a tile.

    bands: (gh, 2) [start, end) of the output rows whose ``ylo`` is gy (the
    band of grid row gy; empty when h < gh).  tiles: (n_tiles, 5) rows
    (g0, g1, xs, xe, poff): the tile's grid intervals [g0, g1), its columns
    [xs, xe) (the x whose ``xlo`` lies in [g0, g1)), and the first column
    of its gradient partial.  A tile touches grid columns g0 .. min(g1,
    gw - 1), ``ncol`` of them; column g1 is shared with the next tile.
    tile_of: (gw,) the tile whose intervals hold each grid column.  xr:
    (gw, 4) [start, end) of the x whose ``xlo`` is gx, then of those whose
    ``xhi`` is gx.  sumcol: the partial columns of one (band, side, class),
    the sum of the tiles' ``ncol``."""

    threads: int
    bands: np.ndarray
    tiles: np.ndarray
    tile_of: np.ndarray
    xr: np.ndarray
    ncol_max: int
    sumcol: int

    def blocks(self, b: int) -> int:
        return b * len(self.bands) * len(self.tiles)

@functools.lru_cache(maxsize=None)
def resize_ce_plan(gh: int, gw: int, h: int, w: int,
                   threads: int = _MAX_THREADS,
                   max_intervals: int = _MAX_TILE_INTERVALS) -> Plan:
    """The kernel's blocks and tables for one shape (see ``Plan``), with at
    most ``threads`` threads per block (a power of two, 32 to 128).  Tiles
    pack whole grid intervals greedily up to ``threads`` columns and
    ``max_intervals`` intervals; an interval wider than the block makes a
    tile of its own, which the block walks in chunks."""
    xlo, xhi, _ = _lerp_weights(gw, w)
    threads = min(threads, max(32, 1 << (w - 1).bit_length()))
    counts = np.bincount(xlo, minlength=gw)
    starts, width = [0], 0
    for g in range(gw):
        if g > starts[-1] and (width + counts[g] > threads
                               or g - starts[-1] == max_intervals):
            starts.append(g)
            width = 0
        width += counts[g]
    g0 = np.array(starts)
    g1 = np.append(g0[1:], gw)
    ncol = np.minimum(g1, gw - 1) - g0 + 1
    poff = np.concatenate([[0], np.cumsum(ncol)[:-1]])
    tiles = np.stack([g0, g1, np.searchsorted(xlo, g0, "left"),
                      np.searchsorted(xlo, g1, "left"), poff], axis=1)
    gx = np.arange(gw)
    bands = lerp_bands(gh, h)
    xr = np.stack([np.searchsorted(xlo, gx, "left"),
                   np.searchsorted(xlo, gx, "right"),
                   np.searchsorted(xhi, gx, "left"),
                   np.searchsorted(xhi, gx, "right")], axis=1)
    tile_of = np.searchsorted(g0, gx, "right") - 1
    i32 = functools.partial(np.ascontiguousarray, dtype=np.int32)
    return Plan(threads, i32(bands), i32(tiles), i32(tile_of), i32(xr),
                int(ncol.max()), int(ncol.sum()))


def class_plan(c: int, gh: int, gw: int, h: int, w: int, smem_bytes,
               smem_limit: int) -> Plan:
    """The plan of the first step of ``PLAN_STEPS`` whose band block, with
    the gradient, needs at most ``smem_limit`` bytes of shared memory at
    ``c`` classes, counted by ``smem_bytes(c, threads, ncol_max, 1)``: the
    kernel's own ``resize_ce_smem_bytes`` on the card.  While the first
    step fits, the plan is ``resize_ce_plan``'s default.  Raises
    ``ValueError`` past the last step: above 829 classes on an H100, at
    any shape (64 + 70 C floats at 32 threads, one interval per tile)."""
    for threads, intervals in PLAN_STEPS:
        plan = resize_ce_plan(gh, gw, h, w, threads, intervals)
        need = smem_bytes(c, plan.threads, plan.ncol_max, 1)
        if need <= smem_limit:
            return plan
    raise ValueError(
        "resize_ce: %d classes need %d B of shared memory per band block "
        "at %d threads and one grid interval per tile (grid %dx%d -> %dx%d),"
        " more than the %d B a block may use" % (c, need, plan.threads, gh,
                                                 gw, h, w, smem_limit))


@functools.lru_cache(maxsize=None)
def card_plan(c: int, gh: int, gw: int, h: int, w: int,
              device_index: int) -> Plan:
    """``class_plan`` on CUDA device ``device_index``, by the built
    kernel's shared-memory count and the device's limit: the plan the
    launches use."""
    lib = build.load("resize_ce")
    limit = lib.resize_ce_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError("resize_ce: cannot read the shared memory limit "
                           "of CUDA device %d" % device_index)
    return class_plan(c, gh, gw, h, w, lib.resize_ce_smem_bytes, limit)


@functools.lru_cache(maxsize=None)
def _tables(c: int, gh: int, gw: int, h: int, w: int, device: torch.device):
    """The card's plan at ``c`` classes and device copies of the lerp
    tables and the plan's tables, one upload per shape: (plan, (yw, xlo,
    xhi, xw, bands, tiles, tile_of, xr))."""
    _, _, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    plan = card_plan(c, gh, gw, h, w, device.index)
    host = (yw, xlo, xhi, xw, plan.bands, plan.tiles, plan.tile_of, plan.xr)
    with torch.inference_mode(False):
        return plan, tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) for a in host)


def _launch(grid, labels, weights, out_hw, want_grad, groups=None):
    """One launch, counted as ``resize_ce_loss_grad`` with the gradient
    and ``resize_ce_loss`` without."""
    b, c, gh, gw = grid.shape
    h, w = int(out_hw[0]), int(out_hw[1])
    plan, tables = _tables(c, gh, gw, h, w, grid.device)
    dev = grid.device
    lpart = torch.empty(2 * plan.blocks(b), dtype=torch.float32, device=dev)
    out = torch.empty(2 * (groups or 1), dtype=torch.float32, device=dev)
    part = grad = None
    if want_grad:
        part = torch.empty(b * gh * 2 * c * plan.sumcol, dtype=torch.float32,
                           device=dev)
        grad = torch.empty_like(grid)
    build.launch(
        "resize_ce_loss_grad" if want_grad else "resize_ce_loss",
        "resize_ce", dev.index,
        (grid.data_ptr(), labels.data_ptr(), weights.data_ptr(),
         *(t.data_ptr() for t in tables), lpart.data_ptr(),
         None if part is None else part.data_ptr(),
         None if grad is None else grad.data_ptr(), out.data_ptr(),
         b, c, gh, gw, h, w, len(plan.tiles), plan.ncol_max, plan.sumcol,
         plan.threads, groups or 1),
        lambda: "grid %s -> %dx%d, %d B of shared memory per block"
        % (tuple(grid.shape), h, w, build.load("resize_ce")
           .resize_ce_smem_bytes(c, plan.threads, plan.ncol_max,
                                 int(want_grad))))
    if groups is None:
        return out[0], out[1], grad
    return out[0::2], out[1::2], grad


def resize_ce_loss(grid, labels, weights, out_hw):
    """Launch the loss-only kernel: -> (loss, total) 0-dim f32 tensors,
    total = max(sum(weights), 1)."""
    loss, total, _ = _launch(grid, labels, weights, out_hw, False)
    return loss, total


def resize_ce_loss_grad(grid, labels, weights, out_hw, groups=None):
    """Launch the kernel with the gradient: -> (loss, total, grad), grad
    the unnormalized grid gradient (B, C, gh, gw), the sum over pixels of
    R^T ((softmax - onehot) * w) C^T.  With ``groups`` G, the B images
    are G equal groups (videos): loss and total are then (G,), each
    group's as a launch over that group alone gives it."""
    return _launch(grid, labels, weights, out_hw, True, groups=groups)


class _ResizeCE(torch.autograd.Function):
    """The kernel as an autograd node: -> (loss, total, grad), the last
    two not differentiable.  As the JAX custom_vjp's ``_fwd`` does, the
    forward computes the loss and the unnormalized gradient in one launch
    and keeps the gradient (B, C, gh, gw) and the weight total; the
    backward scales it by g / total and launches nothing.  In the
    ``setup_context`` form, with a vmap rule, so that ``torch.func`` can
    transform it."""

    @staticmethod
    def forward(grid, labels, weights, out_hw):
        return resize_ce_loss_grad(grid, labels, weights, out_hw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, total, grad = output
        ctx.mark_non_differentiable(total, grad)
        ctx.save_for_backward(grad, total)

    @staticmethod
    def backward(ctx, g, _g_total, _g_grad):
        grad, total = ctx.saved_tensors
        return grad * (g / total), None, None, None

    @staticmethod
    def vmap(info, in_dims, grid, labels, weights, out_hw):
        """V videos' (B, ...) inputs as one launch over V x B images in
        V groups: each video's loss and total are its own."""
        v = info.batch_size

        def lead(t, d):
            t = t.expand(v, *t.shape) if d is None else t.movedim(d, 0)
            return t.contiguous()

        grid, labels, weights = (lead(t, d) for t, d in
                                 zip((grid, labels, weights), in_dims))
        loss, total, grad = resize_ce_loss_grad(
            grid.flatten(0, 1), labels.flatten(0, 1), weights.flatten(0, 1),
            out_hw, groups=v)
        return (loss, total, grad.view(grid.shape)), (0, 0, 0)


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
    # decided here: grad mode is off inside Function.forward
    if torch.is_grad_enabled() and grid.requires_grad:
        return _ResizeCE.apply(grid, labels, weights, (h, w))[0]
    return resize_ce_loss(grid, labels, weights, (h, w))[0]
