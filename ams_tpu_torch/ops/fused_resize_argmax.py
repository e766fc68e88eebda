"""Fused align-corners bilinear upsample + per-pixel argmax.

Counterpart of ``ams_tpu/ops/fused_resize_argmax.py``.  The client's label
path ends by upsampling the logits grid (B, C, gh, gw) to the frame size
(H, W) and taking the class argmax.  Done in plain tensor ops the
full-resolution logits hit device memory: B x C x H x W float32 values
written and read again (319 MB at the client's 8x19x512x1024); the
kernel in ``csrc/resize_argmax.cu`` reads the grid once and writes only
the B x H x W int32 ids (1.3 MB and 16.8 MB at that shape).  It reads
the grid as the forward leaves it (float32 or bfloat16, any strides) and
applies the class subset itself, so no cast, gather or copy runs before
it.

``fused_resize_argmax`` is the wrapper: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, and nothing falls back from one to
the other; ``ops.build.launch`` starts the kernel and counts it as
``resize_argmax``.  ``resize_argmax_plan`` cuts a shape into the kernel's
blocks.
``resize_argmax_plain`` is the plain version, the CPU path and the
kernel's oracle on the card.
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

SOURCE = "ams_tpu_torch/csrc/resize_argmax.cu"
REPLACES = "ams_tpu/ops/fused_resize_argmax.py:40 (_kernel)"
MAX_THREADS = 128
MAX_BAND_ROWS = 32       # the kernel's kMaxRows


def _class_ids(class_index):
    """A class index as a tuple of ints (None stays None); a tensor on the
    card is read back to the host."""
    if class_index is None or isinstance(class_index, tuple):
        return class_index
    if isinstance(class_index, (torch.Tensor, np.ndarray)):
        return tuple(class_index.tolist())
    return tuple(int(k) for k in class_index)


def _check_ids(ids, c: int):
    if not ids or not all(0 <= k < c for k in ids):
        raise ValueError("class_index %s must be ids in [0, %d), at least "
                         "one" % (ids, c))


def resize_argmax_plain(grid: torch.Tensor, out_hw,
                        class_index=None) -> torch.Tensor:
    """argmax_k(resize_bilinear_ac(grid[:, class_index])): (B, C, gh, gw)
    -> (B, H, W) int32, ids into the class index (into C without one).
    ``torch.argmax`` returns the first maximal index, so ties keep the
    lowest id, as the kernel's strict ``>`` does."""
    grid = grid.float()
    ids = _class_ids(class_index)
    if ids is not None:
        grid = grid.index_select(
            1, torch.as_tensor(ids, dtype=torch.long, device=grid.device))
    full = resize_nchw(grid, out_hw)
    return torch.argmax(full, dim=1).to(torch.int32)


class Plan(NamedTuple):
    """How the kernel cuts one (gh, gw) -> (h, w) shape into blocks: one
    block per (column tile, band run, image), one thread per column.

    bands: (n, 4) int32 rows (top grid row, bottom grid row, first output
    row, end row) of the band runs: the output rows whose ``ylo`` is one
    grid row (``lerp_bands``, the rule K2's plan uses), non-empty ones
    only, cut into runs of at most ``MAX_BAND_ROWS`` rows.  Tile t holds
    the columns [t threads, min((t + 1) threads, w))."""

    threads: int
    n_tiles: int
    bands: np.ndarray

    def blocks(self, b: int) -> int:
        return b * len(self.bands) * self.n_tiles


@functools.lru_cache(maxsize=None)
def resize_argmax_plan(gh: int, gw: int, h: int, w: int) -> Plan:
    """The kernel's blocks for one shape (see ``Plan``); ``gw`` only
    checks the shape."""
    if min(gh, gw, h, w) < 1:
        raise ValueError("empty resize-argmax: %dx%d -> %dx%d"
                         % (gh, gw, h, w))
    threads = min(MAX_THREADS, max(32, 1 << (w - 1).bit_length()))
    runs = []
    for gy, (ys, ye) in enumerate(lerp_bands(gh, h)):
        for start in range(ys, ye, MAX_BAND_ROWS):
            runs.append((gy, min(gy + 1, gh - 1), start,
                         min(start + MAX_BAND_ROWS, ye)))
    return Plan(threads, -(-w // threads),
                np.asarray(runs, dtype=np.int32).reshape(-1, 4))


@functools.lru_cache(maxsize=None)
def _tables(gh: int, gw: int, h: int, w: int, device_index: int):
    """The plan and its device tables, one upload per (shape, device):
    (plan, itab, ftab), itab = the band runs, xlo, xhi (int32) and ftab =
    yw, xw (float32), as the launcher reads them.  Made outside inference
    mode, so later calls under autograd may use them."""
    plan = resize_argmax_plan(gh, gw, h, w)
    _, _, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    itab = np.concatenate([plan.bands.ravel(), xlo, xhi]).astype(np.int32)
    ftab = np.concatenate([yw, xw]).astype(np.float32)
    dev = torch.device("cuda", device_index)
    with torch.inference_mode(False):
        return (plan, torch.from_numpy(itab).to(dev),
                torch.from_numpy(ftab).to(dev))


@functools.lru_cache(maxsize=None)
def _class_table(ids, c: int, device_index: int):
    """The class index as an int32 device table, checked against C."""
    _check_ids(ids, c)
    with torch.inference_mode(False):
        return torch.tensor(ids, dtype=torch.int32,
                            device=torch.device("cuda", device_index))


def fused_resize_argmax(grid: torch.Tensor, out_hw,
                        class_index=None) -> torch.Tensor:
    """argmax_k(resize_bilinear_ac(grid[:, class_index], out_hw)) without
    the full-resolution intermediate.

    Args:
        grid: (B, C, gh, gw) float32 or bfloat16 logits at the feature
            grid, any strides (NCHW or channels-last).
        out_hw: (H, W) output size.
        class_index: the classes to take the argmax over, a sequence of
            ids in [0, C) or a 1-D integer tensor; None for all C.

    Returns:
        (B, H, W) int32 ids into ``class_index`` (into C without one), on
        grid's device.
    """
    if grid.dim() != 4:
        raise ValueError("grid must be (B, C, gh, gw); got shape %s"
                         % (tuple(grid.shape),))
    h, w = int(out_hw[0]), int(out_hw[1])
    b, c, gh, gw = grid.shape
    ids = _class_ids(class_index)
    if grid.device.type == "cpu":
        if ids is not None:
            _check_ids(ids, c)
        return resize_argmax_plain(grid, (h, w), ids)
    if grid.device.type != "cuda":
        raise ValueError("fused_resize_argmax runs on cpu or cuda tensors, "
                         "not %s" % grid.device)
    if grid.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("grid must be float32 or bfloat16, got %s"
                        % grid.dtype)
    if min(b, c, gh, gw, h, w) < 1:
        raise ValueError("empty resize-argmax: grid %s -> %dx%d"
                         % (tuple(grid.shape), h, w))
    sb, sc, sy, sx = grid.stride()
    if (c - 1) * sc + (gh - 1) * sy + (gw - 1) * sx >= 2 ** 31:
        raise ValueError("one image of the grid spans 2^31 elements or more")
    index = grid.device.index
    plan, itab, ftab = _tables(gh, gw, h, w, index)
    if ids is None:
        cls_ptr, n_sel = None, c
    else:
        cls_ptr, n_sel = _class_table(ids, c, index).data_ptr(), len(ids)
    out = torch.empty((b, h, w), dtype=torch.int32, device=grid.device)
    build.launch(
        "resize_argmax", "resize_argmax", index,
        (grid.data_ptr(), int(grid.dtype == torch.bfloat16), sb, sc, sy, sx,
         cls_ptr, n_sel, itab.data_ptr(), ftab.data_ptr(), out.data_ptr(), b,
         h, w, len(plan.bands), plan.n_tiles, plan.threads),
        lambda: "grid %s %s -> %dx%d" % (tuple(grid.shape), grid.dtype, h, w))
    return out
