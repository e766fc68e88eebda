"""Fused align-corners bilinear upsample + per-pixel argmax.

Counterpart of ``ams_tpu/ops/fused_resize_argmax.py``.  The client's label
path ends by upsampling the logits grid (33x65x19 at 512x1024 frames) to
the frame size and taking the class argmax.  Done in plain tensor ops the
full-resolution logits hit device memory (8x19x512x1024 f32 = 320 MB per
batch, written and read again); the kernel in
``csrc/resize_argmax.cu`` writes only the int32 ids.

``fused_resize_argmax`` is the wrapper: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, and nothing falls back from one to
the other.  ``resize_argmax_plain`` is the plain version, the CPU path and
the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ams_tpu_torch.models.resize import _lerp_weights, resize_nchw
from ams_tpu_torch.ops import build

SOURCE = "ams_tpu_torch/csrc/resize_argmax.cu"
REPLACES = "ams_tpu/ops/fused_resize_argmax.py:40 (_kernel)"


def resize_argmax_plain(grid: torch.Tensor, out_hw) -> torch.Tensor:
    """argmax_c(resize_bilinear_ac(grid)): (B, C, gh, gw) -> (B, H, W) int32.
    ``torch.argmax`` returns the first maximal index, so ties keep the
    lowest class id, as the kernel's strict ``>`` does."""
    full = resize_nchw(grid.float(), out_hw)
    return torch.argmax(full, dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _tables(in_h: int, in_w: int, out_h: int, out_w: int,
            device: torch.device):
    """Device copies of the host-built lerp tables, one upload per shape."""
    ylo, yhi, yw = _lerp_weights(in_h, out_h)
    xlo, xhi, xw = _lerp_weights(in_w, out_w)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (ylo, yhi, yw, xlo, xhi, xw))


def _library():
    lib = build.load("resize_argmax")
    fn = lib.resize_argmax_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_resize_argmax(grid: torch.Tensor, out_hw) -> torch.Tensor:
    """argmax_c(resize_bilinear_ac(grid, out_hw)) without the
    full-resolution intermediate.

    Args:
        grid: (B, C, gh, gw) float32 logits at the feature grid, class-major.
        out_hw: (H, W) output size.

    Returns:
        (B, H, W) int32 class ids on grid's device.
    """
    if grid.dim() != 4:
        raise ValueError("grid must be (B, C, gh, gw); got shape %s"
                         % (tuple(grid.shape),))
    h, w = int(out_hw[0]), int(out_hw[1])
    if grid.device.type == "cpu":
        return resize_argmax_plain(grid, (h, w))
    if grid.device.type != "cuda":
        raise ValueError("fused_resize_argmax runs on cpu or cuda tensors, "
                         "not %s" % grid.device)
    if grid.dtype != torch.float32:
        raise TypeError("grid must be float32, got %s" % grid.dtype)
    if not grid.is_contiguous():
        raise ValueError("grid must be contiguous (B, C, gh, gw)")
    b, c, gh, gw = grid.shape
    if c < 1 or gh < 1 or gw < 1 or h < 1 or w < 1:
        raise ValueError("empty resize-argmax: grid %s -> %dx%d"
                         % (tuple(grid.shape), h, w))
    tables = _tables(gh, gw, h, w, grid.device)
    out = torch.empty((b, h, w), dtype=torch.int32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(grid.data_ptr(),
                         *(t.data_ptr() for t in tables),
                         out.data_ptr(), b, c, gh, gw, h, w, stream)
    if err != 0:
        raise RuntimeError("resize_argmax kernel launch failed: CUDA error %d"
                           % err)
    fused_resize_argmax.launches += 1
    return out


fused_resize_argmax.launches = 0
