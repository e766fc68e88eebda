"""Fused inverted-residual (MBConv) block for the bf16 folded client.

Counterpart of ``ams_tpu/ops/fused_mbconv.py`` (K3).  A MobileNetV2 block
is ``1x1 expand -> relu6 -> 3x3 depthwise (rate r) -> relu6 -> 1x1 project
(+ residual)``; run unfused, the 6x-expanded mid tensor is written to
device memory and read back twice per block.  The kernel in
``csrc/mbconv.cu`` computes a whole block per output tile with the mid
tensor in shared memory, so only the block's input and output cross
device memory.

The TPU kernel runs a zero-padded flat layout, re-zeroes the pads after
each block and decides by a VMEM estimate (``stage_fits_vmem``) whether a
stage runs fused at all.  On the card none of that is needed: the kernel
reads the plain NHWC tensor (a ``torch.channels_last`` bf16 tensor of
logical shape ``(B, C, H, W)``), masks out-of-image positions itself, and
``stage_tile`` picks an output tile and a mid-channel chunk that fit
shared memory for every block of the student.  So ``run_fused_stage``
chains the blocks on the plain tensor, and every stride-1 stage runs fused.

The host side of the kernel's design (the header of ``csrc/mbconv.cu``
gives the whole of it):
- ``pack_weights`` lays the weights out as the kernel stages them: per
  mid-channel chunk, the expand and project weights n-major with k
  contiguous (each k padded to 16), and the depthwise weights with both
  biases in f32, each chunk contiguous, so that a chunk lands in shared
  memory by 16-byte ``cp.async`` copies.  ``packed_weights`` keeps them
  beside the weight tensors, built once per parameter version;
- ``stage_tile`` chooses the tile and the chunk by cost: the window
  positions a tile stages and expands plus the pixels it projects (the
  ragged edge included), over the blocks resident per SM, among tiles
  whose accumulators fit ``ACC_BUDGET`` registers per thread.  The
  compiled kernel gives the residency (``KernelOccupancy``: its warp
  tilings, their registers, and CUDA's occupancy calculator);
- ``warp_tiles`` gives the (16-pixel x 8-channel) project tiles each warp
  keeps in registers, from the tilings the kernel compiles.

Storage points, the same in the kernel, in ``mbconv_plain`` and in both TPU
kernels: bf16 input; expand with f32 accumulation, + bias, relu6, bf16;
depthwise in f32 with f32 weights, + bias, relu6, bf16; project with f32
accumulation, + bias (+ the bf16 input), bf16 out.  The kernel and the
plain version differ only in the order of the 1x1 sums.

``mbconv_block`` is the stride-1 wrapper, its launches counted as
``mbconv``; ``ops.fused_mbconv_banded.mbconv_banded`` is K4's wrapper over
the same kernel, counted as ``mbconv_banded``.  A CPU tensor goes to
``mbconv_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ams_tpu_torch.models.layers import _same_pad
from ams_tpu_torch.ops import build

SOURCE = "ams_tpu_torch/csrc/mbconv.cu"
REPLACES = ("ams_tpu/ops/fused_mbconv.py:60 (_mbconv_kernel; pallas_call "
            ":150, mbconv_flat :115, run_fused_stage :237)")
# Shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the kernel's block: no plan within ACC_BUDGET needs more threads
THREADS = 256
# f32 project accumulators a thread may hold
ACC_BUDGET = 128
_TILE_WIDTHS = (8, 13, 16, 32)     # 13 divides the 65-wide grids
_CHUNKS = (64, 48, 32, 16)         # mid channels per pass; 8 where 16
                                   # does not divide them


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def out_geometry(h: int, w: int, stride: int, rate: int):
    """TF-'SAME' 3x3 depthwise at (stride, rate) -> (ho, wo, pad_top,
    pad_left); the extra pad of an even stride-2 input goes bottom/right."""
    top, _ = _same_pad(h, 3, stride, rate)
    left, _ = _same_pad(w, 3, stride, rate)
    return -(-h // stride), -(-w // stride), top, left


def _window(tile_h: int, tile_w: int, stride: int, rate: int) -> int:
    return ((tile_h - 1) * stride + 2 * rate + 1) * \
        ((tile_w - 1) * stride + 2 * rate + 1)


def smem_bytes(cin: int, cout: int, stride: int, rate: int,
               has_expand: bool, tile_h: int, tile_w: int,
               chunk: int) -> int:
    """Dynamic shared memory of one kernel block; the same sum as
    ``make_plan`` in csrc/mbconv.cu (each region rounded to 16 bytes; the
    chunk's weights twice, for the copy in flight; bf16 rows of the 1x1
    depths rounded to 16, plus 8)."""
    cin_p, chunk_p = _round_up(cin, 16), _round_up(chunk, 16)
    halo_p = _round_up(_window(tile_h, tile_w, stride, rate), 16)
    pix = tile_h * tile_w
    regions = [halo_p * (cin_p + 8) * 2,                    # input window
               halo_p,                                      # in-image flags
               pix * 4]                                     # pixel offsets
    if has_expand:
        regions += [chunk * (cin_p + 8) * 2] * 2            # expand weights
        regions += [halo_p * (chunk_p + 8) * 2]             # mid tile
    regions += [pix * (chunk_p + 8) * 2]                    # depthwise out
    regions += [cout * (chunk_p + 8) * 2] * 2               # project weights
    regions += [11 * chunk * 4] * 2                         # dw weights, biases
    return sum(_round_up(r, 16) for r in regions)


def warp_tiles(pix: int, cout: int, tilings):
    """(MT, NT) of ``tilings`` (the kernel's) whose warps cover the
    (pix/16) x (cout/8) project tiles of a block: the fewest tiles per
    warp, then the fewest fragment bytes per mma; None if none covers
    them."""
    pm, pn = pix // 16, cout // 8
    fits = [(mt * nt, (2 * mt + nt) / (mt * nt), mt, nt)
            for mt, nt in tilings
            if -(-pm // mt) * -(-pn // nt) <= THREADS // 32]
    return min(fits)[2:] if fits else None


def acc_registers(tile_h: int, tile_w: int, cout: int,
                  tilings) -> Optional[int]:
    """f32 project accumulators one thread holds for this tile."""
    wt = warp_tiles(tile_h * tile_w, cout, tilings)
    return None if wt is None else 4 * wt[0] * wt[1]


class KernelOccupancy:
    """The built kernel as the planner sees it: ``tilings``, its warp
    tilings (MT, NT); ``registers``, each one's registers and spilled
    bytes per thread; ``resident(mt, nt, smem)``, the blocks of a tiling
    resident per SM at that much shared memory, by CUDA's occupancy
    calculator.  ``stage_tile`` takes any object with ``tilings`` and
    ``resident``."""

    def __init__(self, lib):
        cap = 16
        mt, nt, regs, spill = [(ctypes.c_int * cap)() for _ in range(4)]
        n = lib.mbconv_tilings(mt, nt, regs, spill, cap)
        if n < 0:
            raise RuntimeError("mbconv_tilings failed: CUDA error %d" % -n)
        self._lib = lib
        self.registers = {(mt[i], nt[i]): (regs[i], spill[i])
                          for i in range(n)}
        self.tilings = tuple(self.registers)

    def resident(self, mt: int, nt: int, smem: int) -> int:
        got = self._lib.mbconv_resident(mt, nt, smem)
        if got < 0:
            raise RuntimeError("mbconv_resident(%d, %d, %d) failed: CUDA "
                               "error %d" % (mt, nt, smem, -got))
        return got


@functools.lru_cache(maxsize=None)
def kernel_occupancy() -> KernelOccupancy:
    """``KernelOccupancy`` of the built kernel (builds it on first use)."""
    return KernelOccupancy(build.load("mbconv"))


def plan_cost(cin, cout, stride, rate, has_expand, tile_h, tile_w, chunk,
              h=None, w=None, *, occupancy) -> dict:
    """What ``stage_tile`` weighs for one plan: tiles per image, window
    positions staged (and expanded, where the block expands) and pixels
    projected per output pixel, blocks resident per SM (``occupancy``, at
    the plan's tiling and shared memory), and the cost.  Without the grid
    (h, w) the ragged edge is left out."""
    if h is None:
        tiles, out_px = 1.0, tile_h * tile_w
    else:
        ho, wo, _, _ = out_geometry(h, w, stride, rate)
        tiles, out_px = -(-ho // tile_h) * -(-wo // tile_w), ho * wo
    nbytes = smem_bytes(cin, cout, stride, rate, has_expand, tile_h, tile_w,
                        chunk)
    wt = warp_tiles(tile_h * tile_w, cout, occupancy.tilings)
    acc = None if wt is None else 4 * wt[0] * wt[1]
    resident = (0 if wt is None or nbytes > SMEM_LIMIT
                else occupancy.resident(wt[0], wt[1], nbytes))
    window = tiles * _window(tile_h, tile_w, stride, rate) / out_px
    projected = tiles * tile_h * tile_w / out_px
    # a second resident block runs while the first waits at a barrier; a
    # third adds little
    return {"tiles": tiles, "window_per_px": window,
            "projected_per_px": projected, "resident": resident,
            "smem": nbytes, "warp_tiles": wt, "acc_registers": acc,
            "cost": ((window + projected) / min(resident, 2) if resident
                     else float("inf"))}


@functools.lru_cache(maxsize=None)
def stage_tile(cin: int, cmid: int, cout: int, stride: int, rate: int,
               has_expand: bool, h: Optional[int] = None,
               w: Optional[int] = None, *, occupancy):
    """(tile_h, tile_w, chunk) for one block on an (h, w) input grid: the
    plan of least ``plan_cost`` among the tiles of width 8, 13, 16 or 32
    with a multiple of 16 pixels (at most 256), the chunks of 16 to 64 mid
    channels that divide ``cmid`` (8, where 16 does not), whose shared
    memory fits ``SMEM_LIMIT`` and whose project accumulators fit
    ``ACC_BUDGET`` on one of ``occupancy``'s tilings; ties go to the
    larger chunk (fewer passes).  Replaces the TPU's ``stage_fits_vmem``:
    a 16-pixel tile with a 16-channel chunk fits every block of the
    student, so a block never runs unfused for want of memory."""
    chunks = _CHUNKS if cmid % 16 == 0 else (8,)
    best = None
    for tile_w in _TILE_WIDTHS:
        for tile_h in range(1, 257 // tile_w + 1):
            if (tile_h * tile_w) % 16:
                continue
            acc = acc_registers(tile_h, tile_w, cout, occupancy.tilings)
            if acc is None or acc > ACC_BUDGET:
                continue
            for chunk in chunks:
                if cmid % chunk or smem_bytes(
                        cin, cout, stride, rate, has_expand, tile_h, tile_w,
                        chunk) > SMEM_LIMIT:
                    continue
                cost = plan_cost(cin, cout, stride, rate, has_expand, tile_h,
                                 tile_w, chunk, h, w,
                                 occupancy=occupancy)["cost"]
                key = (cost, -chunk, -tile_h * tile_w)
                if best is None or key < best[0]:
                    best = (key, (tile_h, tile_w, chunk))
    if best is None:
        raise ValueError("no MBConv tile fits %d bytes of shared memory and "
                         "%d accumulators for cin %d, cmid %d, cout %d"
                         % (SMEM_LIMIT, ACC_BUDGET, cin, cmid, cout))
    return best[1]


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def mbconv_plain(x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj, *,
                 stride=1, rate=1, residual=False):
    """The fused block in plain PyTorch: f32 arithmetic, rounded to bf16 at
    the kernel's storage points, the depthwise taps summed in the
    kernel's order (row-major over the 3x3 window).

    x: (B, Cin, H, W), any float type (taken as bf16); w_expand (Cin, Cmid)
    or None (a block without expand: Cmid == Cin); w_dw (9, Cmid);
    w_proj (Cmid, Cout); biases of C values, any shape.  Returns
    (B, Cout, Ho, Wo) bf16 in channels-last memory.
    """
    bf16, f32 = torch.bfloat16, torch.float32
    xh = x.to(bf16).permute(0, 2, 3, 1).to(f32)            # (B, H, W, Cin)
    b, h, w, _ = xh.shape
    if w_expand is not None:
        mid = xh @ w_expand.to(bf16).to(f32) + b_expand.reshape(-1).to(f32)
        mid = _relu6(mid).to(bf16).to(f32)
    else:
        mid = xh
    ho, wo = -(-h // stride), -(-w // stride)
    mid = torch.nn.functional.pad(mid, (0, 0) + _same_pad(w, 3, stride, rate)
                                  + _same_pad(h, 3, stride, rate))
    wd = w_dw.to(f32)
    acc = None
    for ky in range(3):
        for kx in range(3):
            y0, x0 = ky * rate, kx * rate
            tap = mid[:, y0:y0 + (ho - 1) * stride + 1:stride,
                      x0:x0 + (wo - 1) * stride + 1:stride, :]
            term = tap * wd[ky * 3 + kx]
            acc = term if acc is None else acc + term
    y = _relu6(acc + b_dw.reshape(-1).to(f32)).to(bf16).to(f32)
    out = y @ w_proj.to(bf16).to(f32) + b_proj.reshape(-1).to(f32)
    if residual:
        out = out + xh
    return out.to(bf16).permute(0, 3, 1, 2)


def pack_weights(w_expand, b_expand, w_dw, b_dw, w_proj, chunk: int,
                 device):
    """The weights in the kernel's layout for one chunk size, on
    ``device``, each chunk contiguous: ``we`` (Cmid, Cin rounded up to 16)
    bf16, the expand weights n-major with the k padding zero (None without
    expand); ``wp`` (Cmid/chunk, Cout, chunk rounded up to 16) bf16, the
    project weights n-major with the k padding zero; ``f`` (Cmid/chunk, 11,
    chunk) f32, the nine depthwise taps, the depthwise bias and the expand
    bias (zero without expand)."""
    bf16, f32 = torch.bfloat16, torch.float32
    cmid, cout = w_dw.shape[1], w_proj.shape[1]
    n = cmid // chunk
    dev = device
    we = None
    if w_expand is not None:
        cin = w_expand.shape[0]
        we = torch.zeros((cmid, _round_up(cin, 16)), dtype=bf16, device=dev)
        we[:, :cin] = w_expand.to(dev, bf16).t()
    wp = torch.zeros((n, cout, _round_up(chunk, 16)), dtype=bf16, device=dev)
    wp[:, :, :chunk] = w_proj.to(dev, bf16).reshape(n, chunk, cout) \
        .transpose(1, 2)
    b_exp = (b_expand.reshape(-1).to(dev, f32) if w_expand is not None
             else torch.zeros(cmid, dtype=f32, device=dev))
    f = torch.cat([w_dw.to(dev, f32).reshape(9, n, chunk).transpose(0, 1),
                   b_dw.reshape(1, n, chunk).to(dev, f32).transpose(0, 1),
                   b_exp.reshape(1, n, chunk).transpose(0, 1)],
                  dim=1).contiguous()
    return we, wp, f


def _version(t: torch.Tensor) -> Optional[int]:
    # inference tensors carry no version counter: such a block is rebuilt
    return None if t.is_inference() else t._version


_PACKED = WeakIdKeyDictionary()


def packed_weights(w_expand, b_expand, w_dw, b_dw, w_proj, chunk: int,
                   device):
    """``pack_weights`` of these tensors, kept beside ``w_proj`` while it
    lives and reused while all five are the same objects at the same
    versions: a new parameter dict, a new fold (``fused_block`` makes new
    tensors) or an in-place update packs them again.  Tensors made under
    inference mode carry no version and are packed at every call."""
    others = (w_expand, b_expand, w_dw, b_dw)
    versions = tuple(_version(t) for t in others + (w_proj,)
                     if t is not None)
    hit = _PACKED.get(w_proj)
    if (hit is None or None in versions or hit[1] != versions
            or any(a is not b for a, b in zip(hit[0], others))):
        hit = (others, versions, {})
        if None not in versions:
            _PACKED[w_proj] = hit
    key = (chunk, torch.device(device))
    bufs = hit[2].get(key)
    if bufs is None:
        with torch.inference_mode(False):
            bufs = pack_weights(*others, w_proj, chunk, device)
        hit[2][key] = bufs
    return bufs


class FusedBlock:
    """Folded weights of one block: w_expand (Cin, Cmid) bf16 or None,
    w_dw (9, Cmid) f32, w_proj (Cmid, Cout) bf16, biases (1, C) f32 (the
    JAX ``FusedBlock``'s shapes)."""

    def __init__(self, folded: Dict, name: str, has_expand: bool,
                 rate: int, residual: bool):
        g = lambda k: folded[name + k]  # noqa: E731
        bf16, f32 = torch.bfloat16, torch.float32
        if has_expand:
            self.w_expand = g("/expand/weights")[0, 0].to(bf16).contiguous()
            self.b_expand = g("/expand/folded_bias")[None, :].to(f32)
        else:
            self.w_expand = None
            self.b_expand = None
        wd = g("/depthwise/depthwise_weights")                 # (3,3,C,1)
        self.w_dw = wd[:, :, :, 0].reshape(9, -1).to(f32).contiguous()
        self.b_dw = g("/depthwise/folded_bias")[None, :].to(f32)
        self.w_proj = g("/project/weights")[0, 0].to(bf16).contiguous()
        self.b_proj = g("/project/folded_bias")[None, :].to(f32)
        self.rate = rate
        self.residual = residual
        self.has_expand = has_expand


_SOURCES = ("/expand/weights", "/expand/folded_bias",
            "/depthwise/depthwise_weights", "/depthwise/folded_bias",
            "/project/weights", "/project/folded_bias")
_BLOCK_CACHE: Dict[tuple, tuple] = {}


def fused_block(folded: Dict, name: str, has_expand: bool, rate: int,
                residual: bool) -> FusedBlock:
    """``FusedBlock`` of ``folded[name + ...]``, reused while the folded
    tensors are the same objects at the same version: a new parameter
    dict (``apply_downlink``, a new fold) or an in-place update rebuilds
    it, and so packs its weights again (``packed_weights``)."""
    srcs = tuple(folded[name + k] for k in _SOURCES
                 if has_expand or not k.startswith("/expand"))
    versions = tuple(_version(t) for t in srcs)
    key = (name, has_expand, rate, residual)
    hit = _BLOCK_CACHE.get(key)
    if (hit is not None and None not in versions and hit[1] == versions
            and all(a is b for a, b in zip(hit[0], srcs))):
        return hit[2]
    with torch.inference_mode(False):
        blk = FusedBlock(folded, name, has_expand, rate, residual)
    _BLOCK_CACHE[key] = (srcs, versions, blk)
    return blk


def launch(name, x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj, *,
           stride, rate, residual):
    """One kernel launch on CUDA tensors, after every check the kernel
    relies on; raises on anything it cannot take.  The weights go in
    packed (``packed_weights``).  Returns the output; the launch is
    counted under ``name``, the calling wrapper's."""
    if x.dim() != 4:
        raise ValueError("x must be (B, C, H, W); got %s" % (tuple(x.shape),))
    if x.dtype != torch.bfloat16:
        raise TypeError("the MBConv kernel takes bfloat16, got %s" % x.dtype)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels-last contiguous (NHWC storage)")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    b, cin, h, w = x.shape
    cmid, cout = w_dw.shape[1], w_proj.shape[1]
    has_expand = w_expand is not None
    if has_expand and tuple(w_expand.shape) != (cin, cmid):
        raise ValueError("w_expand %s for cin %d, cmid %d"
                         % (tuple(w_expand.shape), cin, cmid))
    if not has_expand and cmid != cin:
        raise ValueError("a block without expand has cmid == cin")
    if tuple(w_dw.shape) != (9, cmid) or w_proj.shape[0] != cmid:
        raise ValueError("w_dw %s, w_proj %s for cmid %d"
                         % (tuple(w_dw.shape), tuple(w_proj.shape), cmid))
    if cin % 8 or cmid % 8 or cout % 8:
        raise ValueError("the kernel takes cin, cmid and cout in multiples "
                         "of 8; got %d, %d, %d" % (cin, cmid, cout))
    if stride not in (1, 2) or rate < 1 or (stride == 2 and rate != 1):
        raise ValueError("stride 1 at any rate, or stride 2 at rate 1; got "
                         "stride %d, rate %d" % (stride, rate))
    if residual and (stride != 1 or cin != cout):
        raise ValueError("a residual block has stride 1 and cin == cout")
    dev = x.device
    occupancy = kernel_occupancy()
    tile_h, tile_w, chunk = stage_tile(cin, cmid, cout, stride, rate,
                                       has_expand, h, w, occupancy=occupancy)
    mt, nt = warp_tiles(tile_h * tile_w, cout, occupancy.tilings)
    we, wp, f = packed_weights(w_expand, b_expand, w_dw, b_dw, w_proj, chunk,
                               dev)
    bp = b_proj.reshape(-1).to(dev, torch.float32).contiguous()
    if bp.data_ptr() % 16:
        raise ValueError("b_proj must start on a 16-byte boundary")
    ho, wo, top, left = out_geometry(h, w, stride, rate)
    out = torch.empty((b, ho, wo, cout), dtype=torch.bfloat16,
                      device=dev).permute(0, 3, 1, 2)
    build.launch(
        name, "mbconv", dev.index,
        (x.data_ptr(), 0 if we is None else we.data_ptr(), wp.data_ptr(),
         f.data_ptr(), bp.data_ptr(), out.data_ptr(), b, h, w, cin, cmid,
         cout, ho, wo, stride, rate, top, left, int(residual), tile_h,
         tile_w, chunk, mt, nt),
        lambda: "x %s, stride %d, rate %d, tile %dx%d, chunk %d"
        % (tuple(x.shape), stride, rate, tile_h, tile_w, chunk))
    return out


def mbconv_block(x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj, *,
                 rate=1, residual=False):
    """One fused stride-1 MBConv block (K3): (B, Cin, H, W) bf16 ->
    (B, Cout, H, W) bf16, channels-last.  Weights as ``FusedBlock``."""
    if x.device.type == "cpu":
        return mbconv_plain(x, w_expand, b_expand, w_dw, b_dw, w_proj,
                            b_proj, stride=1, rate=rate, residual=residual)
    if x.device.type != "cuda":
        raise ValueError("mbconv_block runs on cpu or cuda tensors, not %s"
                         % x.device)
    return launch("mbconv", x, w_expand, b_expand, w_dw, b_dw, w_proj,
                  b_proj, stride=1, rate=rate, residual=residual)


def run_fused_stage(x, blocks: List[FusedBlock]):
    """Chain stride-1 blocks through the fused kernel, one launch each;
    no mid tensor reaches device memory."""
    x = x.to(torch.bfloat16, memory_format=torch.channels_last)
    for bl in blocks:
        x = mbconv_block(x, bl.w_expand, bl.b_expand, bl.w_dw, bl.b_dw,
                         bl.w_proj, bl.b_proj, rate=bl.rate,
                         residual=bl.residual)
    return x
