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

Storage points, the same in the kernel, in ``mbconv_plain`` and in both TPU
kernels: bf16 input; expand with f32 accumulation, + bias, relu6, bf16;
depthwise in f32 with f32 weights, + bias, relu6, bf16; project with f32
accumulation, + bias (+ the bf16 input), bf16 out.  The kernel and the
plain version differ only in the order of the 1x1 sums.

``mbconv_block`` is the stride-1 wrapper (its own launch counter);
``ops.fused_mbconv_banded.mbconv_banded`` is K4's wrapper over the same
kernel.  A CPU tensor goes to ``mbconv_plain``; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from ams_tpu_torch.models.layers import _same_pad
from ams_tpu_torch.ops import build

SOURCE = "ams_tpu_torch/csrc/mbconv.cu"
REPLACES = ("ams_tpu/ops/fused_mbconv.py:60 (_mbconv_kernel; pallas_call "
            ":150, mbconv_flat :115, run_fused_stage :237)")
# Shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
_TILES = ((8, 16), (4, 16), (2, 16), (1, 16))   # output rows x columns
_CHUNKS = (64, 48, 32, 16, 8)                   # mid channels per pass


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def out_geometry(h: int, w: int, stride: int, rate: int):
    """TF-'SAME' 3x3 depthwise at (stride, rate) -> (ho, wo, pad_top,
    pad_left); the extra pad of an even stride-2 input goes bottom/right."""
    top, _ = _same_pad(h, 3, stride, rate)
    left, _ = _same_pad(w, 3, stride, rate)
    return -(-h // stride), -(-w // stride), top, left


def smem_bytes(cin: int, cout: int, stride: int, rate: int,
               has_expand: bool, tile_h: int, tile_w: int,
               chunk: int) -> int:
    """Dynamic shared memory of one kernel block; the same sum as
    ``make_plan`` in csrc/mbconv.cu (each region rounded to 16 bytes)."""
    cin_p = _round_up(cin, 16)
    chunk_p = _round_up(chunk, 16)
    halo = ((tile_h - 1) * stride + 2 * rate + 1) * \
        ((tile_w - 1) * stride + 2 * rate + 1)
    halo_p = _round_up(halo, 16)
    pix = tile_h * tile_w
    ld_acc = (cout + 23) // 32 * 32 + 8
    regions = [halo_p * (cin_p + 8) * 2]                    # input tile
    if has_expand:
        regions += [chunk * (cin_p + 8) * 2,                # expand weights
                    halo_p * (chunk + 8) * 2]               # mid tile
    regions += [pix * (chunk_p + 8) * 2,                    # depthwise out
                cout * (chunk_p + 8) * 2,                   # project weights
                pix * ld_acc * 4,                           # f32 accumulator
                11 * chunk * 4]                             # dw weights, biases
    return sum(_round_up(r, 16) for r in regions)


def stage_tile(cin: int, cmid: int, cout: int, stride: int, rate: int,
               has_expand: bool):
    """(tile_h, tile_w, chunk) for one block: the largest output tile,
    then the largest mid-channel chunk (a multiple of 8 dividing ``cmid``),
    whose shared memory fits ``SMEM_LIMIT``.  Replaces the TPU's
    ``stage_fits_vmem``: a 16-pixel tile with an 8-channel chunk fits
    every block of the student, so a block never runs unfused for want of
    memory."""
    chunks = [c for c in _CHUNKS if cmid % c == 0]
    for tile_h, tile_w in _TILES:
        for chunk in chunks:
            if smem_bytes(cin, cout, stride, rate, has_expand, tile_h,
                          tile_w, chunk) <= SMEM_LIMIT:
                return tile_h, tile_w, chunk
    raise ValueError("no MBConv tile fits %d bytes of shared memory for "
                     "cin %d, cmid %d, cout %d" % (SMEM_LIMIT, cin, cmid,
                                                   cout))


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


class FusedBlock:
    """Folded weights of one block in the kernel's layout: w_expand
    (Cin, Cmid) bf16 or None, w_dw (9, Cmid) f32, w_proj (Cmid, Cout)
    bf16, biases (1, C) f32 (the JAX ``FusedBlock``'s shapes)."""

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


def _version(t: torch.Tensor) -> Optional[int]:
    # inference tensors carry no version counter: such a block is rebuilt
    return None if t.is_inference() else t._version


def fused_block(folded: Dict, name: str, has_expand: bool, rate: int,
                residual: bool) -> FusedBlock:
    """``FusedBlock`` of ``folded[name + ...]``, reused while the folded
    tensors are the same objects at the same version: a new parameter
    dict (``apply_downlink``, a new fold) or an in-place update rebuilds
    it."""
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


def _library():
    lib = build.load("mbconv")
    fn = lib.mbconv_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mbconv_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.mbconv_smem_bytes.restype = ctypes.c_int
    return lib


def launch(x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj, *, stride,
           rate, residual):
    """One kernel launch on CUDA tensors, after every check the kernel
    relies on; raises on anything it cannot take.  Returns the output;
    the callers count the launch."""
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
        raise ValueError("the kernel takes channel counts that are multiples "
                         "of 8; got %d, %d, %d" % (cin, cmid, cout))
    if stride not in (1, 2) or rate < 1 or (stride == 2 and rate != 1):
        raise ValueError("stride 1 at any rate, or stride 2 at rate 1; got "
                         "stride %d, rate %d" % (stride, rate))
    if residual and (stride != 1 or cin != cout):
        raise ValueError("a residual block has stride 1 and cin == cout")
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    ws = [w_expand.to(dev, bf16).contiguous() if has_expand else None,
          b_expand.reshape(-1).to(dev, f32).contiguous() if has_expand
          else None,
          w_dw.to(dev, f32).contiguous(),
          b_dw.reshape(-1).to(dev, f32).contiguous(),
          w_proj.to(dev, bf16).contiguous(),
          b_proj.reshape(-1).to(dev, f32).contiguous()]
    ho, wo, top, left = out_geometry(h, w, stride, rate)
    tile_h, tile_w, chunk = stage_tile(cin, cmid, cout, stride, rate,
                                       has_expand)
    out = torch.empty((b, ho, wo, cout), dtype=bf16,
                      device=dev).permute(0, 3, 1, 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().mbconv_launch(
            x.data_ptr(), *(0 if t is None else t.data_ptr() for t in ws),
            out.data_ptr(), b, h, w, cin, cmid, cout, ho, wo, stride, rate,
            top, left, int(residual), tile_h, tile_w, chunk, stream)
    if err != 0:
        raise RuntimeError("mbconv kernel launch failed: CUDA error %d" % err)
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
    out = launch(x, w_expand, b_expand, w_dw, b_dw, w_proj, b_proj,
                 stride=1, rate=rate, residual=residual)
    mbconv_block.launches += 1
    return out


mbconv_block.launches = 0


def run_fused_stage(x, blocks: List[FusedBlock]):
    """Chain stride-1 blocks through the fused kernel, one launch each;
    no mid tensor reaches device memory."""
    x = x.to(torch.bfloat16, memory_format=torch.channels_last)
    for bl in blocks:
        x = mbconv_block(x, bl.w_expand, bl.b_expand, bl.w_dw, bl.b_dw,
                         bl.w_proj, bl.b_proj, rate=bl.rate,
                         residual=bl.residual)
    return x
