"""Dilated depthwise 3x3 convolution, stride 1, bfloat16 channels-last.

Replaces no TPU kernel.  The JAX package leaves its depthwise
convolutions to XLA, and the port left them to ``F.conv2d(groups=C)``,
that is to cuDNN, whose grouped direct kernel for bfloat16 NHWC runs 24x
slower at rate 2 than at rate 1 on an H100 (8.63 ms against 0.359 ms at
8x728x129x257): at output stride 8 the teacher runs 57 such
convolutions per chunk, and they took 64% of its device time.  The
kernel (``csrc/depthwise_dilated.cu``) is bound by bytes: each output
needs 9 multiply-adds and 4 bytes of traffic (its input read once and
itself written once, bf16), 15.1 ms per OS8 chunk at 3.35 TB/s.  It
splits a rate-r convolution into its r^2 sub-lattices, each a rate-1
convolution indexed in place; a thread takes one channel pair and a few
columns of a sub-lattice and walks down its rows with three input rows in
registers, so each input element is read from device memory about once
whatever the rate.  Padding is applied in the kernel (no ``F.pad``);
sums are f32 and round to bf16 once.  An optional epilogue adds a
per-channel f32 bias and takes the ReLU before that rounding: the
teacher's folded inference BN leaves its offset there.

``depthwise_dilated`` is the wrapper: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, and nothing falls back from one to
the other; it raises, on either device, on an input the kernel does not
take; ``takes`` says which convolutions it is given.  Each launch is
counted by ``ops.build.launch`` as ``depthwise_dilated``, and as
``layers/depthwise_dilated`` by ``GLOBAL_TIMER``.
``depthwise_dilated_plan`` cuts a shape into the kernel's blocks.
``depthwise_dilated_plain`` is the plain version: the ``F.conv2d`` call
``models/layers.py::depthwise_conv2d`` makes, the CPU path and the
kernel's oracle on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ams_tpu_torch.ops import build
from ams_tpu_torch.utils.trace import GLOBAL_TIMER

SOURCE = "ams_tpu_torch/csrc/depthwise_dilated.cu"
REPLACES = None          # no TPU kernel: XLA's depthwise convolution
THREADS = 128            # the kernel's kThreads
COLS = 4                 # its kCols: output columns of a sub-lattice each
RESIDENT_BLOCKS = 5      # its kMinBlocks: blocks an SM holds
MIN_STRIP_ROWS = 8
MAX_GRID_YZ = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def depthwise_dilated_plain(x: torch.Tensor, w: torch.Tensor, rate: int,
                            padding, bias=None,
                            relu: bool = False) -> torch.Tensor:
    """The depthwise convolution of ``x`` (B, C, H, W) with the TF-layout
    weight ``w`` (3, 3, C, 1) at stride 1, dilation ``rate`` and the zero
    padding ``(ph, pw)`` on each side, by ``F.conv2d``.  With a ``bias``
    (C,) or ``relu``, the convolution runs in float32, adds the bias and
    takes the ReLU there, and rounds to ``x``'s type once, as the
    kernel's epilogue does."""
    if bias is None and not relu:
        return F.conv2d(x, w.permute(2, 3, 0, 1), stride=1, padding=padding,
                        dilation=rate, groups=w.shape[2])
    y = F.conv2d(x.float(), w.float().permute(2, 3, 0, 1), stride=1,
                 padding=padding, dilation=rate, groups=w.shape[2])
    if bias is not None:
        y = y + bias.float()[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype, memory_format=torch.channels_last)


class Plan(NamedTuple):
    """How the kernel cuts one shape into blocks: the sub-lattices' rows
    in ``strips`` strips of ``strip_rows``; ``blocks`` in all."""

    strips: int
    strip_rows: int
    blocks: int


@functools.lru_cache(maxsize=None)
def depthwise_dilated_plan(n: int, c: int, ho: int, wo: int, rate: int,
                           sms: int) -> Plan:
    """The kernel's blocks for an (n, c, ho, wo) output at ``rate`` on a
    card of ``sms`` SMs.  The rows of a sub-lattice are cut into strips
    only while the grid holds fewer blocks than the card holds at once,
    and not below ``MIN_STRIP_ROWS`` rows: each strip reads two rows
    twice."""
    if min(n, c, ho, wo, rate, sms) < 1:
        raise ValueError("empty depthwise plan: %dx%dx%dx%d at rate %d"
                         % (n, c, ho, wo, rate))
    ws, hs = _cdiv(wo, rate), _cdiv(ho, rate)
    base = _cdiv(_cdiv(ws, COLS) * (c // 2), THREADS) * rate * rate * n
    strips = 1
    while (base * strips < sms * RESIDENT_BLOCKS
           and _cdiv(hs, 2 * strips) >= MIN_STRIP_ROWS):
        strips *= 2
    rows = _cdiv(hs, strips)
    strips = _cdiv(hs, rows)
    return Plan(strips, rows, base * strips)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _refusal(x, w, rate, padding, bias=None, relu=False):
    """-> None where the kernel takes this input, else the exception
    that says why not."""
    if x.dim() != 4:
        return ValueError("x must be (B, C, H, W); got shape %s"
                          % (tuple(x.shape),))
    n, c, h, wdt = x.shape
    if tuple(w.shape) != (3, 3, c, 1):
        return ValueError("w must be (3, 3, %d, 1) for %d channels; got %s"
                          % (c, c, tuple(w.shape)))
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        return TypeError("x and w must be bfloat16; got %s and %s"
                         % (x.dtype, w.dtype))
    if not x.is_contiguous(memory_format=torch.channels_last) \
            or x.data_ptr() % 4:
        return ValueError("x must be channels-last contiguous on a 4-byte "
                          "boundary")
    if c % 2:
        return ValueError("channels must be even (the kernel reads channel "
                          "pairs); got %d" % c)
    if isinstance(rate, bool) or not isinstance(rate, int) \
            or not 1 <= rate * rate <= MAX_GRID_YZ:
        return ValueError("rate must be an int in [1, 255]; got %r"
                          % (rate,))
    if not isinstance(padding, (tuple, list)) or len(padding) != 2 \
            or not all(isinstance(p, int) and p >= 0 for p in padding):
        return ValueError("padding must be (ph, pw), ints >= 0; got %r"
                          % (padding,))
    ph, pw = padding
    ho, wo = h + 2 * ph - 2 * rate, wdt + 2 * pw - 2 * rate
    if n < 1 or ho < 1 or wo < 1:
        return ValueError("empty depthwise convolution: %s at rate %d, "
                          "padding %s" % (tuple(x.shape), rate, padding))
    if c * h * wdt >= 2 ** 31 or c * ho * wo >= 2 ** 31:
        return ValueError("one image spans 2^31 elements or more")
    if w.device != x.device:
        return ValueError("x on %s, w on %s" % (x.device, w.device))
    if relu and bias is None:
        return ValueError("the ReLU rides in the bias epilogue: give a bias")
    if bias is not None and (tuple(bias.shape) != (c,)
                             or bias.dtype != torch.float32
                             or bias.device != x.device):
        return ValueError("bias must be (%d,) float32 on %s; got %s %s on %s"
                          % (c, x.device, tuple(bias.shape), bias.dtype,
                             bias.device))
    return None


def takes(x: torch.Tensor, w: torch.Tensor, stride: int, rate: int,
          padding) -> bool:
    """True where the kernel takes this depthwise convolution and is
    worth its launch: stride 1 and rate 2 or more (at rate 1 cuDNN runs
    near its bound), a 3x3 TF-layout weight, bfloat16 channels-last,
    even channels and a symmetric ``padding`` (ph, pw) left to the
    convolution.  The device is not asked."""
    return stride == 1 and isinstance(rate, int) and rate >= 2 \
        and _refusal(x, w, rate, padding) is None


def depthwise_dilated(x: torch.Tensor, w: torch.Tensor, rate: int,
                      padding, bias=None, relu: bool = False
                      ) -> torch.Tensor:
    """Depthwise 3x3 convolution at stride 1 and dilation ``rate``.

    Args:
        x: (B, C, H, W) bfloat16, channels-last contiguous, C even.
        w: (3, 3, C, 1) bfloat16, TF's depthwise layout.
        rate: the dilation, 1 to 255.
        padding: (ph, pw), the zeros on each side of the height and width.
        bias: None, or (C,) float32 added to each channel's f32 sum.
        relu: take the ReLU after the bias, before the rounding (with a
            bias only).

    Returns:
        (B, C, H + 2 ph - 2 rate, W + 2 pw - 2 rate) bfloat16,
        channels-last, on x's device.
    """
    err = _refusal(x, w, rate, padding, bias, relu)
    if err is not None:
        raise err
    ph, pw = padding
    n, c, h, wdt = x.shape
    ho, wo = h + 2 * ph - 2 * rate, wdt + 2 * pw - 2 * rate
    if x.device.type == "cpu":
        return depthwise_dilated_plain(x, w, rate, (ph, pw), bias, relu)
    if x.device.type != "cuda":
        raise ValueError("depthwise_dilated runs on cpu or cuda tensors, "
                         "not %s" % x.device)
    index = x.device.index
    plan = depthwise_dilated_plan(n, c, ho, wo, rate, _sms(index))
    if n * plan.strips > MAX_GRID_YZ:
        raise ValueError("%d images in %d row strips exceed the grid"
                         % (n, plan.strips))
    wk = w.reshape(9, c).contiguous()
    if wk.data_ptr() % 4:
        wk = wk.clone()
    if bias is not None:
        bias = bias.contiguous()
        if bias.data_ptr() % 8:
            bias = bias.clone()
    out = torch.empty((n, c, ho, wo), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    build.launch(
        "depthwise_dilated", "depthwise_dilated", index,
        (x.data_ptr(), wk.data_ptr(),
         None if bias is None else bias.data_ptr(), out.data_ptr(), n, c, h,
         wdt, ho, wo, rate, ph, pw, plan.strips, plan.strip_rows, int(relu)),
        lambda: "x %s, rate %d, padding %s, bias %s, relu %s"
        % (tuple(x.shape), rate, (ph, pw), bias is not None, relu))
    GLOBAL_TIMER.count("layers/depthwise_dilated")
    return out
