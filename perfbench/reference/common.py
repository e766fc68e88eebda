"""Plain PyTorch building blocks of the benchmark's references.

Float32, channels-first, with TF32 off; the weights keep TF's layout
(HWIO, and (kh, kw, C, 1) for depthwise) because the benchmark hands the
same dict to the program, which reads them so.  Nothing here imports the
program.

``rounding`` names how the operands of every convolution are rounded
before it runs in float32: None (the reference itself), "tf32" or "fp8"
(e4m3 with one scale per tensor).  The control of a cell is the
reference one step below the precision its configuration states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0            # largest finite float8_e4m3fn


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDINGS = {None: None, "tf32": _round_tf32, "fp8": _round_fp8}
# the control: each precision a configuration states, one step down
CONTROL_ROUNDING = {"float32": "tf32", "bfloat16": "fp8"}


def rounded(x: torch.Tensor, rounding) -> torch.Tensor:
    """``x`` with its values rounded as ``rounding`` says; the gradient
    passes straight through."""
    fn = ROUNDINGS[rounding]
    if fn is None:
        return x
    with torch.no_grad():
        q = fn(x.detach())
    return x + (q - x).detach() if x.requires_grad else q


def same_pad(size: int, k: int, stride: int, rate: int):
    """TF's "SAME" padding of one axis: (before, after)."""
    k_eff = (k - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _padded(x, kh, kw, stride, rate, padding):
    if padding == "SAME":
        (t, b), (l, r) = (same_pad(x.shape[2], kh, stride, rate),
                          same_pad(x.shape[3], kw, stride, rate))
    else:
        (t, b), (l, r) = padding
    return F.pad(x, (l, r, t, b)) if (t or b or l or r) else x


def conv(x, w_hwio, stride=1, rate=1, padding="SAME", rounding=None):
    """NCHW x HWIO -> NCHW; ``padding`` "SAME" or ((top, bottom), (left,
    right))."""
    w = w_hwio.permute(3, 2, 0, 1)
    x, w = rounded(x, rounding), rounded(w, rounding)
    x = _padded(x, w.shape[2], w.shape[3], stride, rate, padding)
    return F.conv2d(x, w, stride=stride, dilation=rate)


def depthwise(x, w_hwc1, stride=1, rate=1, padding="SAME", rounding=None):
    """Depthwise convolution with a (kh, kw, C, 1) weight."""
    w = w_hwc1.permute(2, 3, 0, 1)
    x, w = rounded(x, rounding), rounded(w, rounding)
    x = _padded(x, w.shape[2], w.shape[3], stride, rate, padding)
    return F.conv2d(x, w, stride=stride, dilation=rate, groups=w.shape[0])


def bn_infer(x, gamma, beta, mean, var, eps):
    inv = torch.rsqrt(var + eps) * gamma
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + beta[:, None, None]


def calibrate_bn(moving_mean, moving_var, x) -> None:
    """Set a BN's moving statistics, in place, from its input ``x`` (N, C,
    H, W): the mean, and the mean square (variance plus squared mean),
    floored at a hundredth of the layer's median mean square.  No
    channel's gain then exceeds the inverse of its root mean square, nor
    ten times the layer's typical one: seeded weights stay as well
    conditioned in low precision as a trained network's, where a channel
    that is nearly constant over the calibration frames would otherwise
    be scaled up hundreds of times."""
    with torch.no_grad():
        square = x.square().mean(dim=(0, 2, 3))
        moving_mean.copy_(x.mean(dim=(0, 2, 3)))
        moving_var.copy_(torch.clamp(square, min=0.01 * float(
            square.median())))


def bn_train(x, gamma, beta, eps):
    """Batch statistics over N, H, W -> (y, mean, biased variance)."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var + eps) * gamma
    y = (x - mean[:, None, None]) * inv[:, None, None] + beta[:, None, None]
    return y, mean, var


def resize_ac(x, out_hw):
    """Align-corners bilinear resize of an NCHW tensor."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)
