"""Functional NN building blocks with TF1-matching numerics, in PyTorch.

Counterpart of ``ams_tpu/models/layers.py``.  Activations run channels-first
``(B, C, H, W)``; weights keep TF's layout and shapes (HWIO, and
``(kh, kw, C, 1)`` for depthwise), because the delta wire format indexes
masks and values in that order.  Each convolution permutes its weight to
PyTorch's OIHW at call time.

TF ``"SAME"`` padding is asymmetric for stride 2 (the extra row and column
go bottom and right), which ``F.conv2d(padding="same")`` does not offer at
stride 2, so the padding is explicit: ``lo = total // 2``, ``hi = total - lo``.
``padding`` may also name the pairs ``((top, bottom), (left, right))``
itself, as ``lax.conv_general_dilated`` takes them (slim's fixed padding of
the teacher's stride-2 convolutions).  In bfloat16 a symmetric padding goes
to the convolution itself, saving a copy of the padded tensor; float32
keeps the explicit pad, and so its sums.

Every layer here also takes width shards (``parallel.spatial.WidthShards``,
the mesh's ``model`` axis): a convolution runs on each shard's column
window, padded in height as the whole tensor and not in width (the window
holds the halo and the zeros); training BN takes its moments as the
column-weighted sum of the shards'; the rest runs shard by shard.

``conv2d_bias`` and ``depthwise_conv2d_bias`` add a bias per channel (and
a ReLU) after the convolution, in its epilogue where it has one: a 1x1 at
stride 1 as a cuBLASLt GEMM, a dilated depthwise 3x3 in the port's
kernel; as a pass each elsewhere.  They take whole tensors, not shards.

``compute_dtype`` (None keeps the input's type) casts activation and weight
before a convolution, as the JAX package does.  In bfloat16 the activation
is also put in ``torch.channels_last`` memory, the NHWC storage that both
cuDNN's bf16 convolutions and the port's fused MBConv kernel read, so the
unfused and fused blocks chain without a permute copy; cuDNN (and oneDNN on
the CPU) accumulate in f32 and return bf16.  Float32 stays in the default
layout, with TF32 off (``utils.platform``).  Inside ``video_batched()``
(the batched multi-video round's ``torch.func.vmap``) bfloat16 keeps the
default layout too.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ams_tpu_torch.ops import depthwise_dilated
from ams_tpu_torch.parallel import spatial

BN_EPS = 1e-3          # FusedBatchNormV3 epsilon in the reference meta graph
BN_DECAY = 0.9         # moving-average decay of the reference's BN updates

_VIDEO_BATCHED = contextvars.ContextVar("video_batched", default=False)


@contextlib.contextmanager
def video_batched():
    """Inside, the layers run under ``torch.func.vmap`` over videos: an
    activation holds a video axis that its shape does not show, and a 4-D
    memory format cannot apply to it, so bfloat16 convolutions keep the
    batching rule's layout instead of ``torch.channels_last``."""
    token = _VIDEO_BATCHED.set(True)
    try:
        yield
    finally:
        _VIDEO_BATCHED.reset(token)


def _same_pad(size: int, k: int, stride: int, rate: int):
    k_eff = (k - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _pairs(h, w, kh, kw, stride, rate, padding):
    """``padding`` (``"SAME"``, TF's, or ``((top, bottom), (left,
    right))``) as the pairs, for an (h, w) input."""
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError("padding must be 'SAME' or ((top, bottom), "
                             "(left, right)), got %r" % (padding,))
        return (_same_pad(h, kh, stride, rate), _same_pad(w, kw, stride, rate))
    return tuple(padding)


def _pad(x, kh, kw, stride, rate, padding):
    """-> (x, padding): in bf16 a symmetric padding is returned for the
    convolution to apply; any other is applied here."""
    (top, bottom), (left, right) = _pairs(x.shape[2], x.shape[3], kh, kw,
                                          stride, rate, padding)
    if x.dtype == torch.bfloat16 and top == bottom and left == right:
        return x, (top, left)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x, 0


def as_dtype(compute_dtype):
    """None, a torch dtype, or its name ("bfloat16", "float32") -> a torch
    dtype or None."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    name = str(compute_dtype).replace("torch.", "")
    if name not in ("bfloat16", "float32"):
        raise ValueError("compute_dtype must be bfloat16 or float32, got %r"
                         % (compute_dtype,))
    return getattr(torch, name)


def _cast(x, w, compute_dtype):
    cd = as_dtype(compute_dtype)
    if cd is None:
        return x, w
    if cd == torch.bfloat16 and not _VIDEO_BATCHED.get():
        return (x.to(cd, memory_format=torch.channels_last), w.to(cd))
    return x.to(cd), w.to(cd)


def _over_width(conv, x, w, stride, rate, padding, compute_dtype):
    """``conv`` of width shards: each shard's output columns from its
    column window, with the whole tensor's height padding."""
    (top, bottom), (left, right) = _pairs(x.shape[2], x.shape[3], w.shape[0],
                                          w.shape[1], stride, rate, padding)
    k_eff = (w.shape[1] - 1) * rate + 1
    out_w = (x.shape[3] + left + right - k_eff) // stride + 1
    return spatial.conv_columns(
        x, k_eff, stride, left, out_w,
        lambda win: conv(win, w.to(win.device), stride, rate,
                         ((top, bottom), (0, 0)),
                         compute_dtype=compute_dtype))


def conv2d(x, w, stride=1, rate=1, padding="SAME", *, compute_dtype=None):
    """2-D convolution, NCHW x HWIO -> NCHW, TF 'SAME' padding unless
    ``padding`` gives the pairs; ``rate`` is the atrous rate (dilation)."""
    if isinstance(x, spatial.WidthShards):
        return _over_width(conv2d, x, w, stride, rate, padding, compute_dtype)
    x, w = _cast(x, w, compute_dtype)
    x, pad = _pad(x, w.shape[0], w.shape[1], stride, rate, padding)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                    dilation=rate)


def takes_dilated_kernel(x, w, stride, rate, pad) -> bool:
    """True where ``depthwise_conv2d`` gives an input (after ``_cast`` and
    ``_pad``) to the dilated depthwise kernel: where the kernel takes
    it (``depthwise_dilated.takes``), outside ``video_batched()`` and with
    no gradient wanted.  Everything else, rate 1 among it, stays with
    ``F.conv2d``."""
    return (not _VIDEO_BATCHED.get()
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad))
            and depthwise_dilated.takes(x, w, stride, rate, pad))


def _depthwise_route(x, w, stride, rate, padding, compute_dtype):
    """``_cast`` and ``_pad`` -> (x, w, pad, True where the dilated
    depthwise kernel takes it): on the card the kernel, on the CPU its
    plain version, the same ``F.conv2d`` call as the other route."""
    x, w = _cast(x, w, compute_dtype)
    x, pad = _pad(x, w.shape[0], w.shape[1], stride, rate, padding)
    return x, w, pad, takes_dilated_kernel(x, w, stride, rate, pad)


def _depthwise_library(x, w, stride, rate, pad):
    return F.conv2d(x, w.permute(2, 3, 0, 1), stride=stride, padding=pad,
                    dilation=rate, groups=w.shape[2])


def depthwise_conv2d(x, w, stride=1, rate=1, padding="SAME", *,
                     compute_dtype=None):
    """Depthwise conv; ``w`` is TF-layout (kh, kw, C, 1); ``padding`` as
    in ``conv2d``.  A dilated 3x3 goes to the port's kernel where
    ``takes_dilated_kernel`` holds."""
    if isinstance(x, spatial.WidthShards):
        return _over_width(depthwise_conv2d, x, w, stride, rate, padding,
                           compute_dtype)
    x, w, pad, kernel = _depthwise_route(x, w, stride, rate, padding,
                                         compute_dtype)
    if kernel:
        return depthwise_dilated.depthwise_dilated(x, w, rate, pad)
    return _depthwise_library(x, w, stride, rate, pad)


def _bias_pass(y, b, relu):
    """``y`` plus the bias ``b`` per channel, then the ReLU where
    ``relu``: one pass each, in place, the sum rounded to ``y``'s type."""
    y = y.add_(b[:, None, None])
    return y.relu_() if relu else y


def conv2d_bias(x, w, b, stride=1, rate=1, padding="SAME", *,
                compute_dtype=None, relu=False):
    """``conv2d`` plus the bias ``b`` (Cout,) per output channel, then the
    ReLU where ``relu`` -> (y, True where the bias rode in the
    convolution's epilogue).

    A 1x1 convolution at stride 1 whose input is channels-last
    contiguous (after ``_cast``: bfloat16 always is) is a GEMM on the
    input's (N*H*W, Cin) view, and its result, row-major (N*H*W, Cout),
    is the channels-last output: ``addmm`` adds the bias (in the input's
    type) in cuBLASLt's epilogue, ``_addmm_activation`` the bias and the
    ReLU (on an H100 with torch 2.11 at every row count of the teacher's,
    4.2 M among them).  Anything else adds them as one pass each."""
    x, w = _cast(x, w, compute_dtype)
    if w.shape[:2] != (1, 1) or stride != 1 \
            or not x.is_contiguous(memory_format=torch.channels_last):
        return _bias_pass(conv2d(x, w, stride, rate, padding), b, relu), \
            False
    n, c, h, wd = x.shape
    a = x.permute(0, 2, 3, 1).reshape(-1, c)
    gemm = torch._addmm_activation if relu else torch.addmm
    y = gemm(b.to(x.dtype), a, w.reshape(c, w.shape[3]))
    return y.view(n, h, wd, -1).permute(0, 3, 1, 2), True


def depthwise_conv2d_bias(x, w, b, stride=1, rate=1, padding="SAME", *,
                          compute_dtype=None, relu=False):
    """``depthwise_conv2d`` plus the float32 bias ``b`` (C,) per channel,
    then the ReLU where ``relu`` -> (y, True where the bias rode in the
    convolution's epilogue): the dilated depthwise kernel's (on the CPU,
    its plain version, which adds them in float32 before one rounding as
    the kernel does), else one pass each after ``F.conv2d``."""
    x, w, pad, kernel = _depthwise_route(x, w, stride, rate, padding,
                                         compute_dtype)
    if kernel:
        return depthwise_dilated.depthwise_dilated(
            x, w, rate, pad, bias=b, relu=relu), True
    return _bias_pass(_depthwise_library(x, w, stride, rate, pad), b,
                      relu), False


def conv2d_stride2_s2d(x, w, *, compute_dtype=None):
    """3x3 stride-2 'SAME' conv through space-to-depth, as the JAX package
    computes it: the 2x2 pixel blocks packed into channels (4C of them),
    the 3x3 kernel repacked onto a 2x2 grid of those channels (zero where
    a tap falls outside), then a 2x2 VALID convolution.  The same taps and
    zero padding as ``conv2d(x, w, stride=2)``, in another summation order.

    x: (B, C, H, W) with H, W odd (the +1-padded DeepLab input); w:
    (3, 3, C, O).  Returns (B, O, ceil(H/2), ceil(W/2)).
    """
    x, w = _cast(x, w, compute_dtype)
    b, c, h, wdt = x.shape
    # the top/left pad of 1 below IS TF-SAME only for odd sizes (even
    # inputs pad 0 on top/left)
    if h % 2 == 0 or wdt % 2 == 0:
        raise ValueError(
            "conv2d_stride2_s2d requires odd H, W (the +1-padded DeepLab "
            "input); got %dx%d, whose TF-SAME padding differs" % (h, wdt))
    oh, ow = (h + 1) // 2, (wdt + 1) // 2
    # pad 1 on each side (SAME), and further so the block grid is even;
    # the extra rows and columns are never read by a kept output
    hp, wp = 2 * (oh + 1), 2 * (ow + 1)
    xp = F.pad(x, (1, wp - wdt - 1, 1, hp - h - 1))
    # channel (a * 2 + bb) * C + cc holds pixel (2i + a, 2j + bb) of cc
    xs = xp.reshape(b, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(b, 4 * c, hp // 2, wp // 2)
    w2 = w.new_zeros((2, 2, 4 * c, w.shape[-1]))
    for p in range(2):
        for q in range(2):
            for a in range(2):
                for bb in range(2):
                    di, dj = 2 * p + a, 2 * q + bb
                    if di <= 2 and dj <= 2:
                        idx = (a * 2 + bb) * c
                        w2[p, q, idx:idx + c] = w[di, dj]
    out = F.conv2d(xs, w2.permute(3, 2, 0, 1))
    return out[:, :, :oh, :ow]


def batch_norm_infer(x, gamma, beta, mean, var, eps=BN_EPS):
    """Inference batch norm using moving statistics, on (B, C, H, W).
    Scale and offset are computed in the statistics' type and cast to the
    activation's, as in the JAX package: a bf16 activation stays bf16."""
    inv = torch.rsqrt(var + eps)
    scale = (gamma * inv).to(x.dtype)
    offset = (beta - mean * gamma * inv).to(x.dtype)
    return spatial.apply(x, lambda t: t * scale.to(t.device)[:, None, None]
                         + offset.to(t.device)[:, None, None])


def batch_norm_train(x, gamma, beta, eps=BN_EPS, reduce=None):
    """Training batch norm with per-batch statistics over N, H, W of a
    (B, C, H, W) tensor.

    Returns (y, batch_mean, batch_var), batch_var being the *biased*
    variance used for normalization (FusedBatchNormV3 semantics), computed
    as E[x^2] - E[x]^2 and clamped at 0, as the JAX package does.

    ``reduce`` (a ``parallel.collectives.SumReducer``) takes the moments
    over the global batch of which ``x`` is this rank's equal share: each
    rank's E[x] and E[x^2] times 1/world, summed over the ranks in one
    differentiable all-reduce.  At world size 1 that is the local moments
    times 1.0, so the result is the same to the bit as without it.

    Over width shards the moments are the shards' weighted by their
    column counts (``spatial.mean``), and the statistics live on the
    first shard's device.
    """
    xf = spatial.apply(x, lambda t: t.float())
    mean = spatial.mean(xf, (0, 2, 3))
    sq = spatial.mean(spatial.apply(xf, torch.square), (0, 2, 3))
    if reduce is not None:
        mean, sq = reduce(torch.cat([mean, sq]) * (1.0 / reduce.world)
                          ).chunk(2)
    var = torch.clamp(sq - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps) * gamma

    def norm(t):
        m, i, b = (v.to(t.device)[:, None, None] for v in (mean, inv, beta))
        return ((t - m) * i + b).to(x.dtype)

    return spatial.apply(xf, norm), mean, var


def moving_average_update(moving, batch_stat, n_elems, decay=BN_DECAY,
                          bessel=True):
    """moving <- moving - (moving - stat) * (1 - decay).

    TF's fused BN feeds the moving-variance update with the Bessel-corrected
    (unbiased) batch variance; pass ``n_elems`` = N*H*W of the normalized
    axes.
    """
    if bessel and n_elems > 1:
        batch_stat = batch_stat * (n_elems / (n_elems - 1))
    return moving - (moving - batch_stat) * (1.0 - decay)


def relu6(x):
    return spatial.apply(x, lambda t: torch.clamp(t, 0.0, 6.0))


def relu(x):
    return spatial.apply(x, torch.relu)
