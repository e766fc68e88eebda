"""Functional NN building blocks with TF1-matching numerics, in PyTorch.

Counterpart of ``ams_tpu/models/layers.py``.  Activations run channels-first
``(B, C, H, W)``; weights keep TF's layout and shapes (HWIO, and
``(kh, kw, C, 1)`` for depthwise), because the delta wire format indexes
masks and values in that order.  Each convolution permutes its weight to
PyTorch's OIHW at call time.

TF ``"SAME"`` padding is asymmetric for stride 2 (the extra row and column
go bottom and right), which ``F.conv2d(padding="same")`` does not offer at
stride 2, so the padding is explicit: ``lo = total // 2``, ``hi = total - lo``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3          # FusedBatchNormV3 epsilon in the reference meta graph


def _same_pad(size: int, k: int, stride: int, rate: int):
    k_eff = (k - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, rate):
    top, bottom = _same_pad(x.shape[2], kh, stride, rate)
    left, right = _same_pad(x.shape[3], kw, stride, rate)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


def conv2d(x, w, stride=1, rate=1):
    """2-D convolution, NCHW x HWIO -> NCHW, TF 'SAME' semantics; ``rate``
    is the atrous rate (dilation)."""
    kh, kw = w.shape[0], w.shape[1]
    x = _pad_same(x, kh, kw, stride, rate)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, dilation=rate)


def depthwise_conv2d(x, w, stride=1, rate=1):
    """Depthwise conv; ``w`` is TF-layout (kh, kw, C, 1)."""
    kh, kw, c = w.shape[0], w.shape[1], w.shape[2]
    x = _pad_same(x, kh, kw, stride, rate)
    return F.conv2d(x, w.permute(2, 3, 0, 1), stride=stride, dilation=rate,
                    groups=c)


def batch_norm_infer(x, gamma, beta, mean, var, eps=BN_EPS):
    """Inference batch norm using moving statistics, on (B, C, H, W)."""
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    offset = beta - mean * gamma * inv
    return x * scale[:, None, None] + offset[:, None, None]


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)
