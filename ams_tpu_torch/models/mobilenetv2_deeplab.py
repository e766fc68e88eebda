"""DeeplabV3 + MobileNetV2 student network, in PyTorch.

Counterpart of ``ams_tpu/models/mobilenetv2_deeplab.py``, which documents
the architecture against the reference's TF1 meta graph: +1 pad with
127.5 and ``x*2/255-1``; MobileNetV2 at output stride 16 (atrous rate 2 in
blocks 14-16); ASPP 1x1 + image pooling, concat projection, 1x1 logits;
align-corners bilinear resize to the pre-pad frame size.

Parameters are a flat dict keyed by the exact TF variable names, holding
tensors in TF shapes (see ``layers``).  Public functions take frames as
``(B, H, W, 3)`` and return channels-last logits or ``(B, H, W)`` ids like
the JAX package; the internals run channels-first.

``train=False`` (the default) normalizes with the moving statistics, as
the deployed client does.  ``train=True`` normalizes with the batch
statistics, as the reference's training graph does, and records in
``stats_out`` (a dict, if given) the batch moments that the moving-average
update consumes.

``compute_dtype`` (default float32, TF32 off) follows the JAX package's
dtype flow: convolutions cast activation and weight to it, inference BN
stays in the activation's type, training BN takes its moments in f32 and
casts its output back, the image pooling's mean is taken in f32, and the
logits go to f32 before the resize.  Only ``student_grid_logits``
preprocesses in the compute type, and only for inference, as JAX's does:
training preprocesses in f32.  The JAX package defaults these functions'
``compute_dtype`` to bfloat16 where the port keeps float32 (ROADMAP §C).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ams_tpu_torch.models import layers
from ams_tpu_torch.models.resize import resize_nchw
from ams_tpu_torch.utils.platform import resolve_device

Params = Dict[str, torch.Tensor]

# (expansion, out_channels, depthwise_stride, atrous_rate); expansion 0 means
# no expand conv (first block).  Residual add when stride==1 and the width
# is unchanged.
_BLOCKS = [
    (0, 16, 1, 1),    # expanded_conv
    (6, 24, 2, 1),    # expanded_conv_1
    (6, 24, 1, 1),    # expanded_conv_2
    (6, 32, 2, 1),    # expanded_conv_3
    (6, 32, 1, 1),    # expanded_conv_4
    (6, 32, 1, 1),    # expanded_conv_5
    (6, 64, 2, 1),    # expanded_conv_6
    (6, 64, 1, 1),    # expanded_conv_7
    (6, 64, 1, 1),    # expanded_conv_8
    (6, 64, 1, 1),    # expanded_conv_9
    (6, 96, 1, 1),    # expanded_conv_10
    (6, 96, 1, 1),    # expanded_conv_11
    (6, 96, 1, 1),    # expanded_conv_12
    (6, 160, 1, 1),   # expanded_conv_13 (stride 1: OS16 variant)
    (6, 160, 1, 2),   # expanded_conv_14 (atrous)
    (6, 160, 1, 2),   # expanded_conv_15 (atrous)
    (6, 320, 1, 2),   # expanded_conv_16 (atrous)
]

ASPP_DEPTH = 256
STEM_CHANNELS = 32
# DeepLab-head BN epsilon (the trunk uses layers.BN_EPS = 1e-3).
HEAD_BN_EPS = 1.001e-5


def block_name(i: int) -> str:
    return "MobilenetV2/expanded_conv" + ("" if i == 0 else "_%d" % i)


def init_student_params(seed: int = 0, num_classes: int = 19,
                        device=None) -> Params:
    """Random params with the exact names and TF shapes of the reference
    checkpoint, from a seeded ``torch.Generator`` (made on the CPU, so a
    seed gives the same weights on every device; they do not match
    ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}

    def bn(prefix, c):
        params[prefix + "/BatchNorm/gamma"] = torch.ones(c)
        params[prefix + "/BatchNorm/beta"] = torch.zeros(c)
        params[prefix + "/BatchNorm/moving_mean"] = torch.zeros(c)
        params[prefix + "/BatchNorm/moving_variance"] = torch.ones(c)

    def truncated_normal(shape):
        w = torch.empty(shape)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w

    def conv(prefix, kh, kw, cin, cout, depthwise=False):
        shape = (kh, kw, cin, 1) if depthwise else (kh, kw, cin, cout)
        w = truncated_normal(shape) * float(np.sqrt(1.0 / (kh * kw * cin)))
        params[prefix + ("/depthwise_weights" if depthwise else "/weights")] = w
        bn(prefix, cin if depthwise else cout)

    conv("MobilenetV2/Conv", 3, 3, 3, STEM_CHANNELS)
    cin = STEM_CHANNELS
    for i, (exp, cout, _, _) in enumerate(_BLOCKS):
        name = block_name(i)
        mid = cin * exp if exp else cin
        if exp:
            conv(name + "/expand", 1, 1, cin, mid)
        conv(name + "/depthwise", 3, 3, mid, 1, depthwise=True)
        conv(name + "/project", 1, 1, mid, cout)
        cin = cout

    conv("aspp0", 1, 1, cin, ASPP_DEPTH)
    conv("image_pooling", 1, 1, cin, ASPP_DEPTH)
    conv("concat_projection", 1, 1, 2 * ASPP_DEPTH, ASPP_DEPTH)
    params["logits/semantic/weights"] = truncated_normal(
        (1, 1, ASPP_DEPTH, num_classes)) * 0.01
    params["logits/semantic/biases"] = torch.zeros(num_classes)
    return {k: v.to(dev) for k, v in params.items()}


def trainable_names(params) -> list:
    """TF trainable_variables: conv weights + BN gamma/beta + logits bias
    (moving statistics are not trainable)."""
    return [k for k in params if "moving_" not in k]


def preprocess(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, 3, H+1, W+1) in [-1, 1] of
    ``dtype``: pad +1 bottom row and right column with 127.5, then
    ``x*2/255-1``, each operation rounded to ``dtype`` as in JAX."""
    x = frames.to(dtype).permute(0, 3, 1, 2)
    x = torch.nn.functional.pad(x, (0, 1, 0, 1), value=127.5)
    return x * _two_over_255(x.device, dtype) - 1.0


@functools.lru_cache(maxsize=None)
def _two_over_255(device: torch.device, dtype=torch.float32) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(2.0 / 255.0, dtype=dtype, device=device)


def _bn(params, prefix, x, eps=layers.BN_EPS, train=False, stats_out=None,
        reduce=None):
    if train:
        y, mean, var = layers.batch_norm_train(
            x, params[prefix + "/BatchNorm/gamma"],
            params[prefix + "/BatchNorm/beta"], eps=eps, reduce=reduce)
        if stats_out is not None:
            # TF's fused BN hands the *Bessel-corrected* variance to
            # AssignMovingAvg while normalizing with the biased one; the
            # count is the global batch's (equal shares on every rank)
            n = x.shape[0] * x.shape[2] * x.shape[3] \
                * (1 if reduce is None else reduce.world)
            bessel = n / (n - 1) if n > 1 else 1.0
            stats_out[prefix + "/BatchNorm/moving_mean"] = mean.detach()
            stats_out[prefix + "/BatchNorm/moving_variance"] = \
                (var * bessel).detach()
        return y
    return layers.batch_norm_infer(
        x, params[prefix + "/BatchNorm/gamma"],
        params[prefix + "/BatchNorm/beta"],
        params[prefix + "/BatchNorm/moving_mean"],
        params[prefix + "/BatchNorm/moving_variance"], eps=eps)


def backbone(params: Params, x: torch.Tensor, *, train: bool = False,
             stats_out=None, compute_dtype=torch.float32,
             reduce=None, s2d_stem: bool = False) -> torch.Tensor:
    """MobileNetV2 trunk on preprocessed (B, 3, H, W) input; returns
    (B, 320, ceil(H/16), ceil(W/16)).  ``reduce`` spans training BN's
    moments over ranks (``layers.batch_norm_train``).  ``s2d_stem`` runs
    the stride-2 stem as ``layers.conv2d_stride2_s2d`` (the same taps; a
    TPU layout choice in the JAX package, which no path turns on)."""
    cd = compute_dtype
    bn = dict(train=train, stats_out=stats_out, reduce=reduce)
    if s2d_stem:
        x = layers.conv2d_stride2_s2d(x, params["MobilenetV2/Conv/weights"],
                                      compute_dtype=cd)
    else:
        x = layers.conv2d(x, params["MobilenetV2/Conv/weights"], stride=2,
                          compute_dtype=cd)
    x = layers.relu6(_bn(params, "MobilenetV2/Conv", x, **bn))
    cin = STEM_CHANNELS
    for i, (exp, cout, stride, rate) in enumerate(_BLOCKS):
        name = block_name(i)
        inp = x
        if exp:
            x = layers.conv2d(x, params[name + "/expand/weights"],
                              compute_dtype=cd)
            x = layers.relu6(_bn(params, name + "/expand", x, **bn))
        x = layers.depthwise_conv2d(
            x, params[name + "/depthwise/depthwise_weights"],
            stride=stride, rate=rate, compute_dtype=cd)
        x = layers.relu6(_bn(params, name + "/depthwise", x, **bn))
        x = layers.conv2d(x, params[name + "/project/weights"],
                          compute_dtype=cd)
        x = _bn(params, name + "/project", x, **bn)
        if stride == 1 and cin == cout:
            x = x + inp
        cin = cout
    return x


def deeplab_head(params: Params, feat: torch.Tensor,
                 out_hw: Optional[Tuple[int, int]], *, train: bool = False,
                 stats_out=None, compute_dtype=torch.float32,
                 reduce=None) -> torch.Tensor:
    """ASPP (1x1 + image pooling) -> projection -> per-class logits, all
    (B, C, h, w); resized to ``out_hw`` unless it is None (grid logits,
    in the compute type)."""
    cd = compute_dtype
    bn = dict(eps=HEAD_BN_EPS, train=train, stats_out=stats_out,
              reduce=reduce)
    b, _, fh, fw = feat.shape
    pooled = feat.float().mean(dim=(2, 3), keepdim=True)
    pooled = layers.conv2d(pooled, params["image_pooling/weights"],
                           compute_dtype=cd)
    pooled = torch.relu(_bn(params, "image_pooling", pooled, **bn))
    pooled = pooled.expand(b, pooled.shape[1], fh, fw)

    aspp = layers.conv2d(feat, params["aspp0/weights"], compute_dtype=cd)
    aspp = torch.relu(_bn(params, "aspp0", aspp, **bn))

    x = torch.cat([pooled.to(aspp.dtype), aspp], dim=1)
    x = layers.conv2d(x, params["concat_projection/weights"],
                      compute_dtype=cd)
    x = torch.relu(_bn(params, "concat_projection", x, **bn))

    x = layers.conv2d(x, params["logits/semantic/weights"], compute_dtype=cd)
    x = x + params["logits/semantic/biases"].to(x.dtype)[:, None, None]
    if out_hw is None:
        return x
    return resize_nchw(x.float(), out_hw)


def grid_logits_nchw(params: Params, frames: torch.Tensor, *,
                     train: bool = False, stats_out=None,
                     compute_dtype=torch.float32,
                     reduce=None) -> torch.Tensor:
    """(B, H, W, 3) frames -> (B, num_classes, gh, gw) grid logits in the
    compute type; the preprocessing too runs in it when not training."""
    cd = layers.as_dtype(compute_dtype)
    bn = dict(train=train, stats_out=stats_out, compute_dtype=cd,
              reduce=reduce)
    x = preprocess(frames, torch.float32 if train else cd)
    return deeplab_head(params, backbone(params, x, **bn), None, **bn)


def student_grid_logits(params: Params, frames: torch.Tensor, *,
                        train: bool = False, stats_out=None,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Forward stopping at the feature-grid logits: (B, gh, gw, C)."""
    return grid_logits_nchw(params, frames, train=train, stats_out=stats_out,
                            compute_dtype=compute_dtype).permute(0, 2, 3, 1)


def student_logits(params: Params, frames: torch.Tensor, *,
                   train: bool = False, stats_out=None,
                   compute_dtype=torch.float32,
                   reduce=None) -> torch.Tensor:
    """Raw frames -> per-pixel class logits (B, H, W, num_classes) f32;
    the preprocessing runs in f32 whatever the compute type."""
    h, w = frames.shape[1], frames.shape[2]
    bn = dict(train=train, stats_out=stats_out,
              compute_dtype=layers.as_dtype(compute_dtype), reduce=reduce)
    feat = backbone(params, preprocess(frames), **bn)
    return deeplab_head(params, feat, (h, w), **bn).permute(0, 2, 3, 1)


def _class_index(class_indices, device) -> torch.Tensor:
    return _class_index_cached(tuple(int(c) for c in class_indices),
                               torch.device(device))


@functools.lru_cache(maxsize=None)
def _class_index_cached(class_indices, device) -> torch.Tensor:
    """One upload per (subset, device): a host-to-device copy per call
    would wait for the device.  Made outside inference mode, so that
    autograd may save it."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.asarray(class_indices), dtype=torch.long,
                               device=device)


def student_predict_fast(params: Params, frames: torch.Tensor,
                         class_indices, *,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """Client inference: grid logits, then the fused upsample+argmax
    kernel over the class subset, which reads the grid in the compute type
    and layout; never materialises the full-resolution logits.  Returns
    (B, H, W) int32 reduced ids."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = grid_logits_nchw(params, frames, compute_dtype=compute_dtype)
    return fused_resize_argmax(grid, (h, w), class_indices)


def student_forward(params: Params, frames: torch.Tensor, class_indices, *,
                    train: bool = False, stats_out=None,
                    compute_dtype=torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits gathered to the experiment's class subset (B, H, W, n_sel)
    and their argmax (B, H, W) int32, ids in the REDUCED space."""
    logits = student_logits(params, frames, train=train, stats_out=stats_out,
                            compute_dtype=compute_dtype)
    reduced = logits.index_select(3, _class_index(class_indices,
                                                  logits.device))
    preds = torch.argmax(reduced, dim=-1).to(torch.int32)
    return reduced, preds
