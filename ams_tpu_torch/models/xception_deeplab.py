"""DeeplabV3 + Xception-65 teacher network (inference only), in PyTorch.

Counterpart of ``ams_tpu/models/xception_deeplab.py``, which documents the
architecture: TF-slim's ``xception_65`` feature extractor at output stride
16 (the exit flow's stride becomes 1 and its last unit dilates by 2), ASPP
with a 1x1 branch, separable atrous branches at rates 6/12/18 and image
pooling, a concat projection and 1x1 logits, with slim's variable names so
that public DeepLab checkpoints convert one to one.

Parameters are a flat dict keyed by those names, holding tensors in TF
shapes (see ``layers``).  Public functions take frames as ``(B, H, W, 3)``
and return channels-last logits or ``(B, H, W)`` ids, as the JAX package
does; the internals run channels-first.

Conventions kept from the JAX package (the reference's create_teacher and
extract_labels):
- the caller pads each frame by +1 symmetric on top and left and un-pads
  the predictions with ``[1:, 1:]``; the network itself does not pad;
- preprocessing is ``x*2/255 - 1`` in float32 on the raw frame;
- slim's stride-2 3x3 convolutions pad (1, 1) on every side (``conv1_1``
  and the last separable convolution of each stride-2 unit); every other
  convolution, the 1x1 stride-2 shortcuts included, pads as TF's ``SAME``;
- the trunk's batch norms use ``layers.BN_EPS`` (1e-3), the head's
  ``HEAD_BN_EPS``;
- ``compute_dtype`` casts activation and weight before each convolution;
  inference BN keeps the activation's type; the image pooling's mean is
  taken in float32; the concat takes the 1x1 branch's type; the logits'
  bias takes the logits' type.  In bfloat16 the convolutions leave their
  outputs channels-last (``layers``), and the grid logits go to the fused
  upsample+argmax kernel as they are.

Frames may also come as width shards (``parallel.spatial.WidthShards`` of
(B, H, W, 3) over a mesh row): the trunk and the ASPP run on the shards,
the rate-6/12/18 branches through column windows that span every shard
their halo reaches, and the grid logits are gathered on the row's first
device before the resize.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ams_tpu_torch.models import layers
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    _class_index,
    _two_over_255,
)
from ams_tpu_torch.models.resize import resize_nchw, resize_nearest_ac
from ams_tpu_torch.parallel import spatial
from ams_tpu_torch.utils.platform import resolve_device

Params = Dict[str, torch.Tensor]

HEAD_BN_EPS = 1.001e-5
ASPP_DEPTH = 256
ASPP_RATES = (6, 12, 18)          # output stride 16 rates
MIDDLE_UNITS = 16

# (scope, [c1, c2, c3], stride_of_unit, atrous_rate, residual_kind)
_XCEPTION_BLOCKS = (
    [("entry_flow/block1/unit_1", [128, 128, 128], 2, 1, "conv")] +
    [("entry_flow/block2/unit_1", [256, 256, 256], 2, 1, "conv")] +
    [("entry_flow/block3/unit_1", [728, 728, 728], 2, 1, "conv")] +
    [("middle_flow/block1/unit_%d" % (i + 1), [728, 728, 728], 1, 1, "sum")
     for i in range(MIDDLE_UNITS)] +
    # OS16: the exit-flow stride becomes 1 and subsequent convs dilate.
    [("exit_flow/block1/unit_1", [728, 1024, 1024], 1, 1, "conv")] +
    [("exit_flow/block2/unit_1", [1536, 1536, 2048], 1, 2, "none")]
)

# slim's conv2d_same / separable_conv2d_same: explicit (1, 1) padding for
# stride-2 3x3 convolutions (TF's 'SAME' pads (0, 1) at even sizes; the two
# coincide at the odd, +1-padded sizes DeepLab runs at)
_FIXED_PAD_3X3 = ((1, 1), (1, 1))


def _p(scope):
    return "xception_65/" + scope


def init_teacher_params(rng=0, num_classes: int = 19, device=None
                        ) -> Params:
    """Random params with the names and TF shapes of the JAX package's
    ``init_teacher_params``: conv weights from a truncated normal on
    [-2, 2] scaled by sqrt(1/fan), BN at (gamma 1, beta 0, mean 0, var 1),
    logits weights x0.01, zero biases.  ``rng`` is a ``torch.Generator``
    or an int seed; values are drawn on the CPU in the JAX package's
    order, so a seed gives the same weights on every device (they do not
    match ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    params: Params = {}

    def truncated_normal(shape):
        w = torch.empty(shape)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w

    def bn(prefix, c):
        params[prefix + "/BatchNorm/gamma"] = torch.ones(c)
        params[prefix + "/BatchNorm/beta"] = torch.zeros(c)
        params[prefix + "/BatchNorm/moving_mean"] = torch.zeros(c)
        params[prefix + "/BatchNorm/moving_variance"] = torch.ones(c)

    def conv(prefix, kh, kw, cin, cout):
        params[prefix + "/weights"] = truncated_normal(
            (kh, kw, cin, cout)) * float(np.sqrt(1.0 / (kh * kw * cin)))
        bn(prefix, cout)

    def sep(prefix, cin, cout):
        params[prefix + "_depthwise/depthwise_weights"] = truncated_normal(
            (3, 3, cin, 1)) * float(np.sqrt(1.0 / 9))
        bn(prefix + "_depthwise", cin)
        conv(prefix + "_pointwise", 1, 1, cin, cout)

    conv(_p("entry_flow/conv1_1"), 3, 3, 3, 32)
    conv(_p("entry_flow/conv1_2"), 3, 3, 32, 64)
    cin = 64
    for scope, chans, _, _, res in _XCEPTION_BLOCKS:
        base = _p(scope) + "/xception_module"
        c = cin
        for i, cout in enumerate(chans):
            sep(base + "/separable_conv%d" % (i + 1), c, cout)
            c = cout
        if res == "conv":
            conv(base + "/shortcut", 1, 1, cin, chans[-1])
        cin = chans[-1]

    conv("aspp0", 1, 1, cin, ASPP_DEPTH)
    for i in range(1, 4):
        sep("aspp%d" % i, cin, ASPP_DEPTH)
    conv("image_pooling", 1, 1, cin, ASPP_DEPTH)
    conv("concat_projection", 1, 1, (2 + len(ASPP_RATES)) * ASPP_DEPTH,
         ASPP_DEPTH)
    params["logits/semantic/weights"] = truncated_normal(
        (1, 1, ASPP_DEPTH, num_classes)) * 0.01
    params["logits/semantic/biases"] = torch.zeros(num_classes)
    return {k: v.to(dev) for k, v in params.items()}


def _bn(params, prefix, x, eps=layers.BN_EPS):
    return layers.batch_norm_infer(
        x, params[prefix + "/BatchNorm/gamma"],
        params[prefix + "/BatchNorm/beta"],
        params[prefix + "/BatchNorm/moving_mean"],
        params[prefix + "/BatchNorm/moving_variance"], eps=eps)


def _sep_conv(params, prefix, x, stride=1, rate=1, cd=torch.float32):
    """relu -> depthwise(+BN) -> pointwise(+BN), slim xception_module
    order."""
    x = layers.relu(x)
    pad = _FIXED_PAD_3X3 if stride > 1 else "SAME"
    x = layers.depthwise_conv2d(
        x, params[prefix + "_depthwise/depthwise_weights"], stride=stride,
        rate=rate, padding=pad, compute_dtype=cd)
    x = _bn(params, prefix + "_depthwise", x)
    x = layers.conv2d(x, params[prefix + "_pointwise/weights"],
                      compute_dtype=cd)
    return _bn(params, prefix + "_pointwise", x)


def xception_backbone(params: Params, x: torch.Tensor, *,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Xception-65 trunk at OS16 on preprocessed (B, 3, H, W) input ->
    (B, 2048, h/16, w/16)."""
    cd = layers.as_dtype(compute_dtype)
    x = layers.conv2d(x, params[_p("entry_flow/conv1_1/weights")], stride=2,
                      padding=_FIXED_PAD_3X3, compute_dtype=cd)
    x = layers.relu(_bn(params, _p("entry_flow/conv1_1"), x))
    x = layers.conv2d(x, params[_p("entry_flow/conv1_2/weights")],
                      compute_dtype=cd)
    x = layers.relu(_bn(params, _p("entry_flow/conv1_2"), x))

    for scope, chans, stride, rate, res in _XCEPTION_BLOCKS:
        base = _p(scope) + "/xception_module"
        inp = x
        for i in range(len(chans)):
            s = stride if i == len(chans) - 1 else 1
            x = _sep_conv(params, base + "/separable_conv%d" % (i + 1), x,
                          stride=s, rate=rate, cd=cd)
        if res == "conv":
            sc = layers.conv2d(inp, params[base + "/shortcut/weights"],
                               stride=stride, compute_dtype=cd)
            x = x + _bn(params, base + "/shortcut", sc)
        elif res == "sum":
            x = x + inp
    return x


def teacher_logits_nchw(params: Params, frames: torch.Tensor, *,
                        compute_dtype=torch.float32,
                        out_hw="input") -> torch.Tensor:
    """``teacher_logits`` channels-first: (B, C, H, W) float32 logits, or
    with ``out_hw=None`` the (B, C, gh, gw) grid in the compute type (in
    bfloat16 channels-last in memory, as the last convolution leaves
    it)."""
    h, w = frames.shape[1], frames.shape[2]
    cd = layers.as_dtype(compute_dtype)
    to_nchw = (lambda f: f.permute(0, 3, 1, 2).float()
               * _two_over_255(f.device) - 1.0)
    x = frames.map(to_nchw, dim=3) \
        if isinstance(frames, spatial.WidthShards) else to_nchw(frames)
    feat = xception_backbone(params, x, compute_dtype=cd)

    pooled = spatial.mean(spatial.apply(feat, lambda t: t.float()), (2, 3),
                          keepdim=True)
    pooled = layers.conv2d(pooled, params["image_pooling/weights"],
                           compute_dtype=cd)
    pooled = torch.relu(_bn(params, "image_pooling", pooled,
                            eps=HEAD_BN_EPS))

    branches = []
    a0 = layers.conv2d(feat, params["aspp0/weights"], compute_dtype=cd)
    branches.append(layers.relu(_bn(params, "aspp0", a0, eps=HEAD_BN_EPS)))
    for i, rate in enumerate(ASPP_RATES, start=1):
        ax = layers.depthwise_conv2d(
            feat, params["aspp%d_depthwise/depthwise_weights" % i],
            rate=rate, compute_dtype=cd)
        ax = layers.relu(_bn(params, "aspp%d_depthwise" % i, ax,
                             eps=HEAD_BN_EPS))
        ax = layers.conv2d(ax, params["aspp%d_pointwise/weights" % i],
                           compute_dtype=cd)
        branches.append(layers.relu(_bn(params, "aspp%d_pointwise" % i, ax,
                                        eps=HEAD_BN_EPS)))
    pooled = spatial.broadcast(pooled.to(branches[0].dtype), branches[0])

    x = spatial.cat_channels([pooled] + branches)
    x = layers.conv2d(x, params["concat_projection/weights"],
                      compute_dtype=cd)
    x = layers.relu(_bn(params, "concat_projection", x, eps=HEAD_BN_EPS))
    x = layers.conv2d(x, params["logits/semantic/weights"], compute_dtype=cd)
    bias = params["logits/semantic/biases"]
    x = spatial.gather(spatial.apply(
        x, lambda t: t + bias.to(t.device, t.dtype)[:, None, None]))
    if out_hw is None:
        return x
    if out_hw == "input":
        out_hw = (h, w)
    return resize_nchw(x.float(), out_hw)


def teacher_logits(params: Params, frames: torch.Tensor, *,
                   compute_dtype=torch.float32, out_hw="input"
                   ) -> torch.Tensor:
    """Raw frames (B, H, W, 3) in [0, 255], already +1-padded by the
    caller -> per-pixel logits (B, H, W, C) float32, upsampled
    align-corners from the OS16 grid to ``out_hw`` (default the input's
    size); ``out_hw=None`` returns the grid logits (B, gh, gw, C) in the
    compute type."""
    return teacher_logits_nchw(params, frames, compute_dtype=compute_dtype,
                               out_hw=out_hw).permute(0, 2, 3, 1)


def teacher_predict_fast(params: Params, frames: torch.Tensor
                         ) -> torch.Tensor:
    """Fast labeling, the labeler's hot path: the bfloat16 forward's grid
    goes as it is (bf16, channels-last) to the fused upsample+argmax
    kernel, which never materialises full-resolution logits.  Returns
    (B, H, W) int32 ids."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = teacher_logits_nchw(params, frames, compute_dtype=torch.bfloat16,
                               out_hw=None)
    return fused_resize_argmax(grid, (h, w))


def teacher_predictions(params: Params, frames: torch.Tensor, *,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """``teacher_outputs(...)["predictions"]`` alone: the argmax of the
    full-resolution logits, (B, H, W) int32."""
    logits = teacher_logits_nchw(params, frames, compute_dtype=compute_dtype)
    return torch.argmax(logits, dim=1).to(torch.int32)


def teacher_outputs(params: Params, frames: torch.Tensor,
                    class_indices=None, *, compute_dtype=torch.float32,
                    small_hw: Tuple[int, int] = (256, 512)
                    ) -> Dict[str, torch.Tensor]:
    """The create_teacher output bundle, channels-last as in the JAX
    package: ``logits`` (B, H, W, C), ``predictions`` and
    ``probabilities`` (the top softmax value), ``logits_sml`` (the logits
    cropped by one pixel on top and left and resized nearest,
    align-corners, to ``small_hw``), and with ``class_indices`` the
    one-hot predictions gathered to the subset
    (``predictions_one_hot_reduced``), their argmax
    (``predictions_reduced``) and max (``weights``).  Frames are the
    already padded images; un-padding is the caller's job."""
    logits = teacher_logits_nchw(params, frames, compute_dtype=compute_dtype)
    predictions = torch.argmax(logits, dim=1).to(torch.int32)
    probs = torch.softmax(logits, dim=1).amax(dim=1)
    logits_sml = resize_nearest_ac(logits[:, :, 1:, 1:], small_hw,
                                   align_corners=True)
    out = {"logits": logits.permute(0, 2, 3, 1), "predictions": predictions,
           "probabilities": probs,
           "logits_sml": logits_sml.permute(0, 2, 3, 1)}
    if class_indices is not None:
        ci = _class_index(class_indices, logits.device)
        onehot = F.one_hot(predictions.long(), logits.shape[1]).float()
        reduced_oh = onehot.index_select(-1, ci)
        out["predictions_reduced"] = torch.argmax(reduced_oh, -1).to(
            torch.int32)
        out["weights"] = reduced_oh.amax(-1)
        out["predictions_one_hot_reduced"] = reduced_oh
    return out

