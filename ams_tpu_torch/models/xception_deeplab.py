"""DeeplabV3 + Xception-65 teacher network (inference only), in PyTorch,
and DeepLabV3+ (the same trunk with DeepLab's decoder).

Counterpart of ``ams_tpu/models/xception_deeplab.py``, which documents the
architecture: TF-slim's ``xception_65`` feature extractor at output stride
16 (the exit flow's stride becomes 1 and its last unit dilates by 2), ASPP
with a 1x1 branch, separable atrous branches at rates 6/12/18 and image
pooling, a concat projection and 1x1 logits, with slim's variable names so
that public DeepLab checkpoints convert one to one.

A ``TeacherConfig`` chooses the teacher, under the names of DeepLab's own
flags.  The default, ``TEACHER_OS16``, is the AMS teacher above, the JAX
package's one.  Other configurations follow DeepLab's ``xception_65`` and
``refine_by_decoder`` (arXiv:1802.02611; research/deeplab/core/xception.py
and model.py of tensorflow/models):

- ``output_stride`` 8 or 16: the block table is built as slim's
  ``stack_blocks_dense`` builds it (``xception_blocks``), and the ASPP
  rates scale with it (6/12/18 at 16, 12/24/36 at 8);
- ``decoder_output_stride`` 4: the trunk keeps the stride-4 endpoint
  ``entry_flow/block2/unit_1/xception_module/separable_conv2_pointwise``
  (after its BN, before the ReLU that opens ``separable_conv3``), and
  ``deeplab_decoder`` refines the ASPP's output with it; the logits are
  then at stride 4;
- ``exit_relu_in_separable_conv``: DeepLab's ``exit_flow/block2`` has
  ``activation_fn_in_separable_conv=True``, a ReLU after each BN of its
  separable convolutions and none before them.  The AMS teacher, as both
  packages authored it, puts the ReLU before, as every other unit does.

``DEEPLABV3PLUS_OS8`` is the DeepLab model zoo's Cityscapes checkpoint
``xception65_cityscapes_trainfine`` as the zoo evaluates it: output stride
8, the decoder at 4, DeepLab's activation order.

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
- the trunk's batch norms use ``layers.BN_EPS`` (1e-3), the head's and
  the decoder's ``HEAD_BN_EPS``;
- ``compute_dtype`` casts activation and weight before each convolution;
  inference BN keeps the activation's type; the image pooling's mean is
  taken in float32; the concat takes the 1x1 branch's type; the logits'
  bias takes the logits' type; the decoder's resize computes in float32
  (``models.resize``) and returns the ASPP's type.  In bfloat16 the
  convolutions leave their outputs channels-last (``layers``), and the
  grid logits go to the fused upsample+argmax kernel as they are.

``fold_teacher`` folds every inference BN into the convolution before it,
as the labeler's bfloat16 path runs the teacher.  One forward takes either
params: raw ones run each BN unfused, as above (the float32 path, width
shards, the sharded labeler); on folded ones each convolution adds its
BN's offset (and the ReLU after it) in its epilogue where it has one, a
1x1 at stride 1 (a cuBLASLt GEMM) or a dilated depthwise 3x3 (the port's
kernel), and as one pass each elsewhere: the stems, rate-1 and stride-2
depthwise convolutions, stride-2 shortcuts.  Counters
(``GLOBAL_TIMER.count``): ``teacher/bn_epilogue`` per offset in an
epilogue, ``teacher/bn_pass`` per offset added as a pass.

Spans (``utils.trace.GLOBAL_TIMER``): ``teacher/trunk`` (the trunk),
``teacher/aspp`` (image pooling to the concat projection) and, with a
decoder, ``teacher/decoder``; the logits' 1x1 convolution lies in none.
On the card they time the enqueue, not the device's work.

Frames may also come as width shards (``parallel.spatial.WidthShards`` of
(B, H, W, 3) over a mesh row) for the AMS teacher alone: the trunk and the
ASPP run on the shards, the rate-6/12/18 branches through column windows
that span every shard their halo reaches, and the grid logits are gathered
on the row's first device before the resize.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ams_tpu_torch.models import frozen, layers
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    _class_index,
    _two_over_255,
)
from ams_tpu_torch.models.resize import resize_nchw, resize_nearest_ac
from ams_tpu_torch.parallel import spatial
from ams_tpu_torch.utils.platform import resolve_device
from ams_tpu_torch.utils.trace import GLOBAL_TIMER

Params = Dict[str, torch.Tensor]

HEAD_BN_EPS = 1.001e-5
ASPP_DEPTH = 256
ASPP_RATES = (6, 12, 18)          # output stride 16 rates
MIDDLE_UNITS = 16
DECODER_DEPTH = 256
DECODER_PROJECTION = 48           # channels of the projected endpoint


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    """Which teacher (module docstring): ``output_stride`` 8 or 16,
    ``decoder_output_stride`` None or 4, and whether ``exit_flow/block2``
    puts its ReLUs after each BN (DeepLab's order) instead of before each
    depthwise convolution (the AMS teacher's)."""
    output_stride: int = 16
    decoder_output_stride: Optional[int] = None
    exit_relu_in_separable_conv: bool = False

    def __post_init__(self):
        if self.output_stride not in (8, 16):
            raise ValueError("output_stride must be 8 or 16, got %r"
                             % (self.output_stride,))
        if self.decoder_output_stride not in (None, 4):
            raise ValueError("decoder_output_stride must be None or 4, got %r"
                             % (self.decoder_output_stride,))


TEACHER_OS16 = TeacherConfig()
DEEPLABV3PLUS_OS8 = TeacherConfig(output_stride=8, decoder_output_stride=4,
                                  exit_relu_in_separable_conv=True)


def deeplab_teacher(output_stride: int = 16,
                    decoder_output_stride: Optional[int] = None
                    ) -> TeacherConfig:
    """The teacher that DeepLab's two flags name: at their defaults (16,
    None) the AMS teacher, otherwise DeepLab's ``xception_65`` as
    published, with its activation order in ``exit_flow/block2``."""
    if (output_stride, decoder_output_stride) == (16, None):
        return TEACHER_OS16
    return TeacherConfig(output_stride, decoder_output_stride, True)


# xception_65's blocks as DeepLab declares them: (scope, [c1, c2, c3],
# stride of the unit, residual kind)
_XCEPTION_65 = (
    [("entry_flow/block1/unit_1", [128, 128, 128], 2, "conv"),
     ("entry_flow/block2/unit_1", [256, 256, 256], 2, "conv"),
     ("entry_flow/block3/unit_1", [728, 728, 728], 2, "conv")] +
    [("middle_flow/block1/unit_%d" % (i + 1), [728, 728, 728], 1, "sum")
     for i in range(MIDDLE_UNITS)] +
    [("exit_flow/block1/unit_1", [728, 1024, 1024], 2, "conv"),
     ("exit_flow/block2/unit_1", [1536, 1536, 2048], 1, "none")]
)
_EXIT_BLOCK2 = "exit_flow/block2/unit_1"
# the decoder's stride-4 endpoint: the output of this separable
# convolution's pointwise BN
_DECODER_END_POINT = ("entry_flow/block2/unit_1", 2)


def xception_blocks(config: TeacherConfig = TEACHER_OS16):
    """[(scope, [c1, c2, c3], stride of the unit, atrous rate, residual
    kind)] at ``config.output_stride``, as slim's ``stack_blocks_dense``
    builds it: once the stride reached equals the target (the root
    convolution's stride 2 counted), each further unit runs at stride 1
    and dilates by the product of the strides it skipped before it."""
    target = config.output_stride // 2
    current, rate, out = 1, 1, []
    for scope, chans, stride, res in _XCEPTION_65:
        if current == target:
            out.append((scope, list(chans), 1, rate, res))
            rate *= stride
        else:
            out.append((scope, list(chans), stride, 1, res))
            current *= stride
    return out


def aspp_rates(config: TeacherConfig = TEACHER_OS16) -> Tuple[int, ...]:
    """The separable ASPP branches' rates: 6/12/18 at output stride 16,
    doubled at 8."""
    return tuple(r * 16 // config.output_stride for r in ASPP_RATES)


# slim's conv2d_same / separable_conv2d_same: explicit (1, 1) padding for
# stride-2 3x3 convolutions (TF's 'SAME' pads (0, 1) at even sizes; the two
# coincide at the odd, +1-padded sizes DeepLab runs at)
_FIXED_PAD_3X3 = ((1, 1), (1, 1))


def _p(scope):
    return "xception_65/" + scope


def init_teacher_params(rng=0, num_classes: int = 19, device=None,
                        config: TeacherConfig = TEACHER_OS16) -> Params:
    """Random params with the names and TF shapes of the JAX package's
    ``init_teacher_params``: conv weights from a truncated normal on
    [-2, 2] scaled by sqrt(1/fan), BN at (gamma 1, beta 0, mean 0, var 1),
    logits weights x0.01, zero biases.  ``rng`` is a ``torch.Generator``
    or an int seed; values are drawn on the CPU in the JAX package's
    order, so a seed gives the same weights on every device (they do not
    match ``jax.random``'s).  A ``config`` with a decoder adds its
    variables under DeepLab's names (``decoder/feature_projection0``,
    ``decoder/decoder_conv{0,1}_{depthwise,pointwise}``), drawn after the
    concat projection's."""
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
    for scope, chans, _, _, res in xception_blocks(config):
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
    if config.decoder_output_stride is not None:
        # the endpoint: entry_flow/block2's 256 channels
        conv("decoder/feature_projection0", 1, 1, 256, DECODER_PROJECTION)
        sep("decoder/decoder_conv0", ASPP_DEPTH + DECODER_PROJECTION,
            DECODER_DEPTH)
        sep("decoder/decoder_conv1", DECODER_DEPTH, DECODER_DEPTH)
    params["logits/semantic/weights"] = truncated_normal(
        (1, 1, ASPP_DEPTH, num_classes)) * 0.01
    params["logits/semantic/biases"] = torch.zeros(num_classes)
    return {k: v.to(dev) for k, v in params.items()}


def fold_teacher(params: Params, dtype=torch.float32) -> Params:
    """Teacher params -> BN-folded params, as ``frozen.fold_student`` folds
    the student's, by the same ``frozen.fold_bn``: each inference BN's
    scale into the convolution before it and its offset into a
    ``<conv>/folded_bias``, with each BN's own eps (``layers.BN_EPS`` in
    the trunk, under ``xception_65/``; ``HEAD_BN_EPS`` in the head and the
    decoder).  Every BN of the configuration folds, the trunk's, the
    ASPP's, the image pooling's and the decoder's alike; the logits layer
    is untouched.  Computed in float32 on the params' device, then cast
    once to the types the forward consumes: the weights to ``dtype`` (the
    labeler's bfloat16), a full convolution's offset to ``dtype`` (the
    GEMM's epilogue and the pass add it in the activation's type), a
    depthwise convolution's kept float32 (the dilated kernel adds it to
    its f32 sum, a pass before the one rounding)."""
    out = {}
    for key in params:
        if not key.endswith("/BatchNorm/gamma"):
            continue
        prefix = key[:-len("/BatchNorm/gamma")]
        eps = layers.BN_EPS if prefix.startswith(_p("")) else HEAD_BN_EPS
        depthwise = prefix + "/depthwise_weights" in params
        wk = prefix + ("/depthwise_weights" if depthwise else "/weights")
        w, b = frozen.fold_bn(params, prefix, wk, eps, depthwise)
        out[wk] = w.to(dtype)
        out[prefix + "/folded_bias"] = b if depthwise else b.to(dtype)
    for k in ("logits/semantic/weights", "logits/semantic/biases"):
        out[k] = params[k]
    return out


def _bn(params, prefix, x, eps=layers.BN_EPS):
    return layers.batch_norm_infer(
        x, params[prefix + "/BatchNorm/gamma"],
        params[prefix + "/BatchNorm/beta"],
        params[prefix + "/BatchNorm/moving_mean"],
        params[prefix + "/BatchNorm/moving_variance"], eps=eps)


def _conv_bn(params, prefix, x, *, depthwise=False, stride=1, rate=1,
             padding="SAME", cd=torch.float32, eps=layers.BN_EPS,
             relu=False):
    """The convolution ``prefix``, its inference BN and, where ``relu``, a
    ReLU.  Raw params run them unfused: the convolution, ``_bn``, then
    ``layers.relu``.  Folded params (``fold_teacher``: a
    ``<prefix>/folded_bias``) run the convolution on the scaled weights
    and add the offset and the ReLU in its epilogue where it has one
    (``layers.conv2d_bias``, ``layers.depthwise_conv2d_bias``), counted
    as ``teacher/bn_epilogue``, else as one pass each, counted as
    ``teacher/bn_pass``.  Folded params refuse width shards."""
    wk = prefix + ("/depthwise_weights" if depthwise else "/weights")
    bias = params.get(prefix + "/folded_bias")
    if bias is None:
        conv = layers.depthwise_conv2d if depthwise else layers.conv2d
        x = _bn(params, prefix, conv(x, params[wk], stride=stride, rate=rate,
                                     padding=padding, compute_dtype=cd),
                eps=eps)
        return layers.relu(x) if relu else x
    if isinstance(x, spatial.WidthShards):
        raise ValueError("folded teacher params run on whole frames, not "
                         "width shards: shard the raw params' forward")
    conv = layers.depthwise_conv2d_bias if depthwise else layers.conv2d_bias
    x, fused = conv(x, params[wk], bias, stride=stride, rate=rate,
                    padding=padding, compute_dtype=cd, relu=relu)
    GLOBAL_TIMER.count("teacher/bn_epilogue" if fused else "teacher/bn_pass")
    return x


def _sep_conv(params, prefix, x, stride=1, rate=1, cd=torch.float32,
              relu_after=False, eps=layers.BN_EPS):
    """A separable convolution in slim's split form: depthwise(+BN) ->
    pointwise(+BN).  The xception_module order puts a ReLU before it;
    ``relu_after`` puts one after each BN instead (DeepLab's
    ``activation_fn_in_separable_conv``, its ASPP branches and its
    decoder's ``split_separable_conv2d``)."""
    if not relu_after:
        x = layers.relu(x)
    pad = _FIXED_PAD_3X3 if stride > 1 else "SAME"
    x = _conv_bn(params, prefix + "_depthwise", x, depthwise=True,
                 stride=stride, rate=rate, padding=pad, cd=cd, eps=eps,
                 relu=relu_after)
    return _conv_bn(params, prefix + "_pointwise", x, cd=cd, eps=eps,
                    relu=relu_after)


def xception_backbone(params: Params, x: torch.Tensor, *,
                      compute_dtype=torch.float32,
                      config: TeacherConfig = TEACHER_OS16):
    """Xception-65 trunk at ``config.output_stride`` on preprocessed
    (B, 3, H, W) input -> (B, 2048, h/os, w/os); with a decoder, the pair
    of that and the stride-4 endpoint (B, 256, h/4, w/4)."""
    cd = layers.as_dtype(compute_dtype)
    x = _conv_bn(params, _p("entry_flow/conv1_1"), x, stride=2,
                 padding=_FIXED_PAD_3X3, cd=cd, relu=True)
    x = _conv_bn(params, _p("entry_flow/conv1_2"), x, cd=cd, relu=True)

    keep = config.decoder_output_stride is not None
    end_point = None
    for scope, chans, stride, rate, res in xception_blocks(config):
        base = _p(scope) + "/xception_module"
        relu_after = config.exit_relu_in_separable_conv \
            and scope == _EXIT_BLOCK2
        inp = x
        for i in range(len(chans)):
            s = stride if i == len(chans) - 1 else 1
            x = _sep_conv(params, base + "/separable_conv%d" % (i + 1), x,
                          stride=s, rate=rate, cd=cd, relu_after=relu_after)
            if keep and (scope, i + 1) == _DECODER_END_POINT:
                end_point = x
        if res == "conv":
            x = x + _conv_bn(params, base + "/shortcut", inp, stride=stride,
                             cd=cd)
        elif res == "sum":
            x = x + inp
    return (x, end_point) if keep else x


def _aspp(params: Params, feat, config: TeacherConfig, cd):
    """Image pooling, the 1x1 and the three separable atrous branches,
    concatenated and projected: (B, 256, h, w) after its ReLU."""
    pooled = spatial.mean(spatial.apply(feat, lambda t: t.float()), (2, 3),
                          keepdim=True)
    pooled = _conv_bn(params, "image_pooling", pooled, cd=cd,
                      eps=HEAD_BN_EPS, relu=True)

    branches = [_conv_bn(params, "aspp0", feat, cd=cd, eps=HEAD_BN_EPS,
                         relu=True)]
    for i, rate in enumerate(aspp_rates(config), start=1):
        branches.append(_sep_conv(params, "aspp%d" % i, feat, rate=rate,
                                  cd=cd, relu_after=True, eps=HEAD_BN_EPS))
    pooled = spatial.broadcast(pooled.to(branches[0].dtype), branches[0])

    x = spatial.cat_channels([pooled] + branches)
    return _conv_bn(params, "concat_projection", x, cd=cd, eps=HEAD_BN_EPS,
                    relu=True)


def deeplab_decoder(params: Params, x: torch.Tensor, end_point: torch.Tensor,
                    *, compute_dtype=torch.float32) -> torch.Tensor:
    """DeepLab's ``refine_by_decoder`` at output stride 4: the endpoint
    projected to 48 channels (1x1, BN, ReLU), the ASPP's output ``x``
    resized bilinear align-corners to the endpoint's size, the two
    concatenated as [ASPP 256, projection 48], then ``decoder_conv0`` and
    ``decoder_conv1``, each a split separable convolution (3x3 depthwise,
    BN, ReLU, 1x1 to 256, BN, ReLU) -> (B, 256, h/4, w/4)."""
    cd = layers.as_dtype(compute_dtype)
    proj = _conv_bn(params, "decoder/feature_projection0", end_point, cd=cd,
                    eps=HEAD_BN_EPS, relu=True)
    x = resize_nchw(x, proj.shape[2:])
    x = torch.cat([x, proj.to(x.dtype)], dim=1)
    for i in range(2):
        x = _sep_conv(params, "decoder/decoder_conv%d" % i, x, cd=cd,
                      relu_after=True, eps=HEAD_BN_EPS)
    return x


def teacher_logits_nchw(params: Params, frames: torch.Tensor, *,
                        compute_dtype=torch.float32,
                        out_hw="input",
                        config: TeacherConfig = TEACHER_OS16
                        ) -> torch.Tensor:
    """``teacher_logits`` channels-first: (B, C, H, W) float32 logits, or
    with ``out_hw=None`` the (B, C, gh, gw) grid in the compute type (in
    bfloat16 channels-last in memory, as the last convolution leaves
    it): at stride 4 with a decoder, else at ``config.output_stride``."""
    if isinstance(frames, spatial.WidthShards) and config != TEACHER_OS16:
        raise ValueError("width shards run the AMS teacher alone (output "
                         "stride 16, no decoder), not %r" % (config,))
    h, w = frames.shape[1], frames.shape[2]
    cd = layers.as_dtype(compute_dtype)
    to_nchw = (lambda f: f.permute(0, 3, 1, 2).float()
               * _two_over_255(f.device) - 1.0)
    x = frames.map(to_nchw, dim=3) \
        if isinstance(frames, spatial.WidthShards) else to_nchw(frames)
    with GLOBAL_TIMER.span("teacher/trunk"):
        feat = xception_backbone(params, x, compute_dtype=cd, config=config)
    if config.decoder_output_stride is not None:
        feat, end_point = feat
    with GLOBAL_TIMER.span("teacher/aspp"):
        x = _aspp(params, feat, config, cd)
    if config.decoder_output_stride is not None:
        with GLOBAL_TIMER.span("teacher/decoder"):
            x = deeplab_decoder(params, x, end_point, compute_dtype=cd)
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
                   compute_dtype=torch.float32, out_hw="input",
                   config: TeacherConfig = TEACHER_OS16) -> torch.Tensor:
    """Raw frames (B, H, W, 3) in [0, 255], already +1-padded by the
    caller -> per-pixel logits (B, H, W, C) float32, upsampled
    align-corners from the grid (``teacher_logits_nchw``) to ``out_hw``
    (default the input's size); ``out_hw=None`` returns the grid logits
    (B, gh, gw, C) in the compute type."""
    return teacher_logits_nchw(params, frames, compute_dtype=compute_dtype,
                               out_hw=out_hw, config=config
                               ).permute(0, 2, 3, 1)


def teacher_predict_fast(params: Params, frames: torch.Tensor, *,
                         config: TeacherConfig = TEACHER_OS16
                         ) -> torch.Tensor:
    """Fast labeling, the labeler's hot path: the bfloat16 forward's grid
    (the decoder's stride-4 logits where there is one) goes as it is
    (bf16, channels-last) to the fused upsample+argmax kernel, which never
    materialises full-resolution logits.  Returns (B, H, W) int32 ids."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = teacher_logits_nchw(params, frames, compute_dtype=torch.bfloat16,
                               out_hw=None, config=config)
    return fused_resize_argmax(grid, (h, w))


def teacher_predictions(params: Params, frames: torch.Tensor, *,
                        compute_dtype=torch.float32,
                        config: TeacherConfig = TEACHER_OS16
                        ) -> torch.Tensor:
    """``teacher_outputs(...)["predictions"]`` alone: the argmax of the
    full-resolution logits, (B, H, W) int32."""
    logits = teacher_logits_nchw(params, frames, compute_dtype=compute_dtype,
                                 config=config)
    return torch.argmax(logits, dim=1).to(torch.int32)


def teacher_outputs(params: Params, frames: torch.Tensor,
                    class_indices=None, *, compute_dtype=torch.float32,
                    small_hw: Tuple[int, int] = (256, 512),
                    config: TeacherConfig = TEACHER_OS16
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
    logits = teacher_logits_nchw(params, frames, compute_dtype=compute_dtype,
                                 config=config)
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

