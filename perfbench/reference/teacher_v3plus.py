"""Plain float32 reference of DeepLabV3+ with TF-slim's ``xception_65``
(arXiv:1802.02611, arXiv:1610.02357), inference only, as the DeepLab
model zoo evaluates its Cityscapes checkpoint
``xception65_cityscapes_trainfine``: output stride 8 (or 16, an
argument), the decoder at output stride 4.  The equations follow
research/deeplab/core/xception.py (``xception_65``,
``stack_blocks_dense``) and research/deeplab/model.py
(``refine_by_decoder``, ``split_separable_conv2d``) of tensorflow/models.

- Input: frames (B, H, W, 3) in [0, 255] that the caller has already
  padded (AMS pads one row on top and one column at the left,
  symmetrically: at 1024x2048 that gives the zoo's eval crop, 1025x2049),
  ``x * 2/255 - 1``.
- Root: 3x3 stride-2 conv (32), 3x3 conv (64), each BN + ReLU.
- Units of three separable convolutions (ReLU -> 3x3 depthwise -> BN ->
  1x1 pointwise -> BN), the last of a unit carrying its stride, with a
  1x1 conv + BN shortcut ("conv"), an identity ("sum") or none.  Slim's
  stride-2 3x3 convolutions pad one on every side; all others pad as TF's
  "SAME".  ``exit_flow/block2`` has ``activation_fn_in_separable_conv``:
  depthwise -> BN -> ReLU -> pointwise -> BN -> ReLU, no ReLU before.
- Strides (``stack_blocks_dense``, the root's 2 counted): entry flow
  blocks of stride 2, 16 middle-flow units, exit flow (728, 1024, 1024)
  of stride 2 with a shortcut and (1536, 1536, 2048) without one.  Once
  the output stride is reached, every further unit runs at stride 1 and
  dilates by the strides skipped so far: at 8, ``entry_flow/block3`` at
  stride 1, the middle flow and ``exit_flow/block1`` at rate 2,
  ``exit_flow/block2`` at rate 4.
- ASPP: 1x1 conv, three separable branches at rates 6, 12 and 18 times
  16 / output stride (depthwise -> BN -> ReLU -> pointwise -> BN ->
  ReLU), the image pooling branch (the global mean, a 1x1 conv, BN,
  ReLU, broadcast); the five concatenated -> 1x1 conv -> BN -> ReLU.
- Decoder: the endpoint
  ``entry_flow/block2/unit_1/xception_module/separable_conv2_pointwise``
  (its BN's output, stride 4) -> 1x1 conv to 48 -> BN -> ReLU; the ASPP's
  output resized bilinear align-corners to the endpoint's size;
  concatenated [ASPP, projection]; ``decoder_conv0`` and
  ``decoder_conv1``, each depthwise 3x3 -> BN -> ReLU -> 1x1 to 256 -> BN
  -> ReLU.  Then 1x1 logits + bias, at stride 4.
- BN eps: the trunk's 1e-3; the head's and the decoder's 1.001e-5
  (DeepLab asks 1e-5, which TF's fused batch norm raises to 1.001e-5).
- Logits resize align-corners to the input's size.

Departures from DeepLab: the +1 pad is the caller's; the image pooling
branch is a global mean, which is what DeepLab's pooling computes when
its crop is the frame (as at eval); the decoder resizes to the endpoint's
size, which is DeepLab's ``scale_dimension(crop, 1/4)`` at every size.

Imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import (
    bn_infer,
    calibrate_bn,
    conv,
    depthwise,
    resize_ac,
)

ASPP = 256
ASPP_RATES_OS16 = (6, 12, 18)
DECODER = 256
PROJECTION = 48
BN_EPS = 1e-3
HEAD_BN_EPS = 1.001e-5
FIXED_PAD = ((1, 1), (1, 1))
# (scope, channels of the three separable convolutions, stride, shortcut)
BLOCKS = (
    [("entry_flow/block1/unit_1", (128, 128, 128), 2, "conv"),
     ("entry_flow/block2/unit_1", (256, 256, 256), 2, "conv"),
     ("entry_flow/block3/unit_1", (728, 728, 728), 2, "conv")]
    + [("middle_flow/block1/unit_%d" % (i + 1), (728, 728, 728), 1, "sum")
       for i in range(16)]
    + [("exit_flow/block1/unit_1", (728, 1024, 1024), 2, "conv"),
       ("exit_flow/block2/unit_1", (1536, 1536, 2048), 1, "none")])
RELU_AFTER = "exit_flow/block2/unit_1"
END_POINT = "entry_flow/block2/unit_1/xception_module/separable_conv2"


def _x(scope: str) -> str:
    return "xception_65/" + scope


def units(output_stride: int = 8):
    """[(scope, channels, stride, rate, shortcut)] as ``stack_blocks_dense``
    runs ``BLOCKS`` at ``output_stride``."""
    target, current, rate, out = output_stride // 2, 1, 1, []
    for scope, chans, stride, short in BLOCKS:
        if current == target:
            out.append((scope, chans, 1, rate, short))
            rate *= stride
        else:
            out.append((scope, chans, stride, 1, short))
            current *= stride
    return out


def param_specs(num_classes: int = 19):
    """[(name, TF shape, fan-in)] of every variable (fan-in None for BN
    variables and the bias); the same at either output stride."""
    specs = []

    def bn(prefix, c):
        for k in ("gamma", "beta", "moving_mean", "moving_variance"):
            specs.append(("%s/BatchNorm/%s" % (prefix, k), (c,), None))

    def cv(prefix, kh, kw, cin, cout):
        specs.append((prefix + "/weights", (kh, kw, cin, cout), kh * kw * cin))
        bn(prefix, cout)

    def sep(prefix, cin, cout):
        specs.append((prefix + "_depthwise/depthwise_weights", (3, 3, cin, 1),
                      9))
        bn(prefix + "_depthwise", cin)
        cv(prefix + "_pointwise", 1, 1, cin, cout)

    cv(_x("entry_flow/conv1_1"), 3, 3, 3, 32)
    cv(_x("entry_flow/conv1_2"), 3, 3, 32, 64)
    cin = 64
    for scope, chans, _, short in BLOCKS:
        base, c = _x(scope) + "/xception_module", cin
        for i, cout in enumerate(chans):
            sep(base + "/separable_conv%d" % (i + 1), c, cout)
            c = cout
        if short == "conv":
            cv(base + "/shortcut", 1, 1, cin, chans[-1])
        cin = chans[-1]
    cv("aspp0", 1, 1, cin, ASPP)
    for i in range(1, 4):
        sep("aspp%d" % i, cin, ASPP)
    cv("image_pooling", 1, 1, cin, ASPP)
    cv("concat_projection", 1, 1, (2 + len(ASPP_RATES_OS16)) * ASPP, ASPP)
    cv("decoder/feature_projection0", 1, 1, 256, PROJECTION)
    sep("decoder/decoder_conv0", ASPP + PROJECTION, DECODER)
    sep("decoder/decoder_conv1", DECODER, DECODER)
    specs.append(("logits/semantic/weights", (1, 1, DECODER, num_classes),
                  DECODER))
    specs.append(("logits/semantic/biases", (num_classes,), None))
    return specs


def grid_logits(params, frames, *, rounding=None, calibrate=False,
                output_stride=8):
    """Padded frames (B, H, W, 3) -> (B, num_classes, gh, gw) float32 at
    stride 4.  ``calibrate``: each BN's moving statistics are set, in
    place, to its input's batch moments first."""
    p, r = params, rounding

    def bn(prefix, x, eps=BN_EPS):
        mk, vk = prefix + "/BatchNorm/moving_mean", \
            prefix + "/BatchNorm/moving_variance"
        if calibrate:
            calibrate_bn(p[mk], p[vk], x)
        return bn_infer(x, p[prefix + "/BatchNorm/gamma"],
                        p[prefix + "/BatchNorm/beta"], p[mk], p[vk], eps)

    def sep(prefix, x, stride=1, rate=1, relu_after=False, eps=BN_EPS):
        if not relu_after:
            x = torch.relu(x)
        x = depthwise(x, p[prefix + "_depthwise/depthwise_weights"],
                      stride=stride, rate=rate,
                      padding=FIXED_PAD if stride > 1 else "SAME", rounding=r)
        x = bn(prefix + "_depthwise", x, eps)
        if relu_after:
            x = torch.relu(x)
        x = bn(prefix + "_pointwise",
               conv(x, p[prefix + "_pointwise/weights"], rounding=r), eps)
        return torch.relu(x) if relu_after else x

    x = frames.to(torch.float32).permute(0, 3, 1, 2) * (2.0 / 255.0) - 1.0
    x = conv(x, p[_x("entry_flow/conv1_1/weights")], stride=2,
             padding=FIXED_PAD, rounding=r)
    x = torch.relu(bn(_x("entry_flow/conv1_1"), x))
    x = conv(x, p[_x("entry_flow/conv1_2/weights")], rounding=r)
    x = torch.relu(bn(_x("entry_flow/conv1_2"), x))
    low = None
    for scope, chans, stride, rate, short in units(output_stride):
        base, inp = _x(scope) + "/xception_module", x
        for i in range(3):
            name = base + "/separable_conv%d" % (i + 1)
            x = sep(name, x, stride=stride if i == 2 else 1, rate=rate,
                    relu_after=scope == RELU_AFTER)
            if name == _x(END_POINT):
                low = x
        if short == "conv":
            sc = conv(inp, p[base + "/shortcut/weights"], stride=stride,
                      rounding=r)
            x = x + bn(base + "/shortcut", sc)
        elif short == "sum":
            x = x + inp
    feat = x
    pooled = conv(feat.mean(dim=(2, 3), keepdim=True),
                  p["image_pooling/weights"], rounding=r)
    pooled = torch.relu(bn("image_pooling", pooled, HEAD_BN_EPS))
    branches = [torch.relu(bn("aspp0", conv(feat, p["aspp0/weights"],
                                            rounding=r), HEAD_BN_EPS))]
    for i, rate in enumerate(ASPP_RATES_OS16, start=1):
        branches.append(sep("aspp%d" % i, feat,
                            rate=rate * 16 // output_stride,
                            relu_after=True, eps=HEAD_BN_EPS))
    y = torch.cat([pooled.expand(-1, -1, feat.shape[2], feat.shape[3])]
                  + branches, 1)
    y = conv(y, p["concat_projection/weights"], rounding=r)
    y = torch.relu(bn("concat_projection", y, HEAD_BN_EPS))

    proj = conv(low, p["decoder/feature_projection0/weights"], rounding=r)
    proj = torch.relu(bn("decoder/feature_projection0", proj, HEAD_BN_EPS))
    y = torch.cat([resize_ac(y, proj.shape[2:]), proj], 1)
    for i in range(2):
        y = sep("decoder/decoder_conv%d" % i, y, relu_after=True,
                eps=HEAD_BN_EPS)
    y = conv(y, p["logits/semantic/weights"], rounding=r)
    return y + p["logits/semantic/biases"][:, None, None]


def logits(params, frames, *, rounding=None, output_stride=8
           ) -> torch.Tensor:
    """Padded frames -> (B, num_classes, H, W) float32 logits."""
    return resize_ac(grid_logits(params, frames, rounding=rounding,
                                 output_stride=output_stride),
                     frames.shape[1:3])


def calibrate(params, frames, output_stride=8) -> None:
    with torch.no_grad():
        grid_logits(params, frames, calibrate=True,
                    output_stride=output_stride)
