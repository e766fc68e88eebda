"""Plain float32 reference of the AMS teacher: DeepLabV3 with TF-slim's
``xception_65`` at output stride 16 (arXiv:1706.05587, arXiv:1610.02357),
inference only.

- Input: frames (B, H, W, 3) in [0, 255] that the caller has already
  padded (AMS pads one row on top and one column at the left,
  symmetrically), ``x * 2/255 - 1``.
- Entry flow: 3x3 stride-2 conv (32), 3x3 conv (64), each BN + ReLU; then
  units of three separable convolutions (ReLU -> 3x3 depthwise -> BN ->
  1x1 pointwise -> BN), the last of a unit carrying its stride, with a
  1x1 conv + BN shortcut ("conv"), an identity ("sum") or none.  Slim's
  stride-2 3x3 convolutions pad one on every side; all others pad as TF's
  "SAME".
- Middle flow: 16 units of 728 channels; exit flow: (728, 1024, 1024) with
  a shortcut at stride 1 (output stride 16), then (1536, 1536, 2048) at
  rate 2 without one.
- ASPP: 1x1 conv, three separable branches at rates 6, 12 and 18 (depthwise
  -> BN -> ReLU -> pointwise -> BN -> ReLU), the image pooling branch; the
  five concatenated -> 1x1 conv -> BN -> ReLU -> 1x1 logits + bias.  The
  head's BN eps is 1.001e-5, the trunk's 1e-3.
- Logits resize align-corners to the input's size.

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
ASPP_RATES = (6, 12, 18)
BN_EPS = 1e-3
HEAD_BN_EPS = 1.001e-5
FIXED_PAD = ((1, 1), (1, 1))
# (scope, channels of the three separable convolutions, stride, rate,
# shortcut)
UNITS = (
    [("entry_flow/block1/unit_1", (128, 128, 128), 2, 1, "conv"),
     ("entry_flow/block2/unit_1", (256, 256, 256), 2, 1, "conv"),
     ("entry_flow/block3/unit_1", (728, 728, 728), 2, 1, "conv")]
    + [("middle_flow/block1/unit_%d" % (i + 1), (728, 728, 728), 1, 1, "sum")
       for i in range(16)]
    + [("exit_flow/block1/unit_1", (728, 1024, 1024), 1, 1, "conv"),
       ("exit_flow/block2/unit_1", (1536, 1536, 2048), 1, 2, "none")])


def _x(scope: str) -> str:
    return "xception_65/" + scope


def param_specs(num_classes: int = 19):
    """[(name, TF shape, fan-in)] of every variable (fan-in None for BN
    variables and the bias)."""
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
    for scope, chans, _, _, short in UNITS:
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
    cv("concat_projection", 1, 1, (2 + len(ASPP_RATES)) * ASPP, ASPP)
    specs.append(("logits/semantic/weights", (1, 1, ASPP, num_classes), ASPP))
    specs.append(("logits/semantic/biases", (num_classes,), None))
    return specs


def grid_logits(params, frames, *, rounding=None, calibrate=False):
    """Padded frames (B, H, W, 3) -> (B, num_classes, gh, gw) float32.
    ``calibrate``: each BN's moving statistics are set, in place, to its
    input's batch moments first."""
    p, r = params, rounding

    def bn(prefix, x, eps=BN_EPS):
        mk, vk = prefix + "/BatchNorm/moving_mean", \
            prefix + "/BatchNorm/moving_variance"
        if calibrate:
            calibrate_bn(p[mk], p[vk], x)
        return bn_infer(x, p[prefix + "/BatchNorm/gamma"],
                        p[prefix + "/BatchNorm/beta"], p[mk], p[vk], eps)

    def sep(prefix, x, stride=1, rate=1):
        x = depthwise(torch.relu(x),
                      p[prefix + "_depthwise/depthwise_weights"],
                      stride=stride, rate=rate,
                      padding=FIXED_PAD if stride > 1 else "SAME", rounding=r)
        x = bn(prefix + "_depthwise", x)
        return bn(prefix + "_pointwise",
                  conv(x, p[prefix + "_pointwise/weights"], rounding=r))

    x = frames.to(torch.float32).permute(0, 3, 1, 2) * (2.0 / 255.0) - 1.0
    x = conv(x, p[_x("entry_flow/conv1_1/weights")], stride=2,
             padding=FIXED_PAD, rounding=r)
    x = torch.relu(bn(_x("entry_flow/conv1_1"), x))
    x = conv(x, p[_x("entry_flow/conv1_2/weights")], rounding=r)
    x = torch.relu(bn(_x("entry_flow/conv1_2"), x))
    for scope, chans, stride, rate, short in UNITS:
        base, inp = _x(scope) + "/xception_module", x
        for i in range(3):
            x = sep(base + "/separable_conv%d" % (i + 1), x,
                    stride=stride if i == 2 else 1, rate=rate)
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
    for i, rate in enumerate(ASPP_RATES, start=1):
        a = depthwise(feat, p["aspp%d_depthwise/depthwise_weights" % i],
                      rate=rate, rounding=r)
        a = torch.relu(bn("aspp%d_depthwise" % i, a, HEAD_BN_EPS))
        a = conv(a, p["aspp%d_pointwise/weights" % i], rounding=r)
        branches.append(torch.relu(bn("aspp%d_pointwise" % i, a,
                                      HEAD_BN_EPS)))
    y = torch.cat([pooled.expand(-1, -1, feat.shape[2], feat.shape[3])]
                  + branches, 1)
    y = conv(y, p["concat_projection/weights"], rounding=r)
    y = torch.relu(bn("concat_projection", y, HEAD_BN_EPS))
    y = conv(y, p["logits/semantic/weights"], rounding=r)
    return y + p["logits/semantic/biases"][:, None, None]


def logits(params, frames, *, rounding=None) -> torch.Tensor:
    """Padded frames -> (B, num_classes, H, W) float32 logits."""
    return resize_ac(grid_logits(params, frames, rounding=rounding),
                     frames.shape[1:3])


def calibrate(params, frames) -> None:
    with torch.no_grad():
        grid_logits(params, frames, calibrate=True)
