"""Plain float32 reference of the AMS student: MobileNetV2 (depth 1.0) with
a DeepLabV3 head (1x1 ASPP branch and image pooling, 256 channels) at
output stride 16, as the TF DeepLab model zoo's
``mobilenetv2_coco_cityscapes_trainfine`` graph computes it.

- Input: frames (B, H, W, 3) in [0, 255], padded by one row at the bottom
  and one column at the right with 127.5, then ``x * 2/255 - 1``.
- Trunk: a 3x3 stride-2 stem of 32 channels, then 17 inverted-residual
  blocks (``BLOCKS``): 1x1 expansion, 3x3 depthwise, 1x1 projection, each
  with batch norm (eps 1e-3), ReLU6 after the first two, a residual add
  where the stride is 1 and the width unchanged.  Output stride 16: the
  last three blocks dilate their depthwise convolution by 2.
- Head: the image's mean -> 1x1 conv -> BN -> ReLU, broadcast; a 1x1
  conv -> BN -> ReLU; both concatenated -> 1x1 conv -> BN -> ReLU ->
  1x1 logits with a bias; the head's BN eps is 1.001e-5.
- Logits resize align-corners to the padded input's size less the pad.

Training follows the AMS server's round: batch-statistics BN whose moving
averages take the Bessel-corrected batch variance (decay 0.9), the
class-reduced masked cross-entropy, TF1 Adam (epsilon outside the bias
correction), and the ``coord_desc_auto`` selection: after one full step,
the top ``frac`` of |delta| over all trainables (sorted names, linear
quantile, strict ``>``) keeps its step and the rest reverts; later steps
move only those coordinates, while Adam's slots and the BN averages move
every step.

Weights are a flat dict of TF names and TF shapes.  Imports nothing of the
program.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import (
    bn_infer,
    calibrate_bn,
    bn_train,
    conv,
    depthwise,
    resize_ac,
)

# (expansion, out channels, depthwise stride, atrous rate)
BLOCKS = [
    (0, 16, 1, 1), (6, 24, 2, 1), (6, 24, 1, 1), (6, 32, 2, 1),
    (6, 32, 1, 1), (6, 32, 1, 1), (6, 64, 2, 1), (6, 64, 1, 1),
    (6, 64, 1, 1), (6, 64, 1, 1), (6, 96, 1, 1), (6, 96, 1, 1),
    (6, 96, 1, 1), (6, 160, 1, 1), (6, 160, 1, 2), (6, 160, 1, 2),
    (6, 320, 1, 2),
]
STEM = 32
ASPP = 256
BN_EPS = 1e-3
HEAD_BN_EPS = 1.001e-5
BN_DECAY = 0.9
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def block(i: int) -> str:
    return "MobilenetV2/expanded_conv" + ("" if i == 0 else "_%d" % i)


def param_specs(num_classes: int = 19):
    """[(name, TF shape, fan-in)] of every variable; fan-in is None for
    the BN variables and the bias."""
    specs = []

    def bn(prefix, c):
        for k in ("gamma", "beta", "moving_mean", "moving_variance"):
            specs.append(("%s/BatchNorm/%s" % (prefix, k), (c,), None))

    def cv(prefix, kh, kw, cin, cout):
        specs.append((prefix + "/weights", (kh, kw, cin, cout), kh * kw * cin))
        bn(prefix, cout)

    def dw(prefix, c):
        specs.append((prefix + "/depthwise_weights", (3, 3, c, 1), 9))
        bn(prefix, c)

    cv("MobilenetV2/Conv", 3, 3, 3, STEM)
    cin = STEM
    for i, (exp, cout, _, _) in enumerate(BLOCKS):
        mid = cin * exp if exp else cin
        if exp:
            cv(block(i) + "/expand", 1, 1, cin, mid)
        dw(block(i) + "/depthwise", mid)
        cv(block(i) + "/project", 1, 1, mid, cout)
        cin = cout
    cv("aspp0", 1, 1, cin, ASPP)
    cv("image_pooling", 1, 1, cin, ASPP)
    cv("concat_projection", 1, 1, 2 * ASPP, ASPP)
    specs.append(("logits/semantic/weights", (1, 1, ASPP, num_classes), ASPP))
    specs.append(("logits/semantic/biases", (num_classes,), None))
    return specs


def trainable(name: str) -> bool:
    return "moving_" not in name


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    """Integer frames go to float32; floating frames keep their type."""
    dtype = frames.dtype if frames.is_floating_point() else torch.float32
    x = frames.to(dtype).permute(0, 3, 1, 2)
    x = torch.nn.functional.pad(x, (0, 1, 0, 1), value=127.5)
    return x * (2.0 / 255.0) - 1.0


class _BN:
    """How the forward's batch norms run: "infer" (moving statistics),
    "train" (batch statistics; their moments go into ``stats``) or
    "calibrate" (each moving statistic set to its input's batch moments
    first, then used)."""

    def __init__(self, params, mode, stats=None):
        self.p, self.mode, self.stats = params, mode, stats

    def __call__(self, prefix, x, eps=BN_EPS):
        p = self.p
        g, b = p[prefix + "/BatchNorm/gamma"], p[prefix + "/BatchNorm/beta"]
        mk, vk = prefix + "/BatchNorm/moving_mean", \
            prefix + "/BatchNorm/moving_variance"
        if self.mode == "train":
            y, mean, var = bn_train(x, g, b, eps)
            if self.stats is not None:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                self.stats[mk] = mean.detach()
                self.stats[vk] = (var * (n / max(n - 1, 1))).detach()
            return y
        if self.mode == "calibrate":
            calibrate_bn(p[mk], p[vk], x)
        return bn_infer(x, g, b, p[mk], p[vk], eps)


def grid_logits(params, frames, *, bn_mode="infer", stats=None,
                rounding=None) -> torch.Tensor:
    """(B, H, W, 3) frames -> (B, num_classes, gh, gw) float32 logits."""
    bn = _BN(params, bn_mode, stats)
    r = rounding
    x = conv(preprocess(frames), params["MobilenetV2/Conv/weights"],
             stride=2, rounding=r)
    x = torch.clamp(bn("MobilenetV2/Conv", x), 0.0, 6.0)
    cin = STEM
    for i, (exp, cout, stride, rate) in enumerate(BLOCKS):
        name, inp = block(i), x
        if exp:
            x = conv(x, params[name + "/expand/weights"], rounding=r)
            x = torch.clamp(bn(name + "/expand", x), 0.0, 6.0)
        x = depthwise(x, params[name + "/depthwise/depthwise_weights"],
                      stride=stride, rate=rate, rounding=r)
        x = torch.clamp(bn(name + "/depthwise", x), 0.0, 6.0)
        x = bn(name + "/project",
               conv(x, params[name + "/project/weights"], rounding=r))
        if stride == 1 and cin == cout:
            x = x + inp
        cin = cout
    pooled = x.mean(dim=(2, 3), keepdim=True)
    pooled = conv(pooled, params["image_pooling/weights"], rounding=r)
    pooled = torch.relu(bn("image_pooling", pooled, HEAD_BN_EPS))
    aspp = conv(x, params["aspp0/weights"], rounding=r)
    aspp = torch.relu(bn("aspp0", aspp, HEAD_BN_EPS))
    y = torch.cat([pooled.expand(-1, -1, x.shape[2], x.shape[3]), aspp], 1)
    y = conv(y, params["concat_projection/weights"], rounding=r)
    y = torch.relu(bn("concat_projection", y, HEAD_BN_EPS))
    y = conv(y, params["logits/semantic/weights"], rounding=r)
    return y + params["logits/semantic/biases"][:, None, None]


def logits(params, frames, classes, *, rounding=None) -> torch.Tensor:
    """Inference: (B, len(classes), H, W) float32 logits of the listed
    classes at the frames' size."""
    grid = grid_logits(params, frames, rounding=rounding)
    idx = torch.as_tensor(classes, device=grid.device)
    return resize_ac(grid.index_select(1, idx), frames.shape[1:3])


def distill_loss(params, frames, labels, union, class_mask, *,
                 stats=None, rounding=None) -> torch.Tensor:
    """The round's loss on one minibatch: CE over the union's classes, a
    class outside ``class_mask`` given -1e9 logits and no label weight;
    the mean over the pixels whose label is one of the live classes."""
    grid = grid_logits(params, frames, bn_mode="train", stats=stats,
                       rounding=rounding)
    idx = torch.as_tensor(union, device=grid.device)
    full = resize_ac(grid.index_select(1, idx), labels.shape[1:3])
    live = class_mask.to(full.device) > 0
    full = torch.where(live[None, :, None, None], full,
                       torch.full_like(full, -1e9))
    lab = labels.long()
    onehot = (lab[:, None] == idx[None, :, None, None]).float() \
        * live[None, :, None, None].float()
    valid = onehot.sum(dim=1) > 0
    pixel = -(onehot * torch.log_softmax(full, dim=1)).sum(dim=1)
    return (pixel * valid).sum() / valid.sum().clamp(min=1)


def adam(params, grads, m, v, step, lr):
    """TF1 Adam on every key of ``grads`` at step ``step`` (1-based) ->
    (stepped params, m, v).  The step size is worked out in float32, as
    TF1 does in the variables' type."""
    dev = next(iter(grads.values())).device
    t = torch.tensor(float(step), dtype=torch.float32, device=dev)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev) \
        * torch.sqrt(1.0 - ADAM_B2 ** t) / (1.0 - ADAM_B1 ** t)
    out, m2, v2 = {}, {}, {}
    for k, g in grads.items():
        m2[k] = ADAM_B1 * m[k] + (1.0 - ADAM_B1) * g
        v2[k] = ADAM_B2 * v[k] + (1.0 - ADAM_B2) * g * g
        out[k] = params[k] - lr_t * m2[k] / (torch.sqrt(v2[k]) + ADAM_EPS)
    return out, m2, v2


def train_steps(params0, frames_buf, labels_buf, draws, *, union,
                class_mask, lr, frac, roundings):
    """The round's first ``len(draws)`` steps for one student from
    ``params0`` (fresh Adam slots), the first selecting.  ``draws``: one
    index tensor per step into the buffers; ``roundings``: each step's
    convolution rounding.  -> {"loss": [float], "grad1": {trainable:
    gradient of step 1}, "params": {name: value after the steps}}."""
    train = sorted(k for k in params0 if trainable(k))
    p = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(p[k]) for k in train}
    v = {k: torch.zeros_like(p[k]) for k in train}
    mask, losses, grad1 = None, [], None
    for step, (idx, rnd) in enumerate(zip(draws, roundings), start=1):
        leaves = {k: p[k].detach().requires_grad_(True) for k in train}
        merged = dict(p)
        merged.update(leaves)
        stats = {}
        with torch.enable_grad():
            loss = distill_loss(merged, frames_buf[idx], labels_buf[idx],
                                union, class_mask, stats=stats, rounding=rnd)
            g = torch.autograd.grad(loss, [leaves[k] for k in train])
        grads = dict(zip(train, g))
        if grad1 is None:
            grad1 = {k: t.detach() for k, t in grads.items()}
        before = {k: p[k] for k in train}
        stepped, m, v = adam(before, grads, m, v, step, lr)
        if mask is None:
            delta = {k: (stepped[k] - before[k]).abs() for k in train}
            flat = torch.cat([delta[k].reshape(-1) for k in train])
            thr = torch.quantile(flat, 1.0 - frac, interpolation="linear")
            mask = {k: delta[k] > thr for k in train}
        for k in train:
            p[k] = torch.where(mask[k], stepped[k], before[k]).detach()
        for k, s in stats.items():
            p[k] = p[k] - (p[k] - s) * (1.0 - BN_DECAY)
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad1": grad1, "params": p}


def calibrate(params, frames) -> None:
    """Set every moving statistic, in place, to the batch moments of its
    input on ``frames``, layer after layer: seeded weights then give
    activations of a trained network's scale."""
    with torch.no_grad():
        grid_logits(params, frames, bn_mode="calibrate")
