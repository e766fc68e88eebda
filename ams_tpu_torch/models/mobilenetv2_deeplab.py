"""DeeplabV3 + MobileNetV2 student network, inference mode, in PyTorch.

Counterpart of ``ams_tpu/models/mobilenetv2_deeplab.py``, which documents
the architecture against the reference's TF1 meta graph: +1 pad with
127.5 and ``x*2/255-1``; MobileNetV2 at output stride 16 (atrous rate 2 in
blocks 14-16); ASPP 1x1 + image pooling, concat projection, 1x1 logits;
align-corners bilinear resize to the pre-pad frame size.

Parameters are a flat dict keyed by the exact TF variable names, holding
tensors in TF shapes (see ``layers``).  Public functions take frames as
``(B, H, W, 3)`` and return channels-last logits or ``(B, H, W)`` ids like
the JAX package; the internals run channels-first.

Only inference mode (moving statistics) is here: training-mode batch norm
belongs to the training slice of the port.
"""

from __future__ import annotations

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


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, 3, H+1, W+1) f32 in [-1, 1]:
    pad +1 bottom row and right column with 127.5, then ``x*2/255-1``."""
    x = frames.float().permute(0, 3, 1, 2)
    x = torch.nn.functional.pad(x, (0, 1, 0, 1), value=127.5)
    two_over_255 = torch.tensor(2.0 / 255.0, dtype=torch.float32,
                                device=x.device)
    return x * two_over_255 - 1.0


def _bn(params, prefix, x, eps=layers.BN_EPS):
    return layers.batch_norm_infer(
        x, params[prefix + "/BatchNorm/gamma"],
        params[prefix + "/BatchNorm/beta"],
        params[prefix + "/BatchNorm/moving_mean"],
        params[prefix + "/BatchNorm/moving_variance"], eps=eps)


def backbone(params: Params, x: torch.Tensor) -> torch.Tensor:
    """MobileNetV2 trunk on preprocessed (B, 3, H, W) input; returns
    (B, 320, ceil(H/16), ceil(W/16))."""
    x = layers.conv2d(x, params["MobilenetV2/Conv/weights"], stride=2)
    x = layers.relu6(_bn(params, "MobilenetV2/Conv", x))
    cin = STEM_CHANNELS
    for i, (exp, cout, stride, rate) in enumerate(_BLOCKS):
        name = block_name(i)
        inp = x
        if exp:
            x = layers.conv2d(x, params[name + "/expand/weights"])
            x = layers.relu6(_bn(params, name + "/expand", x))
        x = layers.depthwise_conv2d(
            x, params[name + "/depthwise/depthwise_weights"],
            stride=stride, rate=rate)
        x = layers.relu6(_bn(params, name + "/depthwise", x))
        x = layers.conv2d(x, params[name + "/project/weights"])
        x = _bn(params, name + "/project", x)
        if stride == 1 and cin == cout:
            x = x + inp
        cin = cout
    return x


def deeplab_head(params: Params, feat: torch.Tensor,
                 out_hw: Optional[Tuple[int, int]]) -> torch.Tensor:
    """ASPP (1x1 + image pooling) -> projection -> per-class logits, all
    (B, C, h, w); resized to ``out_hw`` unless it is None (grid logits)."""
    b, _, fh, fw = feat.shape
    pooled = feat.float().mean(dim=(2, 3), keepdim=True)
    pooled = layers.conv2d(pooled, params["image_pooling/weights"])
    pooled = torch.relu(_bn(params, "image_pooling", pooled, eps=HEAD_BN_EPS))
    pooled = pooled.expand(b, pooled.shape[1], fh, fw)

    aspp = layers.conv2d(feat, params["aspp0/weights"])
    aspp = torch.relu(_bn(params, "aspp0", aspp, eps=HEAD_BN_EPS))

    x = torch.cat([pooled, aspp], dim=1)
    x = layers.conv2d(x, params["concat_projection/weights"])
    x = torch.relu(_bn(params, "concat_projection", x, eps=HEAD_BN_EPS))

    x = layers.conv2d(x, params["logits/semantic/weights"])
    x = x + params["logits/semantic/biases"][:, None, None]
    if out_hw is None:
        return x
    return resize_nchw(x, out_hw)


def grid_logits_nchw(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) frames -> (B, num_classes, gh, gw) grid logits."""
    return deeplab_head(params, backbone(params, preprocess(frames)), None)


def student_grid_logits(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Forward stopping at the feature-grid logits: (B, gh, gw, C)."""
    return grid_logits_nchw(params, frames).permute(0, 2, 3, 1)


def student_logits(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """Raw frames -> per-pixel class logits (B, H, W, num_classes) f32."""
    h, w = frames.shape[1], frames.shape[2]
    feat = backbone(params, preprocess(frames))
    return deeplab_head(params, feat, (h, w)).permute(0, 2, 3, 1)


def _class_index(class_indices, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(class_indices), dtype=torch.long,
                           device=device)


def student_predict_fast(params: Params, frames: torch.Tensor,
                         class_indices) -> torch.Tensor:
    """Client inference: grid logits, gathered to the class subset, then
    the fused upsample+argmax kernel; never materialises the
    full-resolution logits.  Returns (B, H, W) int32 reduced ids."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = grid_logits_nchw(params, frames)
    grid = grid.index_select(1, _class_index(class_indices, grid.device))
    return fused_resize_argmax(grid.contiguous(), (h, w))


def student_forward(params: Params, frames: torch.Tensor, class_indices
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits gathered to the experiment's class subset (B, H, W, n_sel)
    and their argmax (B, H, W) int32, ids in the REDUCED space."""
    logits = student_logits(params, frames)
    reduced = logits.index_select(3, _class_index(class_indices,
                                                  logits.device))
    preds = torch.argmax(reduced, dim=-1).to(torch.int32)
    return reduced, preds
