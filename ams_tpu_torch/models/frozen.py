"""Frozen-model deployment artifacts: BN folding, in PyTorch.

Counterpart of ``ams_tpu/models/frozen.py``.  Each inference-mode batch norm
folds into its preceding conv:

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

Folding is done on the host in numpy with the JAX package's exact
expressions, so both packages produce the same artifact bit for bit.
Folding is mathematically identical to inference-mode BN, not
bit-identical (float re-association), so a folded client's ids agree with
the unfolded client's off near-ties only.

Only the unfused forward is here; the fused MBConv variants
(``fused_blocks``) wait for the port's MBConv kernels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ams_tpu_torch.models import layers
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    _BLOCKS,
    HEAD_BN_EPS,
    STEM_CHANNELS,
    _class_index,
    block_name,
    preprocess,
)
from ams_tpu_torch.models.resize import resize_nchw

Params = Dict[str, torch.Tensor]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _fold(params, prefix, w_key, eps, depthwise=False):
    g = _host(params[prefix + "/BatchNorm/gamma"])
    b = _host(params[prefix + "/BatchNorm/beta"])
    mean = _host(params[prefix + "/BatchNorm/moving_mean"])
    var = _host(params[prefix + "/BatchNorm/moving_variance"])
    scale = g / np.sqrt(var + eps)
    w = _host(params[w_key])
    if depthwise:
        # depthwise weights (kh, kw, C, 1): scale along C
        w = w * scale[None, None, :, None]
    else:
        w = w * scale[None, None, None, :]
    bias = b - mean * scale
    return w.astype(np.float32), bias.astype(np.float32)


def fold_student(params) -> Params:
    """Student params (tensors or numpy) -> folded deployment dict (conv
    weights with '/folded_bias' companions; logits layer untouched), as
    tensors on the device of the input (the CPU for numpy input)."""
    first = next(iter(params.values()))
    dev = first.device if isinstance(first, torch.Tensor) else "cpu"
    out = {}

    def fold_conv(prefix, depthwise=False, eps=layers.BN_EPS):
        wk = prefix + ("/depthwise_weights" if depthwise else "/weights")
        out[wk], out[prefix + "/folded_bias"] = _fold(params, prefix, wk, eps,
                                                      depthwise)

    fold_conv("MobilenetV2/Conv")
    for i in range(len(_BLOCKS)):
        name = block_name(i)
        if _BLOCKS[i][0]:
            fold_conv(name + "/expand")
        fold_conv(name + "/depthwise", depthwise=True)
        fold_conv(name + "/project")
    fold_conv("aspp0", eps=HEAD_BN_EPS)
    fold_conv("image_pooling", eps=HEAD_BN_EPS)
    fold_conv("concat_projection", eps=HEAD_BN_EPS)
    out["logits/semantic/weights"] = _host(params["logits/semantic/weights"])
    out["logits/semantic/biases"] = _host(params["logits/semantic/biases"])
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in out.items()}


def is_folded(params) -> bool:
    """True when a parameter dict is a BN-folded deployment artifact."""
    return any(k.endswith("/folded_bias") for k in params)


def _grid_logits_folded_nchw(folded: Params, frames: torch.Tensor):
    """Folded forward to the (B, num_classes, gh, gw) grid logits."""
    x = preprocess(frames)

    def conv(prefix, x, stride=1, rate=1, act=None):
        y = layers.conv2d(x, folded[prefix + "/weights"], stride=stride,
                          rate=rate)
        y = y + folded[prefix + "/folded_bias"][:, None, None]
        return act(y) if act else y

    def dwconv(prefix, x, stride=1, rate=1, act=None):
        y = layers.depthwise_conv2d(x, folded[prefix + "/depthwise_weights"],
                                    stride=stride, rate=rate)
        y = y + folded[prefix + "/folded_bias"][:, None, None]
        return act(y) if act else y

    x = conv("MobilenetV2/Conv", x, stride=2, act=layers.relu6)
    cin = STEM_CHANNELS
    for i, (exp, cout, stride, rate) in enumerate(_BLOCKS):
        name = block_name(i)
        inp = x
        if exp:
            x = conv(name + "/expand", x, act=layers.relu6)
        x = dwconv(name + "/depthwise", x, stride=stride, rate=rate,
                   act=layers.relu6)
        x = conv(name + "/project", x)
        if stride == 1 and cin == cout:
            x = x + inp
        cin = cout

    b, _, fh, fw = x.shape
    pooled = x.float().mean(dim=(2, 3), keepdim=True)
    pooled = conv("image_pooling", pooled, act=torch.relu)
    pooled = pooled.expand(b, pooled.shape[1], fh, fw)
    aspp = conv("aspp0", x, act=torch.relu)
    y = torch.cat([pooled, aspp], dim=1)
    y = conv("concat_projection", y, act=torch.relu)
    y = layers.conv2d(y, folded["logits/semantic/weights"])
    return y + folded["logits/semantic/biases"][:, None, None]


def student_forward_folded(folded: Params, frames: torch.Tensor,
                           class_indices=None, *, out_hw="input"
                           ) -> torch.Tensor:
    """Forward through the folded client model (no batch-norm ops).
    Returns channels-last logits: (B, H, W, C) resized to ``out_hw``
    ("input" = the frame size), or the (B, gh, gw, C) grid for None."""
    h, w = frames.shape[1], frames.shape[2]
    y = _grid_logits_folded_nchw(folded, frames)
    if class_indices is not None:
        y = y.index_select(1, _class_index(class_indices, y.device))
    if out_hw is not None:
        y = resize_nchw(y, (h, w) if out_hw == "input" else out_hw)
    return y.permute(0, 2, 3, 1)


def student_predict_fast_folded(folded: Params, frames: torch.Tensor,
                                class_indices) -> torch.Tensor:
    """Folded client fast path: forward with no BN ops + the fused
    upsample+argmax kernel (the deployed-edge hot loop)."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = _grid_logits_folded_nchw(folded, frames)
    grid = grid.index_select(1, _class_index(class_indices, grid.device))
    return fused_resize_argmax(grid.contiguous(), (h, w))


def _scores(reduced_logits, labels, class_indices, num_classes):
    """Shared front of the folded metric paths: (preds, reduced labels,
    weights, filtered one-hot, log-softmax)."""
    from ams_tpu_torch.distill.loss import reduce_labels

    preds = torch.argmax(reduced_logits, dim=-1).to(torch.int32)
    red_labels, weights, filtered_onehot = reduce_labels(
        labels, class_indices, num_classes)
    logp = torch.log_softmax(reduced_logits, dim=-1)
    return preds, red_labels, weights, filtered_onehot, logp


def make_predict_fn_folded(num_classes, class_indices):
    """Folded-client inference with metrics: predict(folded, frames,
    labels) -> (preds (B,H,W), confusion matrix (C,C), loss)."""
    from ams_tpu_torch.utils.metrics import confusion_matrix

    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict(folded, frames, labels):
        reduced_logits = student_forward_folded(folded, frames,
                                                class_indices=class_indices)
        preds, red_labels, weights, filtered_onehot, logp = _scores(
            reduced_logits, labels, class_indices, num_classes)
        cm = confusion_matrix(red_labels, preds, n_sel, weights)
        pixel_loss = -torch.sum(filtered_onehot * logp, dim=-1)
        wsum = torch.clamp(torch.sum(weights), min=1.0)
        loss = torch.sum(pixel_loss * weights) / wsum
        return preds, cm, loss

    return predict


def make_predict_seq_fn_folded(num_classes, class_indices):
    """Per-frame metrics over a frame batch: predict_seq(folded, frames,
    labels) -> (preds (B,H,W), confusion matrices (B,C,C), losses (B,))."""
    from ams_tpu_torch.utils.metrics import confusion_matrix_per_frame

    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict_seq(folded, frames, labels):
        reduced_logits = student_forward_folded(folded, frames,
                                                class_indices=class_indices)
        preds, red_labels, weights, filtered_onehot, logp = _scores(
            reduced_logits, labels, class_indices, num_classes)
        cm_f = confusion_matrix_per_frame(red_labels, preds, n_sel, weights)
        # the same CE expression as make_predict_fn_folded, per frame
        pixel_loss = -torch.sum(filtered_onehot * logp, dim=-1)
        wsum_f = torch.clamp(torch.sum(weights, dim=(1, 2)), min=1.0)
        loss_f = torch.sum(pixel_loss * weights, dim=(1, 2)) / wsum_f
        return preds, cm_f, loss_f

    return predict_seq
