"""Frozen-model deployment artifacts: BN folding, in PyTorch.

Counterpart of ``ams_tpu/models/frozen.py``.  Each inference-mode batch norm
folds into its preceding conv:

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = beta - mean * gamma / sqrt(var + eps)

The student folds on the host, in float32 with the JAX package's exact
expressions (``fold_bn``), so both packages produce the same artifact bit
for bit; ``xception_deeplab.fold_teacher`` folds the teacher with the same
``fold_bn`` on its params' device.
Folding is mathematically identical to inference-mode BN, not
bit-identical (float re-association), so a folded client's ids agree with
the unfolded client's off near-ties only.

The folded forward runs in float32 (the default) or, with
``compute_dtype=bfloat16``, in bf16 storage with f32 accumulation; the
preprocessing and the image pooling's mean stay f32, as in JAX.  In bf16,
``fused_blocks`` routes inverted-residual blocks through the port's fused
MBConv kernel (``ops.fused_mbconv``, ``ops.fused_mbconv_banded``), so the
6x-expanded mid tensor never reaches device memory:

- ``True``: every run of consecutive stride-1 blocks is one fused stage
  (the counterpart of JAX's K3).  JAX runs a stage unfused when its VMEM
  estimate fails (``stage_fits_vmem``); on the card every stage fits a
  shared-memory tile, so the port fuses all of them (ROADMAP §C);
- ``"banded"``: each block whose input area is at least ``banded_min_hw``
  and whose geometry ``banded_supported`` accepts runs fused (JAX's K4),
  stride 2 included; the others run unfused, as in JAX.
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


def fold_bn(params, prefix, w_key, eps, depthwise=False):
    """The inference BN ``<prefix>/BatchNorm/*`` folded into the weight
    ``w_key`` -> (W * scale, beta - mean * scale), float32 on the params'
    device, with scale = gamma / sqrt(var + eps) per output channel: along
    Cout of a (kh, kw, Cin, Cout) weight, along C of a depthwise
    (kh, kw, C, 1) one.  The JAX package's expressions, in its order, so
    the result is its numpy fold's to the bit: each step rounded once to
    float32, the square root too (taken in float64, whose rounding to
    float32 is the correctly rounded float32 root, as numpy's is; torch's
    float32 root on the CPU is not always)."""
    def f32(key):
        return torch.as_tensor(params[key]).float()

    bn = prefix + "/BatchNorm/"
    root = torch.sqrt((f32(bn + "moving_variance") + eps).double()).float()
    scale = f32(bn + "gamma") / root
    w = f32(w_key) * (scale[:, None] if depthwise else scale)
    return w, f32(bn + "beta") - f32(bn + "moving_mean") * scale


def fold_student(params) -> Params:
    """Student params (tensors or numpy) -> folded deployment dict (conv
    weights with '/folded_bias' companions; logits layer untouched), as
    tensors on the device of the input (the CPU for numpy input)."""
    first = next(iter(params.values()))
    dev = first.device if isinstance(first, torch.Tensor) else "cpu"
    host = {k: torch.tensor(_host(v)) for k, v in params.items()}
    out = {}

    def fold_conv(prefix, depthwise=False, eps=layers.BN_EPS):
        wk = prefix + ("/depthwise_weights" if depthwise else "/weights")
        out[wk], out[prefix + "/folded_bias"] = fold_bn(host, prefix, wk,
                                                        eps, depthwise)

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
    out["logits/semantic/weights"] = host["logits/semantic/weights"]
    out["logits/semantic/biases"] = host["logits/semantic/biases"]
    return {k: v.to(dev) for k, v in out.items()}


def is_folded(params) -> bool:
    """True when a parameter dict is a BN-folded deployment artifact."""
    return any(k.endswith("/folded_bias") for k in params)


def _grid_logits_folded_nchw(folded: Params, frames: torch.Tensor,
                             compute_dtype=torch.float32, fused_blocks=False,
                             banded_min_hw=96 * 96):
    """Folded forward to the (B, num_classes, gh, gw) grid logits, in the
    compute type."""
    cd = layers.as_dtype(compute_dtype)
    if fused_blocks not in (False, True, "banded"):
        raise ValueError("fused_blocks must be False, True or 'banded', got "
                         "%r" % (fused_blocks,))
    if fused_blocks and cd != torch.bfloat16:
        raise ValueError("fused_blocks is the bf16 fast path; got "
                         "compute_dtype %s" % cd)
    # the preprocessing stays f32 on the bf16 path too, as in JAX
    x = preprocess(frames)

    def conv(prefix, x, stride=1, rate=1, act=None):
        y = layers.conv2d(x, folded[prefix + "/weights"], stride=stride,
                          rate=rate, compute_dtype=cd)
        y = y + folded[prefix + "/folded_bias"].to(y.dtype)[:, None, None]
        return act(y) if act else y

    def dwconv(prefix, x, stride=1, rate=1, act=None):
        y = layers.depthwise_conv2d(x, folded[prefix + "/depthwise_weights"],
                                    stride=stride, rate=rate,
                                    compute_dtype=cd)
        y = y + folded[prefix + "/folded_bias"].to(y.dtype)[:, None, None]
        return act(y) if act else y

    def unfused_block(x, name, exp, stride, rate, residual):
        inp = x
        if exp:
            x = conv(name + "/expand", x, act=layers.relu6)
        x = dwconv(name + "/depthwise", x, stride=stride, rate=rate,
                   act=layers.relu6)
        x = conv(name + "/project", x)
        return x + inp if residual else x

    if fused_blocks:
        from ams_tpu_torch.ops.fused_mbconv import fused_block, run_fused_stage
        from ams_tpu_torch.ops.fused_mbconv_banded import (
            banded_supported,
            mbconv_banded,
        )

    x = conv("MobilenetV2/Conv", x, stride=2, act=layers.relu6)
    cin = STEM_CHANNELS
    pending = []  # consecutive stride-1 blocks awaiting a fused stage
    for i, (exp, cout, stride, rate) in enumerate(_BLOCKS):
        name = block_name(i)
        residual = stride == 1 and cin == cout
        cin = cout
        if fused_blocks == "banded":
            h_in, w_in = x.shape[2], x.shape[3]
            if (h_in * w_in >= banded_min_hw
                    and banded_supported(h_in, w_in, stride, rate)):
                bl = fused_block(folded, name, bool(exp), rate, residual)
                x = mbconv_banded(x, bl.w_expand, bl.b_expand, bl.w_dw,
                                  bl.b_dw, bl.w_proj, bl.b_proj,
                                  stride=stride, residual=residual)
            else:
                x = unfused_block(x, name, exp, stride, rate, residual)
            continue
        if fused_blocks and stride == 1:
            pending.append(fused_block(folded, name, bool(exp), rate,
                                       residual))
            continue
        if pending:
            x = run_fused_stage(x, pending)
            pending = []
        x = unfused_block(x, name, exp, stride, rate, residual)
    if pending:
        x = run_fused_stage(x, pending)

    b, _, fh, fw = x.shape
    pooled = x.float().mean(dim=(2, 3), keepdim=True)
    pooled = conv("image_pooling", pooled.to(x.dtype), act=torch.relu)
    pooled = pooled.expand(b, pooled.shape[1], fh, fw)
    aspp = conv("aspp0", x, act=torch.relu)
    y = torch.cat([pooled.to(aspp.dtype), aspp], dim=1)
    y = conv("concat_projection", y, act=torch.relu)
    y = layers.conv2d(y, folded["logits/semantic/weights"], compute_dtype=cd)
    return y + folded["logits/semantic/biases"].to(y.dtype)[:, None, None]


def student_forward_folded(folded: Params, frames: torch.Tensor,
                           class_indices=None, *,
                           compute_dtype=torch.float32, out_hw="input",
                           fused_blocks=False, banded_min_hw=96 * 96
                           ) -> torch.Tensor:
    """Forward through the folded client model (no batch-norm ops).
    Returns channels-last logits: (B, H, W, C) f32 resized to ``out_hw``
    ("input" = the frame size), or the (B, gh, gw, C) grid in the compute
    type for None."""
    h, w = frames.shape[1], frames.shape[2]
    y = _grid_logits_folded_nchw(folded, frames, compute_dtype, fused_blocks,
                                 banded_min_hw)
    if class_indices is not None:
        y = y.index_select(1, _class_index(class_indices, y.device))
    if out_hw is not None:
        y = resize_nchw(y.float(), (h, w) if out_hw == "input" else out_hw)
    return y.permute(0, 2, 3, 1)


def student_predict_fast_folded(folded: Params, frames: torch.Tensor,
                                class_indices, *,
                                compute_dtype=torch.float32,
                                fused_blocks=False) -> torch.Tensor:
    """Folded client fast path: forward with no BN ops + the fused
    upsample+argmax kernel (the deployed-edge hot loop), which reads the
    grid in the compute type and layout and the class subset itself."""
    from ams_tpu_torch.ops.fused_resize_argmax import fused_resize_argmax

    h, w = frames.shape[1], frames.shape[2]
    grid = _grid_logits_folded_nchw(folded, frames, compute_dtype,
                                    fused_blocks)
    return fused_resize_argmax(grid, (h, w), class_indices)


def _scores(reduced_logits, labels, class_indices, num_classes):
    """Shared front of the folded metric paths: (preds, reduced labels,
    weights, filtered one-hot, log-softmax)."""
    from ams_tpu_torch.distill.loss import reduce_labels

    preds = torch.argmax(reduced_logits, dim=-1).to(torch.int32)
    red_labels, weights, filtered_onehot = reduce_labels(
        labels, class_indices, num_classes)
    logp = torch.log_softmax(reduced_logits, dim=-1)
    return preds, red_labels, weights, filtered_onehot, logp


def make_predict_fn_folded(num_classes, class_indices,
                           compute_dtype=torch.float32):
    """Folded-client inference with metrics: predict(folded, frames,
    labels) -> (preds (B,H,W), confusion matrix (C,C), loss)."""
    from ams_tpu_torch.utils.metrics import confusion_matrix

    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict(folded, frames, labels):
        reduced_logits = student_forward_folded(
            folded, frames, class_indices=class_indices,
            compute_dtype=compute_dtype)
        preds, red_labels, weights, filtered_onehot, logp = _scores(
            reduced_logits, labels, class_indices, num_classes)
        cm = confusion_matrix(red_labels, preds, n_sel, weights)
        pixel_loss = -torch.sum(filtered_onehot * logp, dim=-1)
        wsum = torch.clamp(torch.sum(weights), min=1.0)
        loss = torch.sum(pixel_loss * weights) / wsum
        return preds, cm, loss

    return predict


def make_predict_seq_fn_folded(num_classes, class_indices,
                               compute_dtype=torch.float32):
    """Per-frame metrics over a frame batch: predict_seq(folded, frames,
    labels) -> (preds (B,H,W), confusion matrices (B,C,C), losses (B,))."""
    from ams_tpu_torch.utils.metrics import confusion_matrix_per_frame

    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict_seq(folded, frames, labels):
        reduced_logits = student_forward_folded(
            folded, frames, class_indices=class_indices,
            compute_dtype=compute_dtype)
        preds, red_labels, weights, filtered_onehot, logp = _scores(
            reduced_logits, labels, class_indices, num_classes)
        cm_f = confusion_matrix_per_frame(red_labels, preds, n_sel, weights)
        # the same CE expression as make_predict_fn_folded, per frame
        pixel_loss = -torch.sum(filtered_onehot * logp, dim=-1)
        wsum_f = torch.clamp(torch.sum(weights, dim=(1, 2)), min=1.0)
        loss_f = torch.sum(pixel_loss * weights, dim=(1, 2)) / wsum_f
        return preds, cm_f, loss_f

    return predict_seq
