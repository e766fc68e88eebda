"""Scoring functions of the unfolded deployed client, in PyTorch.

Counterpart of ``make_predict_fn`` and ``make_predict_seq_fn`` in
``ams_tpu/distill/train_step.py`` with ``train_bn=False``: inference-mode
batch norm on the moving statistics, as the frozen client runs.
Training-mode prediction and the distillation round belong to the
training slice of the port.
"""

from __future__ import annotations

import torch

from ams_tpu_torch.distill.loss import reduce_labels
from ams_tpu_torch.models.mobilenetv2_deeplab import student_forward
from ams_tpu_torch.utils.metrics import (
    confusion_matrix,
    confusion_matrix_per_frame,
)


def _check_train_bn(train_bn):
    if train_bn:
        raise NotImplementedError(
            "training-mode batch norm (train_bn=True) belongs to the "
            "training slice of the port; the deployed client uses "
            "train_bn=False")


def softmax_xent_with_soft_labels(logits, soft_labels):
    """tf.nn.softmax_cross_entropy_with_logits semantics."""
    return -torch.sum(soft_labels * torch.log_softmax(logits, dim=-1), dim=-1)


def make_predict_fn(num_classes, class_indices, *, train_bn: bool):
    """predict(params, frames, labels) -> (preds in reduced ids, confusion
    matrix over the selected classes with invalid-label weights zeroed,
    mean CE over valid pixels)."""
    _check_train_bn(train_bn)
    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict(params, frames, labels):
        reduced_logits, preds = student_forward(params, frames,
                                                class_indices)
        red_labels, weights, filtered_onehot = reduce_labels(
            labels, class_indices, num_classes)
        cm = confusion_matrix(red_labels, preds, n_sel, weights)
        pixel_loss = softmax_xent_with_soft_labels(reduced_logits,
                                                   filtered_onehot)
        loss = torch.sum(pixel_loss * weights) / torch.clamp(
            torch.sum(weights), min=1.0)
        return preds, cm, loss

    return predict


def make_predict_seq_fn(num_classes, class_indices, *, train_bn: bool):
    """Per-frame metrics over a frame batch: predict_seq(params, frames,
    labels) -> (preds (B,H,W), confusion matrices (B,C,C), losses (B,))."""
    _check_train_bn(train_bn)
    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict_seq(params, frames, labels):
        reduced_logits, preds = student_forward(params, frames,
                                                class_indices)
        red_labels, weights, filtered_onehot = reduce_labels(
            labels, class_indices, num_classes)
        cm_f = confusion_matrix_per_frame(red_labels, preds, n_sel, weights)
        pixel_loss = softmax_xent_with_soft_labels(reduced_logits,
                                                   filtered_onehot)
        wsum_f = torch.clamp(torch.sum(weights, dim=(1, 2)), min=1.0)
        loss_f = torch.sum(pixel_loss * weights, dim=(1, 2)) / wsum_f
        return preds, cm_f, loss_f

    return predict_seq
