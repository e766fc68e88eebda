"""Confusion-matrix mIoU metrics, in PyTorch.

Counterpart of ``ams_tpu/utils/metrics.py``: ``confusion_matrix``, the
soft ("probability-weighted") confusion matrices of the legacy builders
(``iou_from_confusion``, ``prob_confmat``, ``prob_confmat_star``,
``soft_miou``), ``calculate_miou`` and ``string_class_iou``.  The last
two are the reference's NumPy golden implementation, copied unchanged
(NaN / string-placeholder conventions included).  The
confusion matrix is a weighted ``bincount`` over ``num_classes**2`` cells
on the tensors' device; the JAX package's one-hot matmul form is a TPU
choice (scatters serialise there) that a GPU does not need.
"""

from __future__ import annotations

import numpy as np
import torch


def _check_exact(n_pixels: int) -> None:
    # f32 accumulation is integer-exact only below 2^24 per cell; a bigger
    # single call would silently drift from the reference's float64
    # total_cm (tf.metrics.mean_iou) -- fail loudly, callers chunk+sum.
    if n_pixels > (1 << 24):
        raise ValueError(
            "confusion_matrix over %d pixels exceeds f32's exact integer "
            "range (2^24) per cell; chunk the call and sum the partial "
            "matrices in float64" % n_pixels)


def _weighted_counts(labels, predictions, num_classes, weights, n_groups):
    labels = labels.long().reshape(n_groups, -1)
    predictions = predictions.long().reshape(n_groups, -1)
    if weights is None:
        w = torch.ones(labels.shape, dtype=torch.float32,
                       device=labels.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=labels.device).reshape(n_groups, -1)
    _check_exact(labels.shape[1])
    # an id outside [0, C) adds nothing, as the JAX package's one-hot rows
    # are all zero for it: weight 0, and a cell of its own group
    valid = (labels >= 0) & (labels < num_classes) & \
        (predictions >= 0) & (predictions < num_classes)
    w = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    predictions = torch.where(valid, predictions,
                              torch.zeros_like(predictions))
    group = torch.arange(n_groups, device=labels.device)[:, None]
    cell = (group * num_classes + labels) * num_classes + predictions
    counts = torch.bincount(cell.reshape(-1), weights=w.reshape(-1),
                            minlength=n_groups * num_classes * num_classes)
    return counts.float().reshape(n_groups, num_classes, num_classes)


def confusion_matrix(labels, predictions, num_classes, weights=None):
    """Weighted confusion matrix, rows = labels, cols = predictions: each
    pixel adds ``weight`` (default 1) to cell ``[label, prediction]``; a
    pixel whose label or prediction lies outside [0, num_classes) adds
    nothing.  Returns a (num_classes, num_classes) float32 tensor."""
    return _weighted_counts(labels, predictions, num_classes, weights, 1)[0]


def confusion_matrix_per_frame(labels, predictions, num_classes,
                               weights=None):
    """One confusion matrix per leading index: (B, ...) -> (B, C, C)."""
    return _weighted_counts(labels, predictions, num_classes, weights,
                            labels.shape[0])


def iou_from_confusion(cm):
    """Per-class IoU from a confusion matrix; NaN where a class is absent."""
    cm = torch.as_tensor(cm, dtype=torch.float32)
    tp = torch.diagonal(cm)
    denom = cm.sum(dim=0) + cm.sum(dim=1) - tp
    return torch.where(denom > 0, tp / torch.clamp(denom, min=1.0),
                       torch.full_like(tp, float("nan")))


def _soft_columns(labels, probs, num_classes):
    """mat[p, i] = sum over pixels labelled i of probs[pixel, p]: each
    pixel's probability row added to its label's column."""
    labels = torch.as_tensor(labels, device=probs.device).reshape(-1).long()
    mat = torch.zeros((num_classes, probs.shape[-1]), dtype=torch.float32,
                      device=probs.device)
    # an id outside [0, C) adds nothing, as its one-hot row is all zero
    valid = (labels >= 0) & (labels < num_classes)
    mat.index_add_(0, labels[valid], probs[valid])
    return mat.T


def prob_confmat(student_labels, teacher_probs, num_classes):
    """Probability-weighted ("soft") confusion matrix (graph_utils.py:265-285).

    COLUMN i accumulates the teacher's full probability vectors over pixels
    the student labelled i (``mat[p, i]``, the JAX package's
    ``einsum("np,ni->pi")`` layout; ``soft_miou`` is transpose-invariant,
    but row-based consumers must not assume ``calculate_miou``'s
    rows-are-ground-truth layout).  Returns the (num_classes, num_classes)
    matrix of one batch; accumulate by summing.
    """
    probs = torch.as_tensor(teacher_probs, dtype=torch.float32)
    probs = probs.reshape(-1, probs.shape[-1])
    return _soft_columns(student_labels, probs, num_classes)


def prob_confmat_star(student_labels, teacher_labels, weights, teacher_probs,
                      num_classes):
    """Soft confusion matrices for the student's and the teacher's labels,
    each pixel's probabilities weighted by ``weights`` first
    (graph_utils.py:288-317).  Returns (mat_student, mat_teacher)."""
    probs = torch.as_tensor(teacher_probs, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=probs.device).reshape(-1)
    probs = probs.reshape(-1, probs.shape[-1]) * w[:, None]
    return (_soft_columns(student_labels, probs, num_classes),
            _soft_columns(teacher_labels, probs, num_classes))


def soft_miou(acc_mat):
    """mIoU of an accumulated soft confusion matrix (graph_utils.py:279-283:
    tp on the diagonal, denominator row + column - tp, a plain mean with no
    NaN guard)."""
    mat = torch.as_tensor(acc_mat, dtype=torch.float32)
    tp = torch.diagonal(mat)
    return torch.mean(tp / (mat.sum(dim=1) + mat.sum(dim=0) - tp))


def calculate_miou(conf_matrix, population=False, detailed=False, nan=False):
    """Per-class IoU list from a confusion matrix.

    Byte-for-byte compatible with the reference implementation
    (utils/utils.py:80-126): rows are ground-truth, columns predictions;
    classes absent from both axes yield NaN (``nan=True``) or the string
    'Not predicted/present'; the denominator is clamped to >= 1.
    """
    cm = np.asarray(conf_matrix)
    n = cm.shape[0]
    row = cm.sum(axis=1)
    col = cm.sum(axis=0)
    tp = np.diagonal(cm).astype(np.float64)
    denom = row + col - tp

    miou: list = []
    false_pos: list = []
    false_neg: list = []
    for i in range(n):
        if denom[i] == 0:
            miou.append(np.nan if nan else "Not predicted/present")
            if detailed:
                false_pos.append(0)
                false_neg.append(0)
        else:
            miou.append(tp[i] / max(denom[i], 1))
            if detailed:
                false_neg.append((row[i] - tp[i]) / denom[i])
                false_pos.append((col[i] - tp[i]) / denom[i])
    if population:
        pop = row / row.sum()
        if detailed:
            return miou, pop, false_neg, false_pos
        return miou, pop
    if detailed:
        return miou, false_neg, false_pos
    return miou


def string_class_iou(class_iou_list, population=None, headers=None,
                     class_weights=None, labels=None):
    """Pretty per-class IoU table (reference utils/utils.py:188-213)."""
    from ams_tpu_torch.configs import CITYSCAPES_LABELS

    out = []
    if headers is not None:
        out.append("%22s\t" % "" + "\t\t".join(headers) + "\t\t")
    if labels is None:
        labels = list(CITYSCAPES_LABELS)
    if class_weights is not None:
        keep = np.where(np.asarray(class_weights).reshape(-1) == 1)[0]
        # generic names rather than IndexError when the label space is
        # wider than the provided name list (e.g. a 21-class experiment
        # falling back to the 19-name Cityscapes default)
        labels = [labels[i] if i < len(labels) else "class %d" % i
                  for i in keep]
    if not isinstance(class_iou_list[0], list):
        class_iou_list = [class_iou_list]
    for i in range(len(class_iou_list[0])):
        if population is not None:
            head = "%-22s" % (labels[i] + "(%.3g):" % (population[i] * 100.0))
        else:
            head = "%-22s" % (labels[i] + ":")
        cells = []
        for col in class_iou_list:
            if isinstance(col[i], str):
                cells.append(col[i] + "\t")
            else:
                cells.append("%.1f" % (col[i] * 100.0) + "\t\t\t")
        out.append(head + "\t" + "".join(cells))
    return "\n".join(out) + "\n"
