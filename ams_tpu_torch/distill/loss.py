"""Online-distillation losses and label reduction, in PyTorch.

Counterpart of ``ams_tpu/distill/loss.py``: the reference's class-reduced
masked cross-entropy (logits gathered to the experiment's selected classes;
teacher hard labels one-hot-encoded in the FULL class space and gathered,
so labels outside the selected set get an all-zero row and weight 0; the
loss is the mean CE over valid pixels), the soft-teacher path, and the
per-class 'selective' diagnostic.

Labels outside [0, num_classes) (the 255 "ignore" id) get weight 0 on
every path here.  ``ams_tpu``'s fused path looks them up with a clamped
gather instead, so it counts 255 as the last class; the port does not copy
that (ROADMAP section C).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ams_tpu_torch.models.mobilenetv2_deeplab import (
    _class_index,
    grid_logits_nchw,
    student_logits,
)
from ams_tpu_torch.models.resize import resize_nchw, resize_nchw_matmul
from ams_tpu_torch.parallel import spatial


def label_lut(class_indices, num_classes):
    """(reduced-id LUT int32, validity LUT float32) over the full id space,
    as numpy arrays."""
    ci = np.asarray(class_indices)
    red = np.zeros(num_classes, np.int32)
    val = np.zeros(num_classes, np.float32)
    for pos, c in enumerate(ci):
        red[c] = pos
        val[c] = 1.0
    return red, val


@functools.lru_cache(maxsize=None)
def _device_lut(class_indices, num_classes, device):
    """``label_lut`` on ``device``, one upload per subset (outside
    inference mode, so that autograd may use it)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in label_lut(class_indices, num_classes))


def reduce_labels(labels: torch.Tensor, class_indices, num_classes):
    """Teacher labels (full id space) -> (reduced ids int32, validity
    weights f32, filtered one-hot f32 over the reduced classes).  Ids
    outside [0, num_classes) have weight 0, as ``jax.nn.one_hot`` gives
    them an all-zero row."""
    red, val = _device_lut(tuple(int(c) for c in class_indices),
                           int(num_classes), labels.device)
    labels = labels.long()
    inside = (labels >= 0) & (labels < num_classes)
    idx = torch.where(inside, labels, torch.zeros_like(labels))
    reduced = red[idx]
    weights = val[idx] * inside
    reduced = torch.where(weights > 0, reduced, torch.zeros_like(reduced))
    filtered = torch.nn.functional.one_hot(
        reduced.long(), len(class_indices)).float() * weights[..., None]
    return reduced, weights, filtered


def softmax_xent_with_soft_labels(logits, soft_labels):
    """tf.nn.softmax_cross_entropy_with_logits semantics (last axis)."""
    return -torch.sum(soft_labels * torch.log_softmax(logits, dim=-1), dim=-1)


def masked_mean(x, mask, reduce=None):
    """Mean over elements where mask is nonzero (boolean_mask +
    reduce_mean); 0 for an empty mask.  With ``reduce`` (a
    ``parallel.collectives.SumReducer``) the numerator and the weight sum
    are summed over the ranks first: the mean of the global batch.  ``x``
    and ``mask`` may be width shards of the same columns: the sums are
    then summed over the shards on the first one's device."""
    if isinstance(x, spatial.WidthShards):
        dev = x.device
        num = den = 0
        for xp, mp in zip(x.parts, mask.parts):
            m = mp.to(xp.dtype)
            num = num + torch.sum(xp * m).to(dev)
            den = den + torch.sum(m).to(dev)
    else:
        m = mask.to(x.dtype)
        num, den = torch.sum(x * m), torch.sum(m)
    if reduce is not None:
        num, den = reduce(torch.stack([num, den])).unbind()
    return num / torch.clamp(den, min=1.0)


def distill_loss(params, frames, labels, class_indices, num_classes, *,
                 train=True, teacher_logits=None, compute_dtype=torch.float32,
                 stats_out=None, fused=False, class_mask=None,
                 resize_via="gather", reduce=None):
    """Scalar distillation loss + aux dict.

    Args:
        params: flat student param dict (trainable + BN moving stats).
        frames: (B, H, W, 3) float/uint8 in [0, 255].
        labels: (B, H, W) integer teacher hard labels in the FULL class space.
        class_indices: the selected class ids.
        num_classes: total classes (19 or 21).
        teacher_logits: optional (B, H, W, num_classes) for soft-teacher CE.
        compute_dtype: the convolutions' type (float32 or bfloat16); the
            grid logits go to float32 before the class gather and the
            resize, so the loss is taken in float32 either way.
        stats_out: optional dict to capture BN batch moments for the
            moving-average update.
        fused: with hard labels, the loss runs through the fused
            upsample+CE kernel (``ops.fused_resize_ce``) on the grid logits;
            the full-resolution logits are never formed.  Not with
            ``class_mask`` (``ValueError``).
        class_mask: optional (len(class_indices),) {0,1} vector narrowing the
            live classes as data: masked positions get -1e9 logits and zero
            label validity.
        resize_via: "gather" = the TF-rounding-exact lerp resize; "matmul" =
            the R@x@C^T form.
        reduce: optional ``parallel.collectives.SumReducer``: ``frames``
            are this rank's equal share of a global minibatch, and the BN
            moments and the loss are those of the global minibatch.

    ``frames`` and ``labels`` may be width shards of the same columns
    (``parallel.spatial``, the mesh's ``model`` axis): the forward runs on
    the shards and gathers the grid logits.  The plain losses then resize,
    on each shard's device, the label columns that shard holds, and sum
    the masked sums over the shards; the fused loss gathers the labels and
    runs its kernel once on the whole grid, as XLA runs a Pallas call that
    it cannot partition.  Per-pixel aux entries are then width shards.

    Returns:
        (loss, aux).  On the standard paths aux = {'predictions',
        'weights', 'logits_reduced', 'reduced_labels'}; on the fused path
        aux = {'weights', 'reduced_labels', 'grid_logits_reduced'}, the grid
        logits channels-last (B, gh, gw, n_sel).
    """
    if class_mask is not None and fused:
        raise ValueError("class_mask is not supported on the fused path")
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    ci = _class_index(class_indices, frames.device)
    sharded = isinstance(frames, spatial.WidthShards)
    if (teacher_logits is not None or not fused) \
            and resize_via not in ("gather", "matmul"):
        raise ValueError("resize_via must be 'gather' or 'matmul', not %r"
                         % (resize_via,))
    if sharded and (not fused or teacher_logits is not None):
        grid = grid_logits_nchw(params, frames, train=train,
                                stats_out=stats_out,
                                compute_dtype=compute_dtype, reduce=reduce)
        grid_red = grid.float().index_select(1, ci)
        resize = resize_nchw_matmul if resize_via == "matmul" else \
            resize_nchw
        parts = [_pixel_loss(
            resize(grid_red.to(lab.device), (h, w), cols=(lo, hi)).permute(
                0, 2, 3, 1), lab, class_indices, num_classes, class_mask,
            None if teacher_logits is None
            else teacher_logits[:, :, lo:hi].to(lab.device))
            for lab, (lo, hi) in zip(labels.parts, labels.ranges)]
        columns = lambda k: spatial.WidthShards(  # noqa: E731
            [p[k] for p in parts], labels.ranges, labels.width, dim=2)
        pixel_loss, weights = columns("pixel_loss"), columns("weights")
        loss = masked_mean(pixel_loss, weights.map(lambda t: t > 0),
                           reduce=reduce)
        aux = {k: columns(k) for k in ("predictions", "weights",
                                       "logits_reduced", "reduced_labels")}
        return loss, aux
    if sharded:
        labels = labels.gather()
    if teacher_logits is None and fused:
        from ams_tpu_torch.ops.fused_resize_ce import fused_resize_ce

        grid = grid_logits_nchw(params, frames, train=train,
                                stats_out=stats_out,
                                compute_dtype=compute_dtype, reduce=reduce)
        grid = grid.float().index_select(1, ci).contiguous()
        reduced_labels, weights, _ = reduce_labels(labels, class_indices,
                                                   num_classes)
        loss = fused_resize_ce(grid, reduced_labels.to(torch.int32),
                               weights, (h, w))
        if reduce is not None:
            # the kernel's mean divides by this rank's weight total T_r;
            # the global loss is sum_r mean_r * T_r / T, and its gradient
            # through the kernel's node is then grad_sum_r / T
            local = torch.clamp(torch.sum(weights), min=1.0)
            total = torch.clamp(reduce(torch.sum(weights)), min=1.0)
            loss = reduce(loss * (local / total))
        aux = {"weights": weights, "reduced_labels": reduced_labels,
               "grid_logits_reduced": grid.permute(0, 2, 3, 1)}
        return loss, aux

    if resize_via == "matmul":
        grid = grid_logits_nchw(params, frames, train=train,
                                stats_out=stats_out,
                                compute_dtype=compute_dtype, reduce=reduce)
        # the class gather commutes with the per-channel resize; doing it
        # at grid level shrinks the resize and its backward
        grid_red = grid.float().index_select(1, ci)
        reduced_logits = resize_nchw_matmul(grid_red,
                                            (h, w)).permute(0, 2, 3, 1)
    else:
        logits = student_logits(params, frames, train=train,
                                stats_out=stats_out,
                                compute_dtype=compute_dtype, reduce=reduce)
        reduced_logits = logits.index_select(3, ci)
    aux = _pixel_loss(reduced_logits, labels, class_indices, num_classes,
                      class_mask, teacher_logits)
    loss = masked_mean(aux.pop("pixel_loss"), aux["weights"] > 0,
                       reduce=reduce)
    return loss, aux


def _pixel_loss(reduced_logits, labels, class_indices, num_classes,
                class_mask, teacher_logits):
    """The per-pixel CE of channels-last logits over the class subset
    against hard labels (or the soft teacher's), with the class mask:
    {'pixel_loss', 'predictions', 'weights', 'logits_reduced',
    'reduced_labels'}."""
    reduced_labels, weights, filtered_onehot = reduce_labels(
        labels, class_indices, num_classes)
    if class_mask is not None:
        class_mask = class_mask.to(reduced_logits.device)
        cm = class_mask.to(reduced_logits.dtype)
        reduced_logits = torch.where(
            cm > 0, reduced_logits,
            torch.tensor(-1e9, dtype=reduced_logits.dtype,
                         device=reduced_logits.device))
        filtered_onehot = filtered_onehot * class_mask.to(
            filtered_onehot.dtype)
        weights = torch.sum(filtered_onehot, dim=-1)
    if teacher_logits is not None:
        red_teacher = teacher_logits.index_select(
            3, _class_index(class_indices, teacher_logits.device))
        if class_mask is not None:
            red_teacher = torch.where(
                class_mask.to(red_teacher.dtype) > 0, red_teacher,
                torch.tensor(-1e9, dtype=red_teacher.dtype,
                             device=red_teacher.device))
        soft = torch.softmax(red_teacher, dim=-1)
        pixel_loss = softmax_xent_with_soft_labels(reduced_logits, soft)
    else:
        pixel_loss = softmax_xent_with_soft_labels(reduced_logits,
                                                   filtered_onehot)
    preds = torch.argmax(reduced_logits, dim=-1).to(torch.int32)
    return {"pixel_loss": pixel_loss, "predictions": preds,
            "weights": weights, "logits_reduced": reduced_logits,
            "reduced_labels": reduced_labels}


def selective_loss(reduced_logits, reduced_labels, weights, n_selected):
    """Per-class selective CE sum (the reference's graph_utils.py:410-418):
    for each selected class i, mean CE over valid pixels where label==i or
    prediction==i.  A diagnostic, not a training loss.  Keeps the
    reference's NaN convention: a selected class absent from the batch (no
    pixel with label==i or pred==i) makes that term, and the sum, NaN."""
    preds = torch.argmax(reduced_logits, dim=-1)
    onehot = torch.nn.functional.one_hot(reduced_labels.long(),
                                         n_selected).float()
    pixel_loss = softmax_xent_with_soft_labels(reduced_logits, onehot)
    valid = weights > 0
    total = torch.zeros((), dtype=pixel_loss.dtype,
                        device=pixel_loss.device)
    for i in range(n_selected):
        sel = valid & ((reduced_labels == i) | (preds == i))
        m = sel.to(pixel_loss.dtype)
        # deliberately unguarded: 0/0 -> NaN matches reduce_mean(empty)
        total = total + torch.sum(pixel_loss * m) / torch.sum(m)
    return total
