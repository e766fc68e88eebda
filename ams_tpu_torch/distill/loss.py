"""Label reduction for the class-subset metrics, in PyTorch.

Counterpart of ``label_lut`` and ``reduce_labels`` in
``ams_tpu/distill/loss.py``: teacher labels in the full class-id space map
to ids in the experiment's reduced space, and labels outside the selected
set get reduced id 0 and weight 0 (the reference's one_hot -> gather ->
argmax / reduce_sum).  The training losses belong to the training slice.
"""

from __future__ import annotations

import numpy as np
import torch


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


def reduce_labels(labels: torch.Tensor, class_indices, num_classes):
    """Teacher labels (full id space) -> (reduced ids int32, validity
    weights f32, filtered one-hot f32 over the reduced classes).  Ids
    outside [0, num_classes) have weight 0, as ``jax.nn.one_hot`` gives
    them an all-zero row."""
    red, val = label_lut(class_indices, num_classes)
    dev = labels.device
    labels = labels.long()
    inside = (labels >= 0) & (labels < num_classes)
    idx = torch.where(inside, labels, torch.zeros_like(labels))
    reduced = torch.from_numpy(red).to(dev)[idx]
    weights = torch.from_numpy(val).to(dev)[idx] * inside
    reduced = torch.where(weights > 0, reduced, torch.zeros_like(reduced))
    filtered = torch.nn.functional.one_hot(
        reduced.long(), len(class_indices)).float() * weights[..., None]
    return reduced, weights, filtered
