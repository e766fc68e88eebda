"""Model FLOPs of DeepLabV3+ Xception-65 (``reference/teacher_v3plus.py``),
counted as ``counts/flops.py`` counts the other references: its forward
on meta tensors under ``FlopCounterMode``."""

from __future__ import annotations

import functools

import torch

from perfbench.counts import flops
from perfbench.reference import teacher_v3plus


@functools.lru_cache(maxsize=None)
def infer(batch: int, h: int, w: int, output_stride: int = 8) -> int:
    """The forward on ``batch`` padded frames of h x w, up to the stride-4
    logits."""
    params = flops._meta_params(teacher_v3plus.param_specs())
    frames = torch.empty((batch, h, w, 3), device=flops.META)
    return flops.count(lambda: teacher_v3plus.grid_logits(
        params, frames, output_stride=output_stride))
