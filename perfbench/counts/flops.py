"""Model FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode`` on
the benchmark's plain references over meta tensors: the convolutions and
products a forward (and, for training, its backward) needs at a cell's
shapes, whatever kernels the program runs and whatever it recomputes."""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import student, teacher

META = torch.device("meta")


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                   _padding, _dilation, _transposed, _output_padding,
                   _groups, output_mask, out_shape=None, **kwargs) -> int:
    """Each gradient a convolution's backward forms takes the forward's
    multiply-adds: one per (output element, weight element of its group).
    PyTorch's own formula counts a grouped (depthwise) convolution's
    weight gradient as if it had one group."""
    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def count(fn) -> int:
    mapping = {torch.ops.aten.convolution_backward: _conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta_params(specs):
    return {name: torch.empty(shape, device=META)
            for name, shape, _ in specs}


@functools.lru_cache(maxsize=None)
def student_train(batch: int, h: int, w: int, union: tuple) -> int:
    """One training step of one student on ``batch`` frames of h x w:
    forward and backward to every trainable."""
    params = _meta_params(student.param_specs())
    leaves = {k: v.requires_grad_(True) for k, v in params.items()
              if student.trainable(k)}

    def step():
        frames = torch.empty((batch, h, w, 3), device=META)
        labels = torch.empty((batch, h, w), dtype=torch.uint8, device=META)
        mask = torch.ones(len(union), device=META)
        loss = student.distill_loss({**params, **leaves}, frames, labels,
                                    union, mask)
        torch.autograd.grad(loss, list(leaves.values()))

    return count(step)


@functools.lru_cache(maxsize=None)
def student_infer(batch: int, h: int, w: int) -> int:
    params = _meta_params(student.param_specs())
    frames = torch.empty((batch, h, w, 3), device=META)
    return count(lambda: student.grid_logits(params, frames))


@functools.lru_cache(maxsize=None)
def teacher_infer(batch: int, h: int, w: int) -> int:
    """The teacher on ``batch`` padded frames of h x w."""
    params = _meta_params(teacher.param_specs())
    frames = torch.empty((batch, h, w, 3), device=META)
    return count(lambda: teacher.grid_logits(params, frames))
