"""The dilated depthwise convolutions of a reference's forward, and their
least time on an H100 SXM.

``dilated_shapes`` runs the benchmark's plain DeepLabV3+ reference on
meta tensors and records each depthwise 3x3 convolution at stride 1 and
rate 2 or more that it makes, whatever the program runs in their place.
``depthwise_bound_s`` reads each such convolution's input and weights
once and writes its output once, over 3.35 TB/s: its operations (9
multiply-adds per output, 4.5 per byte in bf16) lie far below the card's
20 f32 operations per byte, so bytes bound it."""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench.counts import flops
from perfbench.counts.bounds import HBM_BYTES_PER_S
from perfbench.reference import teacher_v3plus

# the port's kernel (ams_tpu_torch/csrc/depthwise_dilated.cu), and cuDNN's
# kernels for a bf16 channels-last depthwise 3x3 on an H100: the grouped
# direct kernel at rate 2 or more, a specialised one at rate 1 (stride 1
# or 2), by the names the device trace gives them
DILATED_KERNEL = "depthwise_dilated"
CUDNN_DEPTHWISE = ("conv2d_grouped_direct", "conv2d_c1_k1_nhwc_specialized")


def is_dilated_kernel(name: str) -> bool:
    return DILATED_KERNEL in name


def is_depthwise_kernel(name: str) -> bool:
    return DILATED_KERNEL in name or any(k in name for k in CUDNN_DEPTHWISE)


class _Recorder(TorchDispatchMode):
    """(n, c, ho, wo, rate) of every dilated depthwise 3x3 convolution at
    stride 1 dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, _, dilation, _, _, groups = args
            if (groups > 1 and groups == x.shape[1]
                    and tuple(w.shape[2:]) == (3, 3)
                    and tuple(stride) == (1, 1) and min(dilation) >= 2):
                self.shapes.append((*out.shape, dilation[0]))
        return out


@functools.lru_cache(maxsize=None)
def dilated_shapes(batch: int, h: int, w: int, output_stride: int = 8
                   ) -> tuple:
    """The reference's dilated depthwise convolutions on ``batch`` padded
    frames of h x w: ((n, c, ho, wo, rate), ...) in the order it runs
    them."""
    params = flops._meta_params(teacher_v3plus.param_specs())
    frames = torch.empty((batch, h, w, 3), device=flops.META)
    with _Recorder() as rec:
        teacher_v3plus.grid_logits(params, frames,
                                   output_stride=output_stride)
    return tuple(rec.shapes)


def depthwise_bound_s(shapes, elem_bytes: int = 2) -> float:
    """Least seconds for the convolutions ``shapes`` ((n, c, ho, wo,
    rate), stride 1 and TF's SAME padding, so each input is as large as
    its output): each input element and weight read once and each output
    written once, over 3.35 TB/s."""
    nbytes = sum((2 * n * c * ho * wo + 9 * c) * elem_bytes
                 for n, c, ho, wo, _ in shapes)
    return nbytes / HBM_BYTES_PER_S
