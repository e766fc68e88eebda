"""The H100's published peaks (NVIDIA's data sheet, SXM, dense rates at
700 W) and the least time of a kernel from its shapes."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_DENSE_FLOPS = 989e12       # bf16 tensor cores, dense
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def resize_argmax_bound_s(b, c, gh, gw, h, w, elem_bytes):
    """Least seconds for one fused resize+argmax (K1) on an H100 SXM: each
    input read once (the ``c`` class planes of ``elem_bytes`` each, and
    the lerp tables) and each output (int32 ids) written once, over
    3.35 TB/s; or the operations of the separable lerp (a horizontal lerp
    per grid row and class, a vertical lerp per pixel and class, 3 ops
    each) plus one compare per pixel and class, over 67 TFLOP/s f32.
    -> (seconds, "bytes" or "operations"), the larger bound."""
    nbytes = b * c * gh * gw * elem_bytes + b * h * w * 4 \
        + (3 * h + 3 * w) * 4
    ops = 3 * b * c * (gh * w + h * w) + b * c * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
