"""What the metric readers share: each reader file is ``read(ctx)``, a
number or None where its run has nothing to read (no trace, no launch)."""

from __future__ import annotations

import re

import numpy as np

from perfbench.counts import bounds, flops

# PyTorch's own elementwise, reduction and multi-tensor (foreach) kernels
ELEMENTWISE = re.compile(r"elementwise|reduce_kernel|multi_tensor_apply")


def rate(ctx):
    """Frames per second of the window, on the host clock."""
    return ctx.window["frames"] / ctx.window["window_s"]


def percentile_ms(ctx, q):
    lat = ctx.window["latencies_ms"]
    return float(np.percentile(lat, q)) if lat else None


def idle_pct(ctx):
    t = ctx.trace_data
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def elementwise_pct(ctx):
    t = ctx.trace_data
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.seconds_where(ELEMENTWISE.search) / t.busy_s


def k1_roofline_pct(ctx):
    """K1's least time per launch from its shapes over its device time
    per launch in the trace."""
    t, k1 = ctx.trace_data, ctx.facts.get("k1")
    if t is None or k1 is None:
        return None

    def is_k1(name):
        return "resize_argmax" in name
    n = t.count_where(is_k1)
    if n == 0:
        return None
    bound_s, _ = bounds.resize_argmax_bound_s(**k1)
    return 100.0 * bound_s / (t.seconds_where(is_k1) / n)


def mfu_pct(ctx, model_flops):
    """Model FLOPs of the untraced window over its length and the bf16
    peak; None off the card."""
    if ctx.device.type != "cuda":
        return None
    return 100.0 * model_flops / ctx.window["window_s"] \
        / bounds.BF16_DENSE_FLOPS


def infer_flops(ctx):
    """Model FLOPs of the window's forwards (facts["infer_shape"]: model,
    batch, h, w of one call)."""
    model, b, h, w = ctx.facts["infer_shape"]
    per_call = {"student": flops.student_infer,
                "teacher": flops.teacher_infer}[model](b, h, w)
    return per_call * ctx.window["frames"] / b
