"""Model FLOPs of the untraced window's forwards of DeepLabV3+
(``counts/teacher_v3plus.py``, counted on its reference) over that window
and the bf16 peak."""

from perfbench.counts.teacher_v3plus import infer
from perfbench.lib.readers import mfu_pct


def read(ctx):
    _, b, h, w = ctx.facts["infer_shape"]
    per_call = infer(b, h, w, ctx.config["output_stride"])
    return mfu_pct(ctx, per_call * ctx.window["frames"] / b)
