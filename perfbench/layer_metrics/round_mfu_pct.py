"""The round's model FLOPs (forward and backward of every trained
image, counted on the reference) over the untraced window and the bf16 peak."""

from perfbench.counts import flops
from perfbench.lib.readers import mfu_pct


def read(ctx):
    per_step = flops.student_train(*ctx.facts["train_shape"])
    return mfu_pct(ctx, per_step * ctx.window["steps"])
