"""Model FLOPs of the untraced window's forwards (counted on the
reference) over that window and the bf16 peak."""

from perfbench.lib.readers import infer_flops, mfu_pct


def read(ctx):
    return mfu_pct(ctx, infer_flops(ctx))
