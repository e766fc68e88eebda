"""K1 (fused resize+argmax): its least time per launch over its device
time per launch."""

from perfbench.lib.readers import k1_roofline_pct


def read(ctx):
    return k1_roofline_pct(ctx)
