"""K1 (fused resize+argmax) on the decoder's stride-4 grid: its least
time per launch from its shapes over its device time per launch."""

from perfbench.lib.readers import k1_roofline_pct


def read(ctx):
    return k1_roofline_pct(ctx)
