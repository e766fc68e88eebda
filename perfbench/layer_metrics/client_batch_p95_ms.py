"""The 95th percentile of every batch's latency in the untraced window,
from the call to ids on the host."""

from perfbench.lib.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
