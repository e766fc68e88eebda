"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and memset intervals over the window."""

from perfbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
