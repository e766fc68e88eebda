"""The share of the device's busy time in PyTorch's elementwise,
reduction and multi-tensor kernels."""

from perfbench.lib.readers import elementwise_pct


def read(ctx):
    return elementwise_pct(ctx)
