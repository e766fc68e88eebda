"""Frames of the window over its length, on the host clock."""

from perfbench.lib.readers import rate


def read(ctx):
    return rate(ctx)
