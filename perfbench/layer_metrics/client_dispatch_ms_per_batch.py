"""Mean self time, in milliseconds, of the program's ``network/forward``
span over the traced window: the host's enqueue of the folded forward
and K1 for one batch."""

from perfbench.lib import spans


def read(ctx):
    ns = spans.mean_self_ns(spans.records(ctx), "network/forward")
    return None if ns is None else ns / 1e6
