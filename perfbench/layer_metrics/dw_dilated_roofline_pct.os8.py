"""The port's dilated depthwise kernel in the OS8 teacher: its least time
per labeler chunk (``counts/depthwise.py``: the reference's dilated
depthwise convolutions at the cell's shape, each input and output bf16
read or written once, over 3.35 TB/s) over its device time per chunk.

None unless the trace's launches of the kernel equal the program's
``layers/depthwise_dilated`` records and equal the reference's dilated
depthwise convolutions per ``teacher/decoder`` record (one per chunk): a
program without the kernel, or a window whose launches and spans
describe other work, reads nothing."""

from perfbench.counts import depthwise
from perfbench.lib import spans


def read(ctx):
    t, k1 = ctx.trace_data, ctx.facts.get("k1")
    if t is None or k1 is None:
        return None
    recs = spans.records(ctx)
    chunks = len(spans.named(recs, "teacher/decoder"))
    launches = t.count_where(depthwise.is_dilated_kernel)
    shapes = depthwise.dilated_shapes(k1["b"], k1["h"], k1["w"],
                                      ctx.config["output_stride"])
    if not chunks or launches != len(shapes) * chunks \
            or launches != len(spans.named(recs, "layers/depthwise_dilated")):
        return None
    bound_s = depthwise.depthwise_bound_s(shapes, k1["elem_bytes"])
    return 100.0 * bound_s / (t.seconds_where(depthwise.is_dilated_kernel)
                              / chunks)
