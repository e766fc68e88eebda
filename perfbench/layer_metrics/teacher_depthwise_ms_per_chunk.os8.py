"""Device milliseconds of the teacher's depthwise convolutions per labeler
chunk in the traced window: cuDNN's depthwise kernels (the grouped direct
one at rate 2 or more, the specialised one at rate 1) and the port's
dilated depthwise kernel (``counts/depthwise.py``), over the program's
``teacher/decoder`` span records (one per chunk).  None where
``teacher_forward_ms_per_chunk.os8`` is None: without a trace or such
records, or where their count differs from K1's launches."""

from perfbench.counts.depthwise import is_depthwise_kernel
from perfbench.lib import spans


def read(ctx):
    t = ctx.trace_data
    chunks = len(spans.named(spans.records(ctx), "teacher/decoder"))
    if t is None or not chunks \
            or chunks != t.count_where(lambda n: "resize_argmax" in n):
        return None
    return 1e3 * t.seconds_where(is_depthwise_kernel) / chunks
