"""The teacher's depthwise readers (``teacher_depthwise_ms_per_chunk.os8``,
``dw_dilated_roofline_pct.os8``) and the bound they read
(``counts/depthwise.py``): the OS8 cell's 57 dilated depthwise
convolutions and their 15.09 ms, and the readers on hand-made traces of
two chunks, with the program's span records patched in.  A program
without the port's kernel (the parent of the change that added it) has
no such launches and no such records: the roofline reads nothing, the
depthwise time reads cuDNN's."""

from collections import Counter
from pathlib import Path
import types

import pytest

from ams_tpu_torch.utils.trace import GLOBAL_TIMER, SpanRecord
from perfbench import harness
from perfbench.counts import depthwise
from perfbench.lib.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
K1 = dict(b=8, c=19, gh=257, gw=513, h=1025, w=2049, elem_bytes=2)
KERNEL = ("void (anonymous namespace)::depthwise_dilated_kernel<4>"
          "(unsigned int const*, unsigned int const*, unsigned int*, int)")
CUDNN = ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false, "
         "false, 0, 0, int, __nv_bfloat16>(...)")
RATE1 = "conv2d_c1_k1_nhwc_specialized"
RESIZE = "void (anonymous namespace)::resize_argmax_band<unsigned short, 20>"
MS = 1_000_000      # nanoseconds


def _reader(name):
    return harness.load_module(ROOT / "perfbench" / "layer_metrics"
                               / (name + ".py"),
                               "test_metric_" + name.replace(".", "_"))


def test_os8_cell_has_57_dilated_depthwise_bound_15ms():
    shapes = depthwise.dilated_shapes(8, 1025, 2049, 8)
    assert len(shapes) == 57
    assert Counter(shapes) == {
        (8, 728, 129, 257, 2): 50, (8, 1024, 129, 257, 2): 1,
        (8, 1024, 129, 257, 4): 1, (8, 1536, 129, 257, 4): 2,
        (8, 2048, 129, 257, 12): 1, (8, 2048, 129, 257, 24): 1,
        (8, 2048, 129, 257, 36): 1}
    assert sum(c for _, c, _, _, _ in shapes) == 47_664
    assert depthwise.depthwise_bound_s(shapes) == \
        pytest.approx(15.09e-3, abs=0.005e-3)


def test_bound_counts_input_output_and_weights_once():
    # one 2x16x10x12 convolution: 2 x 3840 elements and 9 x 16 weights
    assert depthwise.depthwise_bound_s([(2, 16, 10, 12, 2)], 2) == \
        pytest.approx((2 * 3840 + 144) * 2 / 3.35e12)


def _trace(chunks, kernels_per_chunk, kernel_ms, cudnn_per_chunk=3,
           k1=True):
    """Device events of ``chunks`` chunks, each ``kernels_per_chunk``
    launches of the port's kernel of ``kernel_ms``, some cuDNN dilated
    depthwise launches of 2 ms, two of cuDNN's rate-1 depthwise of 0.5
    ms, a 1x1 GEMM and one K1 launch, back to back."""
    events, t = [], 0
    for _ in range(chunks):
        for _ in range(kernels_per_chunk):
            events.append((KERNEL, t, t + int(kernel_ms * MS)))
            t += int(kernel_ms * MS) + MS
        for _ in range(cudnn_per_chunk):
            events.append((CUDNN, t, t + 2 * MS))
            t += 3 * MS
        for _ in range(2):
            events.append((RATE1, t, t + MS // 2))
            t += MS
        events.append(("sm90_xmma_fprop_implicit_gemm_bf16", t, t + MS))
        t += 2 * MS
        if k1:
            events.append((RESIZE, t, t + MS // 10))
            t += MS
    return Trace(events, [], window_s=t / 1e9)


def _records(chunks, counted):
    recs = [SpanRecord("teacher/decoder", i, i + 1, i, -1, i, 1)
            for i in range(chunks)]
    recs += [SpanRecord("layers/depthwise_dilated", 5, 5, 100 + i, -1,
                        100 + i, 1) for i in range(counted)]
    return recs


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(GLOBAL_TIMER, "records", [])
    return types.SimpleNamespace(trace_data=None, facts={"k1": K1},
                                 config={"output_stride": 8})


def test_roofline_is_the_bound_over_the_kernels_time(ctx):
    ctx.trace_data = _trace(2, 57, 0.4)
    GLOBAL_TIMER.records = _records(2, 114)
    bound_ms = depthwise.depthwise_bound_s(
        depthwise.dilated_shapes(8, 1025, 2049, 8)) * 1e3
    got = _reader("dw_dilated_roofline_pct.os8").read(ctx)
    assert got == pytest.approx(100 * bound_ms / (57 * 0.4), rel=1e-6)
    ms = _reader("teacher_depthwise_ms_per_chunk.os8").read(ctx)
    assert ms == pytest.approx(57 * 0.4 + 3 * 2 + 2 * 0.5, rel=1e-6)


@pytest.mark.parametrize("kernels,counted", [
    (57, 113),      # a launch the program did not count
    (56, 112),      # as many as counted, but not 57 per chunk
    (58, 116),
])
def test_roofline_reads_nothing_where_the_counts_disagree(ctx, kernels,
                                                          counted):
    ctx.trace_data = _trace(2, kernels, 0.4)
    GLOBAL_TIMER.records = _records(2, counted)
    assert _reader("dw_dilated_roofline_pct.os8").read(ctx) is None


def test_parent_without_the_kernel(ctx):
    """cuDNN alone: no roofline; the depthwise time is cuDNN's."""
    ctx.trace_data = _trace(2, 0, 0.0, cudnn_per_chunk=57)
    GLOBAL_TIMER.records = _records(2, 0)
    assert _reader("dw_dilated_roofline_pct.os8").read(ctx) is None
    ms = _reader("teacher_depthwise_ms_per_chunk.os8").read(ctx)
    assert ms == pytest.approx(57 * 2 + 2 * 0.5, rel=1e-6)


@pytest.mark.parametrize("case", ["no_trace", "no_chunks", "k1_differs"])
def test_depthwise_ms_reads_nothing_where_the_forward_does_not(ctx, case):
    if case != "no_trace":
        ctx.trace_data = _trace(2, 57, 0.4, k1=case != "k1_differs")
    GLOBAL_TIMER.records = _records(0 if case == "no_chunks" else 2, 114)
    assert _reader("teacher_depthwise_ms_per_chunk.os8").read(ctx) is None
    assert _reader("teacher_forward_ms_per_chunk.os8").read(ctx) is None
