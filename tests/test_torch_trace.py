"""The port's span recorder (``ams_tpu_torch/utils/trace.py``), the spans
of ``SemanticNetwork.predict_input`` and of the teacher labeler, and the
benchmark's readers of them (``perfbench/lib/spans.py`` and the
``perfbench/layer_metrics`` files that read the program's spans), on the
CPU."""

import importlib.util
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ams_tpu_torch.models.frozen import fold_student  # noqa: E402
from ams_tpu_torch.models.mobilenetv2_deeplab import (  # noqa: E402
    init_student_params,
)
from ams_tpu_torch.runtime.labeler import make_teacher_labeler  # noqa: E402
from ams_tpu_torch.runtime.network import SemanticNetwork  # noqa: E402
from ams_tpu_torch.utils.trace import (  # noqa: E402
    GLOBAL_TIMER, PhaseTimer, SpanRecord,
)
from perfbench.lib import spans  # noqa: E402
from perfbench.lib.trace import Trace  # noqa: E402

SPAN_READERS = ("label_idle_host_ms_per_call",
                "client_dispatch_ms_per_batch",
                "client_pinned_reuse_pct",
                "label_idle_host_ms_per_call.os8",
                "teacher_forward_ms_per_chunk.os8",
                "teacher_bn_epilogue_pct.label",
                "teacher_bn_epilogue_pct.os8")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture
def global_timer():
    """GLOBAL_TIMER emptied before and after the test."""
    GLOBAL_TIMER.reset()
    yield GLOBAL_TIMER
    GLOBAL_TIMER.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def children(recs, parent):
    """Names of the spans inside ``parent``, in the order they opened."""
    return [r.name for r in sorted(recs, key=lambda r: r.id)
            if r.parent == parent.id]


def by_opening(recs):
    return sorted(recs, key=lambda r: r.id)


def test_no_records_without_a_profiler():
    t = PhaseTimer()
    for _ in range(3):
        with t.span("a"):
            with t.span("b"):
                pass
    assert t.records == []
    assert t.counts == {"a": 3, "b": 3}
    assert t.totals["a"] >= t.totals["b"] >= 0


def test_records_parents_requests_and_self_time():
    t = PhaseTimer()
    with cpu_profile():
        for _ in range(2):
            with t.span("req"):
                with t.span("a"):
                    with t.span("b"):
                        torch.ones(64).sum()
                with t.span("c"):
                    pass
    # appended as they close
    assert [r.name for r in t.records] == ["b", "a", "c", "req"] * 2
    recs = by_opening(t.records)
    assert [r.name for r in recs] == ["req", "a", "b", "c"] * 2
    ids = [r.id for r in recs]
    assert len(set(ids)) == 8
    assert [r.parent for r in recs] == [-1, ids[0], ids[1], ids[0],
                                        -1, ids[4], ids[5], ids[4]]
    assert [r.request for r in recs] == [ids[0]] * 4 + [ids[4]] * 4
    assert t.counts["req"] == 2 and t.counts["b"] == 2
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
    free = spans.self_intervals(recs)
    for i in (0, 4):
        req, a, c = recs[i], recs[i + 1], recs[i + 3]
        want = (req.end_ns - req.start_ns) - (a.end_ns - a.start_ns) \
            - (c.end_ns - c.start_ns)
        assert sum(e - s for s, e in free[req.id]) == want
    assert spans.mean_self_ns(recs, "b") == sum(
        r.end_ns - r.start_ns for r in recs if r.name == "b") / 2


def test_each_thread_keeps_its_own_stack():
    t = PhaseTimer()
    inside, release = threading.Barrier(2), threading.Event()

    def request(name):
        with t.span(name):
            with t.span(name + "/child"):
                inside.wait(timeout=10)
                release.wait(timeout=10)

    with cpu_profile():
        threads = [threading.Thread(target=request, args=(n,))
                   for n in ("x", "y")]
        for th in threads:
            th.start()
        release.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    recs = t.records
    for n in ("x", "y"):
        top = next(r for r in recs if r.name == n)
        child = next(r for r in recs if r.name == n + "/child")
        assert top.parent == -1 and child.parent == top.id
        assert child.request == top.request == top.id
        assert child.thread == top.thread
    assert len({r.request for r in recs}) == 2


def test_threads_lose_no_span():
    """More threads than cores, switching often: every span counted and
    recorded once, with a unique id and its own thread's parent."""
    t = PhaseTimer()
    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with t.span("req"):
                    with t.span("child"):
                        pass
        with cpu_profile():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    total = n_threads * n_spans
    assert t.counts == {"req": total, "child": total}
    recs = t.records
    assert len(recs) == 2 * total and len({r.id for r in recs}) == 2 * total
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "child":
            top = by_id[r.parent]
            assert top.name == "req" and top.thread == r.thread
            assert r.request == top.id
        else:
            assert r.parent == -1 and r.request == r.id


def test_span_shares_the_profile_clock():
    """A span around an aten op holds the op's kineto event, within
    100 us: spans and kineto's events are stamped on one clock."""
    t = PhaseTimer()
    tol = 100_000
    with cpu_profile() as prof:
        with t.span("s"):
            torch.ones(1 << 10).mul(2.0)
    r = t.records[0]
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mul")
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert r.start_ns - tol <= start and end <= r.end_ns + tol


def test_a_span_records_only_if_opened_under_the_profile():
    """A span open when the profile starts records nothing; spans opened
    inside it start requests of their own."""
    t = PhaseTimer()
    with t.span("outer"):
        with cpu_profile():
            with t.span("inner"):
                pass
        with t.span("after"):
            pass
    assert [r.name for r in t.records] == ["inner"]
    inner = t.records[0]
    assert inner.parent == -1 and inner.request == inner.id
    assert t.counts == {"outer": 1, "inner": 1, "after": 1}


def test_a_span_open_when_the_profile_stops_is_recorded():
    t = PhaseTimer()
    with t.span("open"):
        with cpu_profile():
            cm = t.span("late")
            cm.__enter__()
        cm.__exit__(None, None, None)
    assert [r.name for r in t.records] == ["late"]


def test_reset_forgets_records_and_ids_stay_unique():
    t = PhaseTimer()
    with cpu_profile():
        with t.span("a"):
            pass
        first = t.records[0].id
        t.reset()
        assert t.records == [] and not t.counts
        with t.span("a"):
            pass
    assert t.records[0].id != first and t.counts == {"a": 1}


def test_count_adds_always_and_records_only_while_recording():
    t = PhaseTimer()
    t.count("c")
    with t.span("a"):
        t.count("c")
    assert t.counts == {"a": 1, "c": 2} and t.records == []
    assert "c" not in t.totals
    with cpu_profile():
        t.count("c")
        with t.span("a"):
            t.count("c")
    assert t.counts == {"a": 2, "c": 4}
    first, a, inner = by_opening(t.records)
    assert (first.name, a.name, inner.name) == ("c", "a", "c")
    assert first.start_ns == first.end_ns and first.parent == -1 \
        and first.request == first.id
    assert inner.start_ns == inner.end_ns
    assert a.start_ns <= inner.start_ns <= a.end_ns
    assert inner.parent == a.id and inner.request == a.id


def test_predict_input_spans(global_timer):
    cw = np.zeros(19, np.float32)
    cw[[0, 1, 2, 10]] = 1.0
    net = SemanticNetwork(fold_student(init_student_params(0, device="cpu")),
                          class_weights_exp=cw, height=32, frozen=True,
                          device="cpu")
    frames = np.random.RandomState(0).randint(0, 256, (2, 32, 64, 3)) \
        .astype(np.uint8)
    net.predict_input(frames)
    assert global_timer.records == []
    with cpu_profile():
        ids = net.predict_input(frames)
    assert ids.shape == (2, 32, 64)
    recs = by_opening(global_timer.records)
    assert [r.name for r in recs] == [
        "network/predict_input", "network/stage", "network/forward",
        "network/download"]
    assert children(recs, recs[0]) == [r.name for r in recs[1:]]
    assert {r.request for r in recs} == {recs[0].id}
    assert global_timer.counts["network/predict_input"] == 2


def test_label_spans(global_timer):
    label = make_teacher_labeler(compute_dtype="float32", batch=2,
                                 device="cpu")
    frames = np.random.RandomState(1).randint(0, 256, (5, 8, 16, 3)) \
        .astype(np.uint8)
    with cpu_profile():
        out = label(frames)
    assert out.shape == (5, 8, 16) and out.dtype == np.uint8
    recs = by_opening(global_timer.records)
    assert recs[0].name == "labeler/label" and recs[0].parent == -1
    assert children(recs, recs[0]) == ["labeler/pad"] \
        + ["labeler/chunk"] * 3 + ["labeler/join", "labeler/unpad"]
    for chunk in spans.named(recs, "labeler/chunk"):
        assert children(recs, chunk) == ["labeler/upload",
                                         "labeler/forward",
                                         "labeler/download"]
    for forward in spans.named(recs, "labeler/forward"):
        assert children(recs, forward) == ["teacher/trunk", "teacher/aspp"]
    assert len(recs) == 1 + 1 + 3 * 6 + 2
    assert {r.request for r in recs} == {recs[0].id}


def rec(name, start, end, ident=0, parent=-1):
    return SpanRecord(name, start, end, ident, parent, 0, 0)


def synthetic_trace():
    """Busy [100, 200) and [300, 400) ns."""
    return Trace([("k", 100, 200), ("k", 300, 400)], [], 1.0)


def test_idle_inside_gives_exact_nanoseconds():
    t = synthetic_trace()
    recs = [rec("a", 150, 350), rec("b", 340, 600), rec("c", 0, 1000)]
    # a alone: 200 long, busy 50 + 50
    assert spans.idle_inside(t, recs, ("a",)) == 100
    # a and b: union [150, 600) is 450 long, busy 50 + 100
    assert spans.idle_inside(t, recs, ("a", "b")) == 300
    assert spans.idle_inside(t, recs, ("b",)) == 260 - 60
    assert spans.idle_inside(t, recs, ("nothing",)) == 0
    assert spans.idle_inside(t, recs, ("c",)) == 800


def test_named_and_mean_self_time():
    recs = [rec("req", 0, 10, 0), rec("req", 20, 30, 1),
            rec("child", 22, 26, 2, parent=1)]
    assert len(spans.named(recs, "req")) == 2
    assert spans.mean_self_ns(recs, "req") == (10 + 6) / 2
    assert spans.mean_self_ns(recs, "child") == 4
    assert spans.mean_self_ns(recs, "other") is None


def load_reader(name):
    path = os.path.join(ROOT, "perfbench", "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_returns_none_without_records(name, global_timer):
    reader = load_reader(name)
    assert reader.read(SimpleNamespace(trace_data=None)) is None
    assert reader.read(SimpleNamespace(trace_data=synthetic_trace())) is None


@pytest.mark.parametrize("name,want", [
    # host steps pad [0, 100), unpad [400, 450), join [1400, 1450): no
    # busy time in them, 200 ns over two calls
    ("label_idle_host_ms_per_call", 200 / 2 / 1e6),
    ("label_idle_host_ms_per_call.os8", 200 / 2 / 1e6),
    # forward [2030, 2080) less its child [2040, 2065)
    ("client_dispatch_ms_per_batch", 25 / 1e6),
    # one fresh block among four pinned downloads
    ("client_pinned_reuse_pct", 75.0),
    # three offsets in an epilogue, one as a pass
    ("teacher_bn_epilogue_pct.label", 75.0),
    ("teacher_bn_epilogue_pct.os8", 75.0),
])
def test_reader_reads_the_records(name, want, global_timer, monkeypatch):
    recs = [rec("labeler/label", 0, 450, 0), rec("labeler/pad", 0, 100, 1, 0),
            rec("labeler/unpad", 400, 450, 2, 0),
            rec("labeler/label", 1000, 1500, 3),
            rec("labeler/join", 1400, 1450, 4, 3),
            rec("network/predict_input", 2000, 2100, 5),
            rec("network/stage", 2000, 2030, 6, 5),
            rec("network/forward", 2030, 2080, 7, 5),
            rec("k1", 2040, 2065, 8, 7),
            rec("network/pinned_download", 2090, 2090, 9, 5),
            rec("network/pinned_fresh", 2090, 2090, 10, 5)] \
        + [rec("network/pinned_download", t, t, 11 + i)
           for i, t in enumerate((3000, 3100, 3200))] \
        + [rec("teacher/bn_epilogue", t, t, 14 + i, 3)
           for i, t in enumerate((1100, 1110, 1120))] \
        + [rec("teacher/bn_pass", 1130, 1130, 17, 3)]
    monkeypatch.setattr(global_timer, "records", recs)
    got = load_reader(name).read(SimpleNamespace(trace_data=synthetic_trace()))
    assert got == pytest.approx(want)
