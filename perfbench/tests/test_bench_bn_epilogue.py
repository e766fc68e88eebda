"""The teacher's BN-epilogue readers (``teacher_bn_epilogue_pct.label``,
``teacher_bn_epilogue_pct.os8``): the share of the program's
``teacher/bn_epilogue`` counter records among those and its
``teacher/bn_pass`` records, with the records patched in.  A program that
runs BN unfolded (the parent of the change that folded it) has neither
record: the readers read nothing."""

from pathlib import Path
import types

import pytest

from ams_tpu_torch.utils.trace import GLOBAL_TIMER, SpanRecord
from perfbench import harness
from perfbench.lib.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
READERS = ("teacher_bn_epilogue_pct.label", "teacher_bn_epilogue_pct.os8")


def _reader(name):
    return harness.load_module(ROOT / "perfbench" / "layer_metrics"
                               / (name + ".py"),
                               "test_metric_" + name.replace(".", "_"))


def _records(chunks, fused, passes):
    """Per chunk a ``teacher/decoder`` span and the zero-length counter
    records ``PhaseTimer.count`` leaves inside the labeler's forward."""
    recs, ident = [], 0
    for c in range(chunks):
        forward = ident
        recs.append(SpanRecord("labeler/forward", 10 * c, 10 * c + 9,
                               forward, -1, forward, 1))
        ident += 1
        for name, n in (("teacher/bn_epilogue", fused),
                        ("teacher/bn_pass", passes)):
            for _ in range(n):
                recs.append(SpanRecord(name, 10 * c + 1, 10 * c + 1, ident,
                                       forward, forward, 1))
                ident += 1
    return recs


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(GLOBAL_TIMER, "records", [])
    return types.SimpleNamespace(trace_data=Trace([("k", 0, 100)], [], 1e-6))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("chunks,fused,passes", [
    (2, 131, 15),       # the OS8 teacher's sites
    (3, 76, 65),        # the AMS teacher's
    (1, 4, 0),          # every offset in an epilogue
    (1, 0, 4),          # none
])
def test_share_of_offsets_in_an_epilogue(ctx, name, chunks, fused, passes):
    GLOBAL_TIMER.records = _records(chunks, fused, passes)
    assert _reader(name).read(ctx) == \
        pytest.approx(100.0 * fused / (fused + passes))


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_records_or_a_trace(ctx, name):
    """The parent: spans but no counter records; or no trace at all."""
    GLOBAL_TIMER.records = _records(2, 0, 0)
    assert _reader(name).read(ctx) is None
    GLOBAL_TIMER.records = _records(2, 131, 15)
    ctx.trace_data = None
    assert _reader(name).read(ctx) is None
