"""Whole runs of the harness on the CPU at a test's size, its look for a
chip skipped: a cell added from new files only, each fault a cell can
have planted under the timed path (``correct`` comes out false), the
sound program (``correct`` true), and the control (the reference one
precision step down in the program's place) failing the cell's limits.

The checkout is copied into a temporary directory and its traffic mixes
cut to 64x128 frames (the round) and 32x64 (the others); the limits are
the cells' own, set at their full size (``perfbench/limits``; readings in
PERF.md); the cells held out of BENCHMARK.json (``perfbench/parked``) are
added back to the copy."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import control, harness
from perfbench.lib.traffic import Schedule

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 977        # more than 32 signed bits hold
SMALL = {
    "round.batched4": dict(height=64, width=128, memory_frames=12,
                           minibatch=4, iters=4, calibration_frames=4),
    # the labeler's chunk at 32 rows is 32 frames: a request of 32 leaves
    # no padded rows, so a fault in half the chunk reaches the answers
    "label.b16": dict(height=32, width=64, batch=32, pool_batches=1,
                      sample_requests=1, calibration_frames=2),
    "edge.b16": dict(height=32, width=64, batch=2, pool_batches=2,
                     sample_requests=2, calibration_frames=2),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark's files with the mixes cut to a test's
    size."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "perfbench", r / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for path in sorted((ROOT / "perfbench" / "parked").glob("*.json")):
        parked = json.loads(path.read_text())   # a held-out cell, added back
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += parked[key]
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, over in SMALL.items():
        path = r / "perfbench" / "traffic" / (name + ".json")
        mix = json.loads(path.read_text())
        mix.update(over)
        path.write_text(json.dumps(mix))
    return r


def run(root, workload, seconds=0.5, trace=False):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return harness.run_cell(root, bench, workload, SEED, seconds, trace,
                            "cpu")


def test_a_cell_from_new_files_only(root, tmp_path):
    """An open-loop cell of the edge client with metrics of its own (its
    tail end to end, a per-layer count): one traffic file, one limits
    file, a reader per metric, and entries in BENCHMARK.json; no file of
    the benchmark edited."""
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    pb = new / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    mix = json.loads((pb / "traffic" / "edge.b16.json").read_text())
    mix.update(loop="open", rate_per_s=40, arrivals="poisson")
    (pb / "traffic" / "edge.open40.json").write_text(json.dumps(mix))
    (pb / "limits" / "student.edge.open40.json").write_bytes(
        (pb / "limits" / "student.edge.b16.json").read_bytes())
    (pb / "layer_metrics" / "answered.open40.py").write_text(
        "def read(ctx):\n    return ctx.window['attempted']\n")
    (pb / "e2e" / "client_open_p95_ms.py").write_text(
        "from perfbench.lib.readers import percentile_ms\n\n\n"
        "def read(ctx):\n    return percentile_ms(ctx, 95)\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "student.edge.open40",
        "config": "mnv2-deeplabv3-os16-cityscapes", "traffic": "edge.open40",
        "chips": 1, "why": "open loop at 40 batches/s"})
    for m in bench["end_to_end"]:
        if m["name"] == "client_frames_per_s":
            m["workloads"].append("student.edge.open40")
    bench["end_to_end"].append({
        "name": "client_open_p95_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["student.edge.open40"]})
    bench["per_layer"].append({
        "name": "answered.open40", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "facade",
        "moves": "client_frames_per_s", "workloads": ["student.edge.open40"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    e2e = run(new, "student.edge.open40", seconds=1.0)
    assert e2e["correct"] and set(e2e["metrics"]) == {
        "client_frames_per_s", "client_open_p95_ms", "setup_s"}
    sched, due = Schedule(mix, SEED), 0
    while sched.next_due() < 1.0:       # the requests due in the window
        due += 1
    assert 1 <= e2e["attempted"] <= due
    layer = run(new, "student.edge.open40", seconds=1.0, trace=True)
    assert layer["metrics"]["answered.open40"]["value"] == layer["attempted"]
    assert list(layer)[-1] == "checks"


@pytest.mark.parametrize("workload", ["student.round.batched4",
                                      "teacher.label.b16",
                                      "student.edge.b16"])
def test_sound_program_is_correct(root, workload):
    result = run(root, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"]["setup_s"]["value"] > 0
    assert list(result)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from ams_tpu_torch.distill import optimizer, train_step

    adam = optimizer.adam_apply

    def still(params, grads, state, lr):
        return dict(params), adam(params, grads, state, lr)[1]
    monkeypatch.setattr(optimizer, "adam_apply", still)
    monkeypatch.setattr(train_step, "_bn_update", lambda bn, stats: bn)


def _half_minibatch(monkeypatch):
    from ams_tpu_torch.distill import train_step

    loss = train_step._round_loss

    def half(spec, p, bn, frames, labels, cm, cdtype, reduce=None):
        n = frames.shape[0] // 2
        return loss(spec, p, bn, frames[:n], labels[:n], cm, cdtype, reduce)
    monkeypatch.setattr(train_step, "_round_loss", half)


def _k1(monkeypatch, alter):
    from ams_tpu_torch.ops import fused_resize_argmax as k1

    real = k1.fused_resize_argmax

    def broken(grid, out_hw, class_index=None):
        return alter(grid, out_hw, class_index, real)
    monkeypatch.setattr(k1, "fused_resize_argmax", broken)


def _half_frames(monkeypatch):
    def alter(grid, out_hw, ci, real):
        n = grid.shape[0] // 2
        ids = real(grid[:n], out_hw, ci)
        return torch.cat([ids, torch.zeros_like(ids)])
    _k1(monkeypatch, alter)


def _id_altered(monkeypatch):
    def alter(grid, out_hw, ci, real):
        ids = real(grid, out_hw, ci)
        n = grid.shape[1] if ci is None else len(ci)
        ids[0] = (ids[0] + 1) % n
        return ids
    _k1(monkeypatch, alter)


@pytest.mark.parametrize("workload,fault", [
    ("student.round.batched4", _state_unchanged),
    ("student.round.batched4", _half_minibatch),
    ("teacher.label.b16", _half_frames),
    ("teacher.label.b16", _id_altered),
    ("student.edge.b16", _half_frames),
    ("student.edge.b16", _id_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(root, workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["student.round.batched4",
                                      "teacher.label.b16",
                                      "student.edge.b16"])
def test_control_fails_the_limits(root, workload):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    limits = json.loads((root / "perfbench" / "limits"
                         / (workload + ".json")).read_text())
    recs = [r for r in control.readings(bench, workload, [], [SEED], 0.5,
                                        "cpu", root=root)
            if r["kind"] == "control"]
    assert recs
    for r in recs:
        assert any(v > limits[k]["limit"] for k, v in r["numbers"].items()
                   if k in limits), r
