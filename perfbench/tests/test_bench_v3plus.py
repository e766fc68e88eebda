"""The DeepLabV3+ cell, ``teacher.os8.label.b8``: its reference's variables
against the configuration's count, its FLOP count at the cell's shape,
the entry's facts against the traffic, and whole runs of the harness on
the CPU at a test's size (the sound program correct, a fault or the
control not), as ``test_bench_cells.py`` holds the other cells.

The checkout is copied into a temporary directory and the mix cut to
requests of 32 frames of 32x64: the labeler's chunk at 32 rows is 32
frames, so no padded rows hide a fault in half the chunk.  The limit is
the cell's own, set at its full size (``perfbench/limits``; readings in
PERF.md)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.counts import teacher_v3plus as counts
from perfbench.reference import teacher_v3plus as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = "teacher.os8.label.b8"
SEED = 2 ** 31 + 977        # more than 32 signed bits hold
SMALL = dict(height=32, width=64, batch=32, pool_batches=1,
             sample_requests=1, calibration_frames=2)


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _config():
    bench = _bench()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return json.loads((ROOT / conf["file"]).read_text())


def test_reference_variables_are_the_configurations_count():
    specs = ref.param_specs(_config()["num_classes"])
    assert sum(int(np.prod(s)) for _, s, _ in specs) == \
        _config()["parameters"] == 41_257_699
    decoder = [s for n, s, _ in specs if n.startswith("decoder/")]
    assert sum(int(np.prod(s)) for s in decoder) == \
        _config()["parameters_of_the_decoder"] == 165_168


def test_flops_at_the_cells_shape():
    """2.78 TFLOP per padded 1025x2049 frame at output stride 8, 3.5x the
    same frame at 16 without the decoder's stride-4 work."""
    one = counts.infer(1, 1025, 2049)
    assert one == pytest.approx(2.777e12, rel=0.01)
    assert counts.infer(8, 1025, 2049) == 8 * one
    assert counts.infer(1, 1025, 2049, 16) < one / 3


def _context(root, traffic_over=None):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    ctx = harness.Context(root, bench, cell, SEED, 0.5, False, "cpu")
    ctx.traffic.update(traffic_over or {})
    return ctx


def test_entry_facts_follow_the_traffic(monkeypatch):
    """At the mix's own size, without running a teacher: K1's shape is
    the decoder's grid of the padded frames, the labeler gets the
    configuration's teacher."""
    from ams_tpu_torch.models import xception_deeplab as tx
    from ams_tpu_torch.runtime import labeler

    ctx = _context(ROOT)
    entry = harness.load_module(ROOT / "perfbench" / "entries"
                                / "labeler_v3plus.py", "entry_v3plus")
    made = []
    monkeypatch.setattr(entry, "inputs", lambda ctx: {
        "params": {}, "batches": np.zeros((1, 8, 1, 1, 3), np.uint8)})
    monkeypatch.setattr(labeler, "make_teacher_labeler",
                        lambda **kw: made.append(kw) or (lambda f: f))
    entry.setup(ctx)
    tr = ctx.traffic
    assert (tr["batch"], tr["height"], tr["width"]) == (8, 1024, 2048)
    assert ctx.facts["k1"] == dict(b=8, c=19, gh=257, gw=513, h=1025,
                                   w=2049, elem_bytes=2)
    assert ctx.facts["infer_shape"] == ("teacher_v3plus", 8, 1025, 2049)
    assert made[0]["teacher_config"] == tx.DEEPLABV3PLUS_OS8
    assert made[0]["compute_dtype"] == "bfloat16"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark's files with the cell's mix cut to a test's
    size."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "perfbench", r / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", r / "BENCHMARK.json")
    bench = _bench()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    path = r / "perfbench" / "traffic" / (cell["traffic"] + ".json")
    mix = json.loads(path.read_text())
    mix.update(SMALL)
    path.write_text(json.dumps(mix))
    return r


def run(root, trace=False):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return harness.run_cell(root, bench, CELL, SEED, 0.5, trace, "cpu")


def test_sound_program_is_correct_and_k1_reads_the_facts(root, monkeypatch):
    from ams_tpu_torch.ops import fused_resize_argmax as k1

    grids, real = [], k1.fused_resize_argmax

    def spy(grid, out_hw, class_index=None):
        grids.append((tuple(grid.shape), tuple(out_hw)))
        return real(grid, out_hw, class_index)
    spy.launches = 0
    monkeypatch.setattr(k1, "fused_resize_argmax", spy)
    result = run(root)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"label_frames_per_s", "setup_s"}
    # K1 at the shape the entry records: 32 frames of 33x65, grid 9x17
    assert set(grids) == {((32, 19, 9, 17), (33, 65))}


def _k1(monkeypatch, alter):
    from ams_tpu_torch.ops import fused_resize_argmax as k1

    real = k1.fused_resize_argmax

    def broken(grid, out_hw, class_index=None):
        return alter(grid, out_hw, class_index, real)
    broken.launches = 0
    monkeypatch.setattr(k1, "fused_resize_argmax", broken)


def _half_frames(grid, out_hw, ci, real):
    n = grid.shape[0] // 2
    ids = real(grid[:n], out_hw, ci)
    return torch.cat([ids, torch.zeros_like(ids)])


def _id_altered(grid, out_hw, ci, real):
    ids = real(grid, out_hw, ci)
    ids[0] = (ids[0] + 1) % grid.shape[1]
    return ids


def _coarse_grid(grid, out_hw, ci, real):
    """The grid at half the decoder's resolution, the ASPP's at output
    stride 8: as if the decoder were left out."""
    coarse = torch.nn.functional.interpolate(
        grid.float(), size=(-(-grid.shape[2] // 2), -(-grid.shape[3] // 2)),
        mode="bilinear", align_corners=True).to(grid.dtype)
    return real(coarse, out_hw, ci)


@pytest.mark.parametrize("alter", [_half_frames, _id_altered, _coarse_grid],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, monkeypatch, alter):
    _k1(monkeypatch, alter)
    result = run(root)
    assert not result["correct"], result["checks"]


def test_control_reads_far_above_the_sound_program(root):
    """The control (the reference in fp8 e4m3 in the program's place)
    against the sound program at the test's size.  Its full-size
    readings, which the limit lies below, come from
    ``perfbench/control.py`` on the card: here, at 33x65, it reads below
    the limit (PERF.md), so the test holds it to the sound program's
    reading instead."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    recs = list(control.readings(bench, CELL, [SEED], [SEED], 0.5, "cpu",
                                 root=root))
    program = [r["numbers"]["served_gap"] for r in recs
               if r["kind"] == "program"]
    ctl = [r["numbers"]["served_gap"] for r in recs if r["kind"] == "control"]
    assert program and ctl
    assert min(ctl) > 4 * max(program)
