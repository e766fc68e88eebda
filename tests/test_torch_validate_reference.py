"""``tools/torch_validate_reference.py``, the port's real-data validation
gate, against ``tools/validate_reference.py`` (JAX and TensorFlow), on the
CPU and the committed TF1 fixture (``tests/fixtures/student_tf1/model``):

* ``inventory`` prints JAX's verdict line for line (OK at 19 classes, the
  same SHAPE mismatches at 21);
* ``convert`` writes a ``student.npy`` equal byte for byte to JAX's;
* ``simple`` runs ``--mode pretrained`` and ``--mode simple`` end to end
  on a synthetic frame-directory clip, prints both mIoUs and holds the 0.5
  gate; the test shortens the round to 2 iterations by handing the tool a
  ``RunConfig`` with fewer iterations (the tool has no flag for it);
* ``bitmatch`` is not ported: asking for it exits 1 with its message;
* the tool runs with jax, ams_tpu, TensorFlow, cv2, orbax, tensorstore and
  zstandard blocked.
"""

import argparse
import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ams_tpu_torch.data.video import write_synthetic_clip
from ams_tpu_torch.runtime.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF1 = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")
BLOCKED = ("jax", "jaxlib", "ams_tpu", "cv2", "orbax", "tensorflow",
           "tensorstore", "zstandard")


def _load(name, filename):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_validate_reference", "torch_validate_reference.py")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tool():
    return _load("validate_reference", "validate_reference.py")


def _ns(workdir, num_classes=19):
    return argparse.Namespace(checkpoint=TF1, num_classes=num_classes,
                              workdir=str(workdir))


@pytest.mark.parametrize("num_classes", [19, 21])
def test_inventory_prints_jax_verdict(num_classes, jax_tool, tmp_path,
                                      capsys):
    ok = tool.stage_inventory(_ns(tmp_path, num_classes))
    ours = capsys.readouterr().out
    jok = jax_tool.stage_inventory(_ns(tmp_path, num_classes))
    theirs = capsys.readouterr().out
    assert ok == jok == (num_classes == 19)
    assert ours == theirs
    assert ours.splitlines()[-1] == "[inventory] %s (272 vars)" % (
        "OK" if num_classes == 19 else "FAILED")


def test_convert_writes_jax_student_npy(jax_tool, tmp_path, capsys):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    assert tool.stage_convert(_ns(ours))
    out = capsys.readouterr().out
    assert "[convert] OK: 272/272 params from the checkpoint" in out
    assert jax_tool.stage_convert(_ns(theirs))
    with open(ours / "student.npy", "rb") as f, \
            open(theirs / "student.npy", "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    path = str(root / "90-synthetic")
    gt = str(root / "gt") + "/"
    write_synthetic_clip(path, seconds=8, fps=5, size_hw=(64, 128),
                         gt_dir=gt, style="bands")
    return path, gt


def test_simple_runs_both_modes_and_holds_the_gate(clip, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(tool, "RunConfig",
                        functools.partial(RunConfig, iter=2, batch_size=2))
    video, gt = clip
    argv = ["--checkpoint", TF1, "--video", video, "--gt_dir", gt,
            "--height", "32", "--device", "cpu", "--workdir",
            str(tmp_path / "wd")]
    assert tool.main(argv + ["--reference_miou", "0.0"]) == 0
    out = capsys.readouterr().out
    assert "[inventory] OK (272 vars)" in out
    assert "[convert] OK: 272/272" in out
    mious = {}
    for line in out.splitlines():
        if "rolling-window mIoU = " in line:
            mode = line.split()[1]
            mious[mode] = float(line.split("= ")[1].split()[0])
    assert sorted(mious) == ["pretrained", "simple"]
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in mious.values())
    assert "(gate: <= 0.5) -> OK" in out
    assert out.splitlines()[-1] == "all requested stages passed"
    for mode in ("pretrained", "simple"):
        assert os.listdir(tmp_path / "wd" / mode)
    # the gate: a reference more than 0.5 away fails the stage
    assert tool.main(argv + ["--stages", "simple",
                             "--reference_miou", "2.0"]) == 1
    out = capsys.readouterr().out
    assert "-> FAILED" in out and "FAILED stages: simple" in out


def test_simple_needs_the_converted_checkpoint_and_a_clip(tmp_path, capsys):
    wd = str(tmp_path / "wd")
    base = ["--checkpoint", TF1, "--device", "cpu", "--workdir", wd,
            "--stages", "simple"]
    assert tool.main(base) == 0
    assert "[simple] skipped: --video not given" in capsys.readouterr().out
    assert tool.main(base + ["--video", "x", "--gt_dir", "g"]) == 1
    assert "[simple] run the convert stage first" in \
        capsys.readouterr().out


def test_bitmatch_is_not_ported(tmp_path, capsys):
    argv = ["--checkpoint", TF1, "--workdir", str(tmp_path / "wd"),
            "--device", "cpu"]
    assert tool.main(argv + ["--stages", "inventory,bitmatch"]) == 1
    out = capsys.readouterr().out
    assert out.strip() == tool.BITMATCH_MESSAGE
    assert "tools/validate_reference.py" in out
    assert not os.path.exists(tmp_path / "wd")      # nothing ran


_CHILD = r"""
import runpy, sys

BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
sys.argv = %r
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    raise
"""


def test_the_tool_runs_with_jax_tf_cv2_orbax_blocked(tmp_path):
    argv = [os.path.join(REPO, "tools", "torch_validate_reference.py"),
            "--checkpoint", TF1, "--stages", "inventory,convert",
            "--workdir", str(tmp_path / "wd"), "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-c", _CHILD % (BLOCKED, argv)],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[inventory] OK (272 vars)" in proc.stdout
    assert proc.stdout.splitlines()[-1] == "all requested stages passed"
