"""``python -m ams_tpu_torch.cli.convert`` against ams_tpu's ``ams-convert``,
on the CPU: the counterparts of the 3 tests of tests/test_convert_cli.py
(.npy -> .npz round trip, the BN-folded deployment dict, the extension
added for a declared format), plus a TF1 checkpoint prefix converted
without TensorFlow and ``--fold`` equal to JAX's CLI output, each array
bitwise; the flags are JAX's plus ``--device`` (the GPU unless
``--device cpu``, so without a card the default raises), and ``--format
orbax`` (the default for a directory) writes an Orbax directory that
JAX's ``load_orbax`` reads, and reads JAX's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from ams_tpu.cli.convert import main as jax_main
from ams_tpu.models.mobilenetv2_deeplab import init_student_params
from ams_tpu.utils.checkpoint import load_orbax as jax_load_orbax

from ams_tpu_torch.cli import convert as tconvert
from ams_tpu_torch.utils.checkpoint import load_any, load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def npy_ckpt(tmp_path_factory):
    params = {k: np.asarray(v)
              for k, v in init_student_params(jax.random.PRNGKey(3)).items()}
    path = str(tmp_path_factory.mktemp("conv") / "student.npy")
    np.save(path, params, allow_pickle=True)
    return path, params


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_npy_to_npz_roundtrip(npy_ckpt, tmp_path):
    src, params = npy_ckpt
    dst = str(tmp_path / "student.npz")
    tconvert.main([src, dst, "--device", "cpu"])
    _assert_bitwise(_npz(dst), params)


def test_convert_fold_emits_deployment_dict(npy_ckpt, tmp_path):
    src, params = npy_ckpt
    dst = str(tmp_path / "deploy.npz")
    tconvert.main([src, dst, "--fold", "--device", "cpu"])
    out = _npz(dst)
    assert any(k.endswith("/folded_bias") for k in out)
    assert not any("BatchNorm" in k for k in out)
    assert len(out) < len(params)
    jax_main([src, str(tmp_path / "jax_deploy.npz"), "--fold"])
    _assert_bitwise(out, _npz(str(tmp_path / "jax_deploy.npz")))


def test_convert_appends_extension_for_declared_format(npy_ckpt, tmp_path):
    src, _ = npy_ckpt
    dst = str(tmp_path / "plain")
    tconvert.main([src, dst, "--format", "npy", "--device", "cpu"])
    reloaded = load_params(dst + ".npy")
    assert "MobilenetV2/Conv/weights" in reloaded
    # --format orbax, and a destination with neither extension, write an
    # Orbax directory, as ams-convert does; each package reads the other's
    ours, ref = str(tmp_path / "dir"), str(tmp_path / "jax_dir")
    for argv in ([src, ours, "--format", "orbax", "--device", "cpu"],
                 [src, ours + "_default", "--device", "cpu"]):
        tconvert.main(argv)
        _assert_bitwise(jax_load_orbax(argv[1]), reloaded)
    jax_main([src, ref])
    _assert_bitwise(load_any(ref), jax_load_orbax(ref))
    back = str(tmp_path / "back.npz")
    tconvert.main([ref, back, "--device", "cpu"])
    jax_main([ours, str(tmp_path / "jax_back.npz")])
    _assert_bitwise(_npz(back), _npz(str(tmp_path / "jax_back.npz")))


def test_tf_prefix_converts_as_jax_does(tmp_path):
    for extra in ([], ["--fold"]):
        ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
        proc = subprocess.run(
            [sys.executable, "-m", "ams_tpu_torch.cli.convert", FIXTURE, ours,
             *extra, "--device", "cpu"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "loaded 272 variables" in proc.stdout
        jax_main([FIXTURE, ref, *extra])
        _assert_bitwise(_npz(ours), _npz(ref))


def test_runs_on_the_card_unless_asked(npy_ckpt, tmp_path, monkeypatch):
    src, params = npy_ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dst = str(tmp_path / "deploy.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.main([src, dst, "--fold"])
    assert not os.path.exists(dst)
    tconvert.main([src, dst, "--fold", "--device", "cpu"])
    assert len(_npz(dst)) < len(params)


def test_flags_match_jax():
    import argparse

    def actions(parser):
        return {a.dest: (a.default, a.choices, a.required, a.nargs)
                for a in parser._actions if a.dest != "help"}

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jax_main(["a", "b"])
    finally:
        argparse.ArgumentParser.parse_args = real
    ours = actions(tconvert.build_parser())
    assert ours.pop("device") == ("cuda", ["cuda", "cpu"], False, None)
    assert ours == actions(captured["parser"])
