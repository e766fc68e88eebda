"""The port's live CLIs end to end: ``python -m ams_tpu_torch.cli.serve``
and ``python -m ams_tpu_torch.cli.edge`` as subprocesses over localhost
TCP, with ``--device cpu``, on a frame-directory clip; the restart and
resume flow; the emulation-format artifact set and its cross-sums; the
parsers against ams_tpu's; the refusal of ``--device cuda`` without a
card; and the edge's scoring against the JAX CLI's arithmetic, which has
two faults the port does not copy.

The server runs with ``--label_batch 2`` (the teacher's chunk, so the CPU
does not pad each 2-frame draw to 32) and the edge at ``--height 32``.
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from ams_tpu import configs as jconfigs
from ams_tpu.utils.metrics import calculate_miou as jax_calculate_miou

from ams_tpu_torch.cli import edge as tedge
from ams_tpu_torch.cli import serve as tserve
from ams_tpu_torch.data.video import write_synthetic_clip
from ams_tpu_torch.distill.loss import reduce_labels
from ams_tpu_torch.utils.metrics import calculate_miou, confusion_matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _serve(resume_dir, log_path, *extra):
    """The server on a free port (``--port 0``), its output to a file:
    -> (process, port read from its first line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ams_tpu_torch.cli.serve", "--port", "0",
         "--max_clients", "1", "--resume_dir", resume_dir, "--label_batch",
         "2", "--device", "cpu", *extra],
        env=_env(), cwd=ROOT, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT)
    deadline = time.time() + 120.0
    while time.time() < deadline:
        text = open(log_path).read()
        if "ams live server on " in text:
            addr = text.split("ams live server on ")[1].split()[0]
            return proc, int(addr.rsplit(":", 1)[1])
        if proc.poll() is not None:
            raise RuntimeError("server exited: %s" % text)
        time.sleep(0.2)
    proc.kill()
    raise TimeoutError("server never printed its address")


def _edge(port, video, out_dir, max_seconds, extra=()):
    return subprocess.run(
        [sys.executable, "-m", "ams_tpu_torch.cli.edge",
         "--server", "127.0.0.1:%d" % port, "--input_video", video,
         "--height", "32", "--send_period", "2", "--train_period", "2",
         "--iter", "2", "--batch_size", "2", "--client_id", "camA",
         "--max_seconds", str(max_seconds), "--output_dir", out_dir,
         "--device", "cpu", *extra],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=240)


def _stop(proc, log_path):
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 0
    return open(log_path).read()


def _artifacts(art):
    base = os.path.join(art, "90_live_results")
    dn = np.load(base + "_bw_downlink.npy")
    up = np.load(base + "_bw_uplink.npy")
    fpc = np.load(base + "_fps_client.npy")
    mt = np.load(base + "_model_update_times.npy")
    lines = open(base + "_update.txt").read().split("\n")
    # the emulation's invariants: exact per-delta bits, per-period sample
    # counts, cross-sums against the 5-line summary
    assert int(lines[0]) == dn.sum()
    assert int(lines[1]) == up.sum()
    assert int(lines[2]) == len(dn)
    assert int(lines[4]) == fpc.sum()
    assert len(mt) == len(dn) + 1
    assert os.path.exists(base + "_wall_fps.npy")
    return base, dn, lines


def test_live_cli_session_and_resume(tmp_path):
    video = str(tmp_path / "90-synthetic")
    gt = str(tmp_path / "gt")
    write_synthetic_clip(video, seconds=14, fps=10, size_hw=(64, 128),
                         gt_dir=gt)
    resume_dir = str(tmp_path / "resume")
    art = str(tmp_path / "art")
    log1 = str(tmp_path / "srv1.log")
    srv, port = _serve(resume_dir, log1)
    try:
        r1 = _edge(port, video, art, max_seconds=7, extra=("--gt_dir", gt))
        assert r1.returncode == 0, r1.stdout + r1.stderr
        assert "3 deltas applied" in r1.stdout, r1.stdout
        assert "gt mIoU: pre-first-delta mean" in r1.stdout
        text = _stop(srv, log1)
    finally:
        if srv.poll() is None:
            srv.kill()
    assert "served 3 rounds across 1 sessions" in text, text
    assert text.count("[live] t=") == 6, text   # 3 labeled + 3 rounds
    base, dn, lines = _artifacts(art)
    assert len(dn) == 3 and int(lines[3]) == 7
    scores = np.load(base + "_miou_live.npy")
    assert scores.shape == (14, 2) and np.isfinite(scores[:, 1]).all()
    assert os.path.exists(
        os.path.join(resume_dir, "live_camA_resume_state.npz"))

    # restart: a fresh server process on the same resume_dir hands the
    # reconnecting client_id its session; the edge fast-forwards
    log2 = str(tmp_path / "srv2.log")
    srv2, port2 = _serve(resume_dir, log2)
    try:
        r2 = _edge(port2, video, str(tmp_path / "art2"), max_seconds=12)
        assert r2.returncode == 0, r2.stdout + r2.stderr
        assert "resumed session at t=6s" in r2.stdout, r2.stdout
        assert "streamed 60 frames" in r2.stdout, r2.stdout
        text2 = _stop(srv2, log2)
    finally:
        if srv2.poll() is None:
            srv2.kill()
    assert "served 3 rounds across 1 sessions" in text2, text2
    _, dn2, lines2 = _artifacts(str(tmp_path / "art2"))
    assert len(dn2) == 3 and int(lines2[3]) == 6


def _jax_parser(module_name):
    """The parser that ams_tpu's CLI ``main`` builds inline."""
    import importlib

    mod = importlib.import_module(module_name)
    seen = {}

    class Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise Caught()

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(Caught):
            mod.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"]


def _actions(parser):
    return {a.dest: (a.default, a.choices, a.required, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["serve", "edge"])
def test_live_cli_flags_match_jax(name):
    ours = _actions((tserve if name == "serve" else tedge).build_parser())
    want = _actions(_jax_parser("ams_tpu.cli." + name))
    assert ours.pop("device") == ("cuda", ["cuda", "cpu"], False, None, None)
    assert ours.pop("gpu") == ("0", None, False, None, None)
    assert ours == want


@pytest.mark.parametrize("name", ["serve", "edge"])
def test_live_cli_refuses_cuda_without_a_card(name, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    argv = ["--port", "0"] if name == "serve" else [
        "--server", "127.0.0.1:9", "--input_video", str(tmp_path / "90-x")]
    r = subprocess.run([sys.executable, "-m", "ams_tpu_torch.cli." + name,
                        *argv], env=_env(), cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr, r.stderr


def _jax_score(gt, pred, exp):
    """ams_tpu/cli/edge.py's score_vs_gt arithmetic (its lines 257-262):
    only 255 is excluded, unselected classes map to reduced id 0."""
    cw = np.asarray(jconfigs.class_weights(exp)).reshape(-1)
    take = np.cumsum(cw) * cw
    take_array = np.where(take != 0, take - 1, take).astype(int)
    valid = gt != 255
    n = int(cw.sum())
    cm = np.zeros((n, n), np.int64)
    np.add.at(cm, (take_array[gt[valid]], pred[valid]), 1)
    return float(np.nanmean(jax_calculate_miou(cm, nan=True)))


def test_edge_score_weights_unselected_classes_zero():
    """On exp 25 (6 of 19 classes) the JAX CLI counts gt pixels of the 13
    unselected classes as reduced class 0; the port gives them weight 0,
    as the emulation's metric (reduce_labels) does.  On exp 90's all-class
    clips the two agree wherever no unselected class occurs."""
    import torch

    exp = 25
    cw = np.asarray(jconfigs.class_weights(exp)).reshape(-1)
    rng = np.random.RandomState(4)
    gt = rng.randint(0, 19, (32, 64)).astype(np.uint8)
    gt[rng.rand(32, 64) < 0.05] = 255
    pred = rng.randint(0, int(cw.sum()), (32, 64)).astype(np.int32)
    ours = tedge.frame_miou(gt, pred, cw)
    jax_number = _jax_score(gt, pred, exp)
    ci = tuple(int(c) for c in np.where(cw == 1)[0])
    red, w, _ = reduce_labels(torch.from_numpy(gt), ci, 19)
    cm = confusion_matrix(red, torch.from_numpy(pred), len(ci), w).numpy()
    want = float(np.nanmean(calculate_miou(cm, nan=True)))
    assert ours == pytest.approx(want, abs=1e-12)
    assert abs(jax_number - ours) > 0.01, (jax_number, ours)
    # gt limited to selected classes and 255: no difference
    sel = np.where(cw[np.minimum(gt, 18)] == 1, gt, 255).astype(np.uint8)
    assert tedge.frame_miou(sel, pred, cw) == pytest.approx(
        _jax_score(sel, pred, exp), abs=1e-12)


def test_edge_final_window_starts_after_the_first_delta():
    """A 6 s run with its first delta at t=4: the JAX CLI's window starts
    at (6 - 10) s, before the stream, so its "final-10s" mean is the mean
    of every scored frame, pre-delta ones included; the port's starts at
    the first delta.  On a 30 s run both start at t=20."""
    fps = 10
    frames = np.arange(0, 60, 5)
    scores = np.where(frames < 40, 0.2, 0.6)
    sr = np.stack([frames, scores], 1).astype(np.float64)
    first_delta_t, second = 4.0, 6
    jax_tail = sr[sr[:, 0] >= (second - 10) * fps, 1]
    ours = sr[sr[:, 0] >= tedge.final_window_start(first_delta_t, second)
              * fps, 1]
    assert len(jax_tail) == 12 and jax_tail.mean() == pytest.approx(1 / 3)
    assert len(ours) == 4 and ours.mean() == pytest.approx(0.6)
    assert tedge.final_window_start(4.0, 30) == 20 == 30 - 10
    assert tedge.final_window_start(float("inf"), 6) == float("inf")


def test_live_cli_port_zero_prints_the_bound_port(tmp_path):
    log = str(tmp_path / "srv.log")
    srv, port = _serve(str(tmp_path / "r"), log)
    try:
        assert port > 0
        socket.create_connection(("127.0.0.1", port), timeout=10).close()
        text = _stop(srv, log)
    finally:
        if srv.poll() is None:
            srv.kill()
    assert "served 0 rounds across 0 sessions" in text, text
