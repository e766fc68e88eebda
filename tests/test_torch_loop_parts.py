"""The emulation loop's small modules, held against ams_tpu on the CPU.

Samplers (``choose_frames``, ``mini_batch`` with a seeded
``random.Random``, ``FrameMemory``), the ASR/ATR controllers on a
scripted phi sequence, the PNG uplink probe, the H.264 uplink through the
instrumented ffmpeg double (``tests/fake_ffmpeg.py``, wrapped so it also
decodes to raw bgr24 as ffmpeg does), resume bundles, the profiler trace,
``RunConfig`` validation and the two CLIs' flags.  Every comparison is
exact.
"""

import dataclasses
import json
import os
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ams_tpu.cli import run as jax_run
from ams_tpu.data import buffers as jax_buffers
from ams_tpu.runtime.config import RunConfig as JaxRunConfig
from ams_tpu.stream import controllers as jax_controllers
from ams_tpu.stream import uplink as jax_uplink

from ams_tpu_torch.cli import run as torch_run
from ams_tpu_torch.convert import adam_state_to_numpy, params_to_numpy
from ams_tpu_torch.data import buffers
from ams_tpu_torch.data.video import write_synthetic_clip
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.runtime import resume
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir
from ams_tpu_torch.runtime.modes import run_experiment
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.stream import controllers, uplink
from ams_tpu_torch.utils.trace import GLOBAL_TIMER, SPAN_PID, profile_trace

FAKE = os.path.join(os.path.dirname(__file__), "fake_ffmpeg.py")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _frames(n, h=48, w=64, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.clip(np.stack([127 + 100 * np.sin((xx + 3 * t) / 17),
                              127 + 100 * np.sin((yy + t) / 11),
                              np.full_like(xx, 100)], -1)
                    + rs.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)
            for t in range(n)]


# ----------------------------------------------------------------- samplers

@pytest.mark.parametrize("n,fraction", [(1, 0.4), (6, 0.4), (11, 0.2),
                                        (10, 1.0), (7, 0.5), (30, 0.07)])
def test_choose_frames_matches(n, fraction):
    bucket = [(np.full((2, 2, 3), i, np.uint8), np.full((2, 2), i, np.uint8))
              for i in range(n)]
    jf, jl = jax_buffers.choose_frames(bucket, fraction)
    tf, tl = buffers.choose_frames(bucket, fraction)
    assert [int(f[0, 0, 0]) for f in tf] == [int(f[0, 0, 0]) for f in jf]
    assert [int(x[0, 0]) for x in tl] == [int(x[0, 0]) for x in jl]


@pytest.mark.parametrize("scale,flip", [([1], False), ([1, 1.5, 2], True)])
def test_mini_batch_matches(scale, flip):
    imgs = _frames(5, 64, 128)
    lbls = [np.random.RandomState(i).randint(0, 19, (64, 128)).astype(
        np.uint8) for i in range(5)]
    crop = (32, 64) if len(scale) > 1 else (64, 128)
    want = jax_buffers.mini_batch(imgs, lbls, crop, scale, 3, 4, flip=flip,
                                  rng=random.Random(7))
    got = buffers.mini_batch(imgs, lbls, crop, scale, 3, 4, flip=flip,
                             rng=random.Random(7))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_frame_memory_matches():
    jm = jax_buffers.FrameMemory(3, 4, 6)
    tm = buffers.FrameMemory(3, 4, 6)
    for step in range(3):
        fr = [np.full((4, 6, 3), 10 * step + i, np.uint8) for i in range(2)]
        lb = [np.full((4, 6), step + i, np.uint8) for i in range(2)]
        jm.extend(fr, lb)
        tm.extend(fr, lb)
        assert len(tm) == len(jm)
        for a, b in zip(tm.stacked(), jm.stacked()):
            assert np.array_equal(a, b)
    for bad in (([np.zeros((4, 6, 3), np.uint8)], []),
                ([np.zeros((4, 5, 3), np.uint8)], [np.zeros((4, 6))]),
                ([np.zeros((4, 6, 3), np.uint8)], [np.zeros((4, 5))])):
        with pytest.raises(ValueError):
            tm.extend(*bad)
    tm.clear()
    assert tm.stacked()[0].shape == (0, 4, 6, 3)


# -------------------------------------------------------------- controllers

def test_controllers_match_on_a_scripted_phi_sequence():
    phis = [[0.9, 0.8], [0.2], [float("nan")], [], [0.61, 0.59, np.nan],
            [0.95] * 4, [0.1, 0.3], [0.7]]
    ja, ta = jax_controllers.ASRController(0.5), controllers.ASRController(0.5)
    jt, tt = jax_controllers.ATRController(10), controllers.ATRController(10)
    js = ts = list(range(0, 200, 10))
    for now, p in zip(range(10, 200, 10), phis * 3):
        assert ta.update(p) == ja.update(p)
        jt.observe_send_rate(ja.send_rate)
        tt.observe_send_rate(ta.send_rate)
        assert tt.update() == jt.update()
        assert tt.hibernating == jt.hibernating
        if now in js and now in ts:
            js = jt.rewrite_schedule(js, now, 200)
            ts = tt.rewrite_schedule(ts, now, 200)
            assert ts == js


# ------------------------------------------------------------------ uplink

def test_png_size_probe_matches():
    frames = _frames(4, 64, 128) + [np.zeros((64, 128, 3), np.uint8)]
    assert uplink.png_size_probe(frames) == jax_uplink.png_size_probe(frames)


_DECODING_FAKE = r'''
import os, sys
argv = sys.argv[1:]
src = argv[argv.index("-i") + 1]
if src != "pipe:":
    # decode: what `ffmpeg -i <file> -f rawvideo -pix_fmt bgr24 pipe:` does
    import cv2
    cap = cv2.VideoCapture(src)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        sys.stdout.buffer.write(frame.tobytes())
    cap.release()
    sys.exit(0)
os.execv(sys.executable, [sys.executable, %r] + argv)
'''


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    script = tmp_path / "fake_ffmpeg_decoding.py"
    script.write_text(_DECODING_FAKE % FAKE)
    wrapper = tmp_path / "ffmpeg"
    wrapper.write_text("#!/bin/sh\nexec '%s' '%s' \"$@\"\n"
                       % (sys.executable, script))
    wrapper.chmod(0o755)
    log = tmp_path / "ffmpeg_log.jsonl"
    monkeypatch.setenv("FAKE_FFMPEG_LOG", str(log))
    monkeypatch.setattr(uplink, "FFMPEG", str(wrapper))
    monkeypatch.setattr(jax_uplink, "FFMPEG", str(wrapper))

    def records():
        return [json.loads(x) for x in log.read_text().splitlines() if x] \
            if log.exists() else []
    return SimpleNamespace(path=str(wrapper), log=log, records=records)


def test_h264_path_matches_jax(tmp_path, fake_ffmpeg):
    frames = _frames(8, 64, 128)
    want = jax_uplink.encode_decode_h264(frames, bitrate_kbps=300,
                                         out_hw=(32, 64), fps=8,
                                         work_dir=str(tmp_path))
    jrecs = fake_ffmpeg.records()
    fake_ffmpeg.log.unlink()
    got = uplink.encode_decode_h264(frames, bitrate_kbps=300,
                                    out_hw=(32, 64), fps=8,
                                    work_dir=str(tmp_path))
    trecs = fake_ffmpeg.records()
    assert got.exact_reference_codec and want.exact_reference_codec
    assert got.bits == want.bits > 0
    assert len(got.frames) == len(want.frames) == 8
    for g, w in zip(got.frames, want.frames):
        assert g.shape == (32, 64, 3) and np.array_equal(g, w)
    strip = [[{k: v for k, v in r.items()
               if k not in ("argv", "passlogfile", "target", "cwd")}
              for r in recs] for recs in (jrecs, trecs)]
    assert strip[0] == strip[1] and [r["pass"] for r in trecs] == ["1", "2"]
    assert not [p for p in os.listdir(tmp_path) if p.startswith("uplink_")]


def test_h264_retry_and_failures(tmp_path, fake_ffmpeg, monkeypatch):
    frames = _frames(6, 160, 160)
    monkeypatch.setenv("FAKE_FFMPEG_FAIL_ONCE", str(tmp_path / "marker"))
    blob, exact = uplink.encode_h264_bytes(frames, 300, fps=6,
                                           work_dir=str(tmp_path))
    assert exact and blob and os.path.exists(tmp_path / "marker")
    monkeypatch.delenv("FAKE_FFMPEG_FAIL_ONCE")
    monkeypatch.setenv("FAKE_FFMPEG_FAIL_ALWAYS", "1")
    with pytest.raises(RuntimeError, match=r"broke 5 times.*rc=1"):
        uplink.encode_h264_bytes(frames, 300, fps=6, work_dir=str(tmp_path))
    monkeypatch.delenv("FAKE_FFMPEG_FAIL_ALWAYS")
    monkeypatch.setenv("FAKE_FFMPEG_EXIT", "3")
    with pytest.raises(RuntimeError, match="rc=3"):
        uplink.encode_h264_bytes(frames, 300, fps=6, work_dir=str(tmp_path))
    monkeypatch.delenv("FAKE_FFMPEG_EXIT")
    monkeypatch.setenv("FAKE_FFMPEG_EMPTY", "1")
    with pytest.raises(IOError, match="empty payload"):
        uplink.encode_h264_bytes(frames, 300, fps=6, work_dir=str(tmp_path))


def test_no_ffmpeg_raises_and_names_the_binary(tmp_path, monkeypatch):
    monkeypatch.delenv("AMS_FFMPEG", raising=False)
    missing = str(tmp_path / "no" / "ffmpeg")
    monkeypatch.setattr(uplink, "FFMPEG", missing)
    with pytest.raises(RuntimeError, match="ffmpeg") as e:
        uplink.encode_decode_h264(_frames(2), 300, out_hw=(24, 32))
    assert missing in str(e.value)
    monkeypatch.setenv("AMS_FFMPEG", str(tmp_path / "pinned-missing"))
    with pytest.raises(FileNotFoundError, match="AMS_FFMPEG"):
        uplink.encode_h264_bytes(_frames(2), 300)


# ----------------------------------------------------------- the loop's run

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    clip = str(root / "90-synthetic")
    write_synthetic_clip(clip, seconds=8, fps=5, size_hw=(64, 128),
                         gt_dir=str(root / "gt"))
    os.makedirs(root / "ckpt")
    ckpt = str(root / "ckpt" / "student.npz")
    np.savez(ckpt, **params_to_numpy(init_student_params(0, device="cpu")))
    return root, clip, str(root / "gt") + "/", ckpt


def _cfg(tiny, out, **kw):
    root, clip, gt, ckpt = tiny
    base = dict(input_video=clip, gt_video=gt, student_checkpoint=ckpt,
                output_dir=str(root / out) + "/", memory_len=6, batch_size=2,
                iter=2, height=64, send_period=2, train_period=2,
                mode="early", early_cutoff_time=4,
                train_strategy="coord_desc_auto", device="cpu")
    base.update(kw)
    return RunConfig(**base)


def test_resume_round_trip_and_torn_bundle(tiny):
    cfg = _cfg(tiny, "resume")
    run_experiment(cfg)
    label = "early4_f2"
    prefix = get_save_dir(cfg, label)
    results = get_save_dir(cfg, label + "_results")
    suffixes = ("_fps_client.npy", "_bw_uplink.npy", "_bw_downlink.npy",
                "_model_update_times.npy")
    first = {s: np.load(results + s) for s in suffixes}
    with open(results + "_update.txt") as f:
        update = f.read()
    arrays, meta = resume.load_state(prefix)
    assert meta["update_count"] == 1 and meta["second"] == 4 * 5

    # the bundle restores the network's params and Adam slots exactly
    net = SemanticNetwork(cfg.student_checkpoint, class_weights_exp=np.ones(
        19), height=64, scale=[1], mini_batch_size=2, lr=1e-3, device="cpu")
    resume.restore_network(net, arrays)
    got = net.get_vars()
    for k, v in resume.unpack_params(arrays).items():
        assert np.array_equal(got[k], v), k
    step, m, v = adam_state_to_numpy(net.opt_state)
    assert int(step) == int(arrays["opt:step"]) == 2
    for k in m:
        assert np.array_equal(m[k], arrays["optm:" + k])
        assert np.array_equal(v[k], arrays["optv:" + k])

    # --resume continues from the last event: nothing left to train, and
    # the results are rewritten from the bundle with the same values (the
    # bundle keeps the per-period counts as floats, as ams_tpu's does)
    for s in suffixes + ("_update.txt",):
        os.remove(results + s)
    run_experiment(dataclasses.replace(cfg, resume=True))
    for s, want in first.items():
        assert np.array_equal(np.load(results + s), want), s
    with open(results + "_update.txt") as f:
        assert f.read() == update

    with open(prefix + "_resume_meta.json") as f:
        meta = json.load(f)
    meta["update_count"] += 1
    with open(prefix + "_resume_meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="torn resume bundle"):
        resume.load_state(prefix)


def test_horizon_mode_and_cli_on_the_cpu(tiny, capsys):
    root, clip, gt, ckpt = tiny
    cfg = _cfg(tiny, "horizon", mode="horizon", horizon_k1s=(2,),
               horizon_k2s=(2,), horizon_points=1, iter=1)
    run_experiment(cfg)
    assert "(2, 2, " in capsys.readouterr().out
    out = str(root / "cli") + "/"
    argv = ["--mode", "pretrained", "--input_video", clip, "--gt_video", gt,
            "--student_checkpoint", ckpt, "--output_dir", out,
            "--height", "64", "--send_period", "2"]
    torch_run.main(argv + ["--device", "cpu"])
    assert os.path.exists(out + "pretrained_results_90-synthetic_ckpt_64"
                          "_mioumems.npy")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_run.main(argv)


# ------------------------------------------------------- trace and config

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The Chrome trace holds the block's GLOBAL_TIMER span on the spans'
    own track, in the file's time base: it contains the aten op run
    inside it."""
    with profile_trace(str(tmp_path / "trace")):
        with GLOBAL_TIMER.span("ams/probe"):
            float(torch.ones(8).sum())
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    probe = [e for e in events if e.get("name") == "ams/probe"]
    assert len(probe) == 1 and probe[0]["pid"] == SPAN_PID
    op = next(e for e in events if e.get("name") == "aten::sum")
    assert probe[0]["ts"] <= op["ts"]
    assert op["ts"] + op["dur"] <= probe[0]["ts"] + probe[0]["dur"]
    with profile_trace(""):
        pass


ARGV = ["--input_video", "v/90-a", "--gt_video", "g/", "--student_checkpoint",
        "c/m.npz", "--output_dir", "o/", "--mode", "early"]


@pytest.mark.parametrize("extra", [
    [], ["--initial_fill", "--memory_len", "30", "--batch_size", "4",
         "--iter", "7", "--height", "128", "--lr", "0.01", "--send_period",
         "3", "--train_period", "6", "--only_results", "--compress_uplink",
         "--uplink_bw", "250", "--no_restore", "--save_pic"],
    ["--enable_ASR", "--enable_ATR", "--train_strategy", "coord_desc_rand",
     "--coord_fraction", "0.05", "--early_cutoff_time", "9", "--resume",
     "--no_resume_state", "--trace_dir", "t/", "--wire_dtype", "int8d",
     "--no_stats_annex", "--gpu", "1"],
])
def test_config_from_args_matches_jax(extra):
    jcfg = jax_run.config_from_args(jax_run.build_parser().parse_args(
        ARGV + extra))
    tcfg = torch_run.config_from_args(torch_run.build_parser().parse_args(
        ARGV + extra))
    want = dataclasses.asdict(jcfg)
    got = dataclasses.asdict(tcfg)
    assert got.pop("device") == ("cuda:1" if "--gpu" in extra else "cuda:0")
    assert got == want
    cpu = torch_run.config_from_args(torch_run.build_parser().parse_args(
        ARGV + extra + ["--device", "cpu"]))
    assert cpu.device == "cpu"


def test_cli_flags_defaults_and_choices_match_jax():
    def actions(parser):
        return {a.dest: (a.default, a.choices, a.required, a.nargs)
                for a in parser._actions if a.dest != "help"}
    want = actions(jax_run.build_parser())
    got = actions(torch_run.build_parser())
    assert got.pop("device") == ("cuda", ["cuda", "cpu"], False, None)
    assert got == want


@pytest.mark.parametrize("kw,err", [
    (dict(wire_dtype="int4"), ValueError),
    (dict(wire_dtype="int8d", no_restore=True), ValueError),
    (dict(enable_ATR=True), ValueError),
    (dict(enable_ASR=True, mode="early"), ValueError),
    (dict(enable_ASR=True, enable_ATR=True, mode="horizon"), ValueError),
    (dict(compute_dtype="bfloat16", conv_precision="default",
          wire_dtype="int8d", no_restore=True), ValueError),
    (dict(conv_precision="default", enable_ATR=True), ValueError),
])
def test_validate_raises_where_jax_asserts(kw, err):
    with pytest.raises(err):
        RunConfig(**kw).validate()
    if err is ValueError:
        with pytest.raises(AssertionError):
            JaxRunConfig(**kw).validate()
    assert RunConfig(mode="simple", enable_ASR=True,
                     enable_ATR=True).validate()
