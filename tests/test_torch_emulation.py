"""The port's emulated experiment held against the JAX package's, on the CPU.

One synthetic clip (the JAX package's ``write_synthetic_clip``: 8 s at
5 fps, 64x128, exp 90, as in tests/test_end_to_end.py) is written as an
mp4 and decoded by OpenCV into the port's frame directory, named after the
clip so that both packages derive the same artifact names; both loops read
the same pixels.  Both load one student ``.npz``: the parity fixture's
trained weights with BN statistics from the clip's first second.  ``--mode
early`` with cutoff 4, 3 iterations at batch 2, memory_len 6, send and
train period 2 and ``coord_desc_auto``; the port runs with
``device="cpu"``, once as it is ("natural") and once with its round
drawing the JAX server's minibatches ("pinned").

Gates, with what was measured on this host:
- equal: ``_model_update_times``, ``_fps_client``, ``_bw_uplink`` and
  ``_uplink_exact``; lines 2-5 of ``_update.txt`` (uplink kbits, updates,
  interval, samples); the artifact file names of the early, simple and
  pretrained modes; the resume bundle's ``mem:frames``, ``mem:labels`` and
  Adam step.  The uplink bits are PNG sizes, equal because
  ``data/image.py`` writes cv2's bytes; the memory is equal because its
  resizes are cv2's.
- the server's params.  The packages draw different minibatches
  (``torch.Generator`` against ``jax.random``), and the first round starts
  from cold Adam slots, where every coordinate steps by +-lr with the sign
  of its gradient: at gradients on the f32 noise floor the two packages
  take opposite signs, and the later iterations' batch moments follow the
  moved weights.  Weights within 2.05 lr per iteration, the bound of
  tests/test_torch_round.py (measured: natural 5.99e-3, pinned 3.45e-3,
  bound 6.15e-3).  BN moving statistics within 0.25 of max(|v|, 1)
  (measured: natural 0.198, pinned 0.123); tests/test_torch_round.py's
  0.1 holds for replayed draws from one state, not here.  Pinned, the
  delta payloads select the same coordinates on at least 0.99 of them
  (measured 0.999).
- ``_bw_downlink`` and line 1 of ``_update.txt`` within a relative 0.05
  (measured 0.0166): the payload's mask and values follow the params.
- the client, held on the JAX package's own deployed artifacts (a copy of
  its output directory): ``_loss.npy`` within rtol 1e-5 (measured
  2.6e-6), each frame's confusion matrix within 1e-3 of its 8192 pixels
  (near-tie ids; measured at most 2 ids), ``_mious`` and ``_mioumems``
  within 1e-3.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.data.video import write_synthetic_clip as jax_write_clip
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.runtime.client import infer_output as jax_infer_output
from ams_tpu.runtime.config import RunConfig as JaxRunConfig
from ams_tpu.runtime.modes import run_experiment as jax_run_experiment

from ams_tpu_torch.data.image import png_decode, png_read
from ams_tpu_torch.data.video import frame_path, frame_to_rgb
from ams_tpu_torch.runtime.client import infer_output
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir
from ams_tpu_torch.runtime.modes import run_experiment
from ams_tpu_torch.runtime.network import SemanticNetwork as TorchNetwork
from ams_tpu_torch.stream.codec import decode_delta

import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from torch_frames_from_video import frames_from_video  # noqa: E402

STUDENT = os.path.join(os.path.dirname(__file__), "fixtures",
                       "student_parity_h64.npz")
SECONDS, FPS, HW = 8, 5, (64, 128)
CUTOFF, ITERS, LR = 4, 3, 1e-3
LABEL = "early%d_f2" % CUTOFF
DOWNLINK_RTOL = 0.05
STAT_TOL = 0.25
MASK_AGREE = 0.99


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _kw(out, **extra):
    kw = dict(student_checkpoint=None, output_dir=out, memory_len=6,
              batch_size=2, iter=ITERS, height=HW[0], lr=LR, send_period=2,
              train_period=2, mode="early", early_cutoff_time=CUTOFF,
              train_strategy="coord_desc_auto")
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("emulation")
    mp4 = str(root / "mp4" / "90-synthetic.mp4")
    gt = str(root / "gt")
    jax_write_clip(mp4, seconds=SECONDS, fps=FPS, size_hw=HW, gt_dir=gt)
    frames = str(root / "frames" / "90-synthetic.mp4")
    assert frames_from_video(mp4, frames) == SECONDS * FPS
    os.makedirs(root / "ckpt")
    ckpt = str(root / "ckpt" / "student.npz")
    np.savez(ckpt, **_student(frames))

    out = {}
    # the port once more, its round drawing the JAX package's minibatches
    pinned = str(root / "torch_pinned") + "/"
    pcfg = RunConfig(input_video=frames, gt_video=gt + "/", device="cpu",
                     **_kw(pinned, student_checkpoint=ckpt))
    orig = TorchNetwork._round_fn

    def round_fn_on_jax_draws(self, iters, strategy):
        fn = orig(self, iters, strategy)

        def run(params, opt, fbuf, lbuf, n_valid, gen, lr, mask, **kw):
            return fn(params, opt, fbuf, lbuf, n_valid, gen, lr, mask,
                      idx_seq=jax_draws(iters, self.mini_batch_size,
                                        n_valid), **kw)
        return run

    TorchNetwork._round_fn = round_fn_on_jax_draws
    try:
        run_experiment(pcfg)
    finally:
        TorchNetwork._round_fn = orig
    out["pinned"] = (None, pcfg)
    for mode in ("early", "simple", "pretrained"):
        jo = str(root / ("jax_" + mode)) + "/"
        to = str(root / ("torch_" + mode)) + "/"
        jcfg = JaxRunConfig(input_video=mp4, gt_video=gt + "/",
                            **_kw(jo, student_checkpoint=ckpt, mode=mode))
        tcfg = RunConfig(input_video=frames, gt_video=gt + "/", device="cpu",
                         **_kw(to, student_checkpoint=ckpt, mode=mode))
        jax_run_experiment(jcfg)
        run_experiment(tcfg)
        out[mode] = (jcfg, tcfg)
    return dict(root=root, cfgs=out, frames=frames, gt=gt + "/")


def _student(frames):
    """The parity fixture's trained weights, with BN statistics set to the
    batch moments of the clip's first second (a student off chance)."""
    with np.load(STUDENT) as z:
        params = {k[len("param:"):]: z[k] for k in z.files
                  if k.startswith("param:") and "_patch" not in k}
    clip = np.stack([frame_to_rgb(png_read(frame_path(frames, i)), HW)
                     for i in range(FPS)]).astype(np.float32)
    stats = {}
    jm.student_logits({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(clip), train=True, stats_out=stats)
    params.update({k: np.asarray(v, np.float32) for k, v in stats.items()})
    return params


def jax_draws(iters, batch, n_valid, seed=0):
    """The minibatch indices of the JAX server's first round: its network
    splits its seeded key once per round, and iteration ``it`` draws
    ``randint(fold_in(key, it))`` (ams_tpu/distill/train_step.py)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(sub, it), (batch,), 0, max(int(n_valid), 1)))
        for it in range(iters)])


def _results(cfg, label=LABEL):
    return get_save_dir(cfg, label + "_results")


def test_schedule_and_uplink_equal(runs):
    jcfg, tcfg = runs["cfgs"]["early"]
    j, t = _results(jcfg), _results(tcfg)
    for suffix in ("_model_update_times.npy", "_fps_client.npy",
                   "_bw_uplink.npy", "_uplink_exact.npy"):
        a, b = np.load(j + suffix), np.load(t + suffix)
        assert a.dtype == b.dtype and np.array_equal(a, b), (suffix, a, b)
    assert np.load(t + "_fps_client.npy").sum() > 0
    with open(j + "_update.txt") as f:
        jl = f.read().split("\n")
    with open(t + "_update.txt") as f:
        tl = f.read().split("\n")
    assert len(jl) == len(tl) == 5
    assert jl[1:] == tl[1:], (jl, tl)
    assert int(tl[2]) == 1          # second 0 skips (empty memory), 4 trains
    rel = abs(int(jl[0]) - int(tl[0])) / int(jl[0])
    print("downlink bits: jax %s torch %s rel %.4g" % (jl[0], tl[0], rel))
    assert rel <= DOWNLINK_RTOL
    jd, td = np.load(j + "_bw_downlink.npy"), np.load(t + "_bw_downlink.npy")
    assert jd.shape == td.shape == (1,)
    np.testing.assert_allclose(td, jd, rtol=DOWNLINK_RTOL)


def test_artifact_names_equal_in_every_mode(runs):
    for mode, (jcfg, tcfg) in runs["cfgs"].items():
        if jcfg is None:
            continue
        jn = sorted(os.listdir(jcfg.output_dir))
        tn = sorted(os.listdir(tcfg.output_dir))
        assert jn == tn, (mode, set(jn) ^ set(tn))
    early = sorted(os.listdir(runs["cfgs"]["early"][1].output_dir))
    assert sum(n.endswith("_final.npz") for n in early) == 2
    assert sum(n.endswith("_mask.dat.gz") for n in early) == 1


def _bundle(cfg):
    with np.load(get_save_dir(cfg, LABEL) + "_resume_state.npz") as z:
        return {k: z[k] for k in z.files}


def test_resume_bundle_memory_equal_params_within_bounds(runs):
    jcfg, tcfg = runs["cfgs"]["early"]
    jb = _bundle(jcfg)
    pinned = runs["cfgs"]["pinned"][1]
    for which, cfg in (("natural", tcfg), ("pinned", pinned)):
        tb = _bundle(cfg)
        assert sorted(jb) == sorted(tb)
        for k in ("mem:frames", "mem:labels", "opt:step",
                  "meta:update_count"):
            assert jb[k].dtype == tb[k].dtype and np.array_equal(
                jb[k], tb[k]), k
        assert jb["mem:frames"].shape[0] > 0
        wmax = smax = 0.0
        for k in (k for k in jb if k.startswith("param:")):
            d = np.abs(jb[k].astype(np.float64) - tb[k])
            if "moving_" in k:
                smax = max(smax, float(np.max(
                    d / np.maximum(np.abs(jb[k]), 1))))
            else:
                wmax = max(wmax, float(d.max()))
        print("%s draws: weights max |d| %.3g (2.05 lr iters %.3g), BN "
              "statistics max |d| / max(|v|, 1) %.3g"
              % (which, wmax, 2.05 * LR * ITERS, smax))
        assert wmax <= 2.05 * LR * ITERS
        assert smax <= STAT_TOL


def test_pinned_draws_select_the_same_coordinates(runs):
    """With the JAX package's minibatches, the round selects the same
    coord_desc_auto coordinates: the two delta payloads decode to masks
    that agree on at least 0.99 of the trainable coordinates."""
    jcfg, _ = runs["cfgs"]["early"]
    pcfg = runs["cfgs"]["pinned"][1]
    shapes = {k[len("param:"):]: v.shape for k, v in _bundle(jcfg).items()
              if k.startswith("param:")}
    masks = []
    for cfg in (jcfg, pcfg):
        with open(get_save_dir(cfg, LABEL + "_0") + "_mask.dat.gz",
                  "rb") as f:
            masks.append(decode_delta(f.read(), shapes,
                                      strategy="coord_desc_auto")[0])
    agree = sum(int((masks[0][k] == masks[1][k]).sum()) for k in masks[0])
    total = sum(m.size for m in masks[0].values())
    print("pinned draws: payload masks agree on %.5f" % (agree / total))
    assert agree / total >= MASK_AGREE


def test_client_on_jax_artifacts(runs):
    jcfg, tcfg = runs["cfgs"]["early"]
    copy = str(runs["root"] / "client_on_jax") + "/"
    shutil.copytree(jcfg.output_dir, copy)
    cfg = RunConfig(input_video=runs["frames"], gt_video=runs["gt"],
                    device="cpu", **_kw(copy, student_checkpoint=(
                        tcfg.student_checkpoint)))
    infer_output(cfg, 0, SECONDS, LABEL, runs["gt"], 90, [0, CUTOFF])
    j, t = _results(jcfg), _results(cfg)
    jl, tl = np.load(j + "_loss.npy"), np.load(t + "_loss.npy")
    assert jl.shape == tl.shape == (SECONDS * FPS,)
    print("client loss max rel %.3g" % np.max(np.abs(tl - jl) / np.abs(jl)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jc, tc = np.load(j + "_mioucats.npy"), np.load(t + "_mioucats.npy")
    assert jc.shape == tc.shape
    moved = np.abs(jc - tc).reshape(len(jc), -1).sum(1) / 2
    print("client ids moved per frame: max %d of %d pixels"
          % (moved.max(), HW[0] * HW[1]))
    assert np.all(moved <= 1e-3 * HW[0] * HW[1])
    for suffix in ("_mious.npy", "_mioumems.npy"):
        a, b = np.load(j + suffix), np.load(t + suffix)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, equal_nan=True)


def test_save_pic_pictures_equal(runs):
    """--save_pic: the port's pictures of the first second, on the JAX
    package's deployed artifact.  Those of the frame and the teacher are
    the JAX package's files byte for byte; those of the student's ids
    differ at most where its ids do (near ties: at most 1e-3 of the
    pixels; measured at most 2 of 8192)."""
    jcfg, tcfg = runs["cfgs"]["early"]
    dirs = []
    for name, make, fn in (("jax_pics", JaxRunConfig, jax_infer_output),
                           ("torch_pics", RunConfig, infer_output)):
        out = str(runs["root"] / name) + "/"
        shutil.copytree(jcfg.output_dir, out)
        extra = {"device": "cpu"} if make is RunConfig else {}
        video = runs["frames"] if make is RunConfig else jcfg.input_video
        cfg = make(input_video=video, gt_video=runs["gt"], save_pic=True,
                   **_kw(out, student_checkpoint=tcfg.student_checkpoint),
                   **extra)
        fn(cfg, 0, 1, LABEL, runs["gt"], 90, [0])
        dirs.append(out)
    names = sorted(n for n in os.listdir(dirs[0]) if n.endswith(".png"))
    assert len(names) == 2 * 8   # named by the truncated second: 0 and 1
    assert names == sorted(n for n in os.listdir(dirs[1])
                           if n.endswith(".png"))
    for n in names:
        with open(dirs[0] + n, "rb") as a, open(dirs[1] + n, "rb") as b:
            ja, tb = a.read(), b.read()
        if n.endswith(("_frame.png", "_ignore_mask.png", "_teacher.png")):
            assert ja == tb, n
            continue
        jp, tp = png_decode(ja), png_decode(tb)
        assert jp.shape == tp.shape and jp.dtype == tp.dtype, n
        moved = (jp != tp).reshape(HW[0] * HW[1], -1).any(1).sum()
        print("%s: %d pixels differ" % (n, moved))
        assert moved <= 1e-3 * HW[0] * HW[1], n
