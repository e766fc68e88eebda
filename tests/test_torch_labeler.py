"""The port's batched labeler, extract_labels and its CLI, held against the
JAX package and OpenCV on the CPU.

Both packages load one teacher checkpoint: the TF fixtures' weights
(``tools/teacher_oracle.params_for``, a value per variable name) written
as a ``teacher/``-prefixed ``.npy`` dict, as the reference stores the
teacher.  The clip is the JAX package's ``write_synthetic_clip`` mp4,
decoded by OpenCV into the port's frame directory of the same name, so
both read the same pixels.

Gates, in float32 (measured on this host): the labeler's ids equal JAX's
off ties (top-2 margin below 1e-3); ``extract_labels`` writes the same
files as JAX's, and its ``gt_``, ``annot_`` and ``vis_`` PNGs are byte
for byte JAX's (written there by cv2); ``annot_`` and ``vis_`` are also
byte for byte what cv2 writes from the port's labels and frames;
``add_weighted_u8`` equals ``cv2.addWeighted`` on every uint8 pair.
"""

import argparse
import glob
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from ams_tpu.cli import extract_labels as jax_cli
from ams_tpu.data.video import write_synthetic_clip as jax_write_clip
from ams_tpu.runtime import labeler as jlab

from ams_tpu_torch.cli import extract_labels as cli
from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.data.image import add_weighted_u8, png_read
from ams_tpu_torch.data.video import frame_path, frame_to_rgb
from ams_tpu_torch.models import xception_deeplab as tx
from ams_tpu_torch.runtime import labeler as lab
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.colormap import colormap

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from teacher_oracle import params_for  # noqa: E402
from torch_frames_from_video import frames_from_video  # noqa: E402

INVENTORY = os.path.join(os.path.dirname(__file__), "fixtures",
                         "teacher_inventory.json")
TIE = 1e-3
CLIP = "91-clip.mp4"          # exp 91: all 19 classes, 8 s registered


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """(numpy params, path of a teacher/-prefixed .npy holding them)."""
    import json

    with open(INVENTORY) as f:
        shapes = {k: tuple(v) for k, v in json.load(f).items()}
    params = params_for(shapes, 0)
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.npy")
    np.save(path, {"teacher/%s:0" % k: v for k, v in params.items()},
            allow_pickle=True)
    return params, path


def _margins(params, padded):
    """Top-2 margin of the port's f32 logits of padded frames, un-padded."""
    with torch.inference_mode():
        logits = tx.teacher_logits(params_from_numpy(params, "cpu"),
                                   torch.from_numpy(padded)).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0])[:, 1:, 1:]


def test_predict_fixed_batch_chunking():
    shapes = []

    def predict(params, arr):
        shapes.append(arr.shape)
        return arr.sum(axis=-1)

    arr = np.random.RandomState(0).randint(
        0, 256, (7, 5, 9, 3)).astype(np.uint8)
    out = lab._predict_fixed_batch(predict, None, arr, batch=4)
    assert out.shape == (7, 5, 9)
    assert shapes == [(4, 5, 9, 3)] * 2  # one fixed shape, tail padded
    np.testing.assert_array_equal(out, arr.sum(axis=-1))
    np.testing.assert_array_equal(
        out, jlab._predict_fixed_batch(predict, None, arr, batch=4))

    empty = lab._predict_fixed_batch(predict, None,
                                     np.empty((0, 5, 9, 3), np.uint8),
                                     batch=4)
    assert empty.shape == (0, 5, 9) and empty.dtype == np.uint8
    assert len(shapes) == 4  # no call for an empty draw


def test_labeler_batch_size_invariance(teacher):
    _, path = teacher
    frames = np.random.RandomState(1).randint(
        0, 256, (5, 16, 32, 3)).astype(np.uint8)
    lab2 = lab.make_teacher_labeler(path, compute_dtype="float32", batch=2,
                                    device="cpu")
    lab4 = lab.make_teacher_labeler(path, compute_dtype="float32", batch=4,
                                    device="cpu")
    out2 = lab2(frames)
    assert out2.shape == (5, 16, 32) and out2.dtype == np.uint8
    np.testing.assert_array_equal(out2, lab4(frames))
    split = np.concatenate([lab2(frames[:1]), lab2(frames[1:])])
    np.testing.assert_array_equal(split, out2)


def test_auto_batch_thresholds_and_lazy_resolution(monkeypatch):
    for h in (1, 257, 320, 321, 513, 640, 641, 1025):
        assert lab.auto_batch(h) == jlab.auto_batch(h), h
    assert (lab.auto_batch(257), lab.auto_batch(513),
            lab.auto_batch(1025)) == (32, 16, 8)
    # batch=None resolves from the first call's UNPADDED height, then stays
    seen = []
    orig = lab._predict_fixed_batch

    def spy(predict, params, arr, batch):
        seen.append((arr.shape[1], batch))
        return orig(predict, params, arr, batch)

    monkeypatch.setattr(lab, "_predict_fixed_batch", spy)
    label = lab.make_teacher_labeler(compute_dtype="float32", device="cpu")
    frames = np.random.RandomState(2).randint(
        0, 256, (2, 320, 8, 3)).astype(np.uint8)
    assert label(frames).shape == (2, 320, 8)
    assert label(frames[:, :20]).shape == (2, 20, 8)
    assert seen == [(321, 32), (21, 32)]


def test_teacher_prefixed_npy_checkpoint(tmp_path):
    base = tx.init_teacher_params(0, device="cpu")
    rng = np.random.RandomState(3)
    perturbed = {}
    for k in ("xception_65/entry_flow/conv1_1/weights", "aspp0/weights",
              "concat_projection/BatchNorm/gamma", "logits/semantic/biases"):
        perturbed[k] = rng.normal(0, 0.05, base[k].shape).astype(np.float32)
    path = str(tmp_path / "teacher_ckpt.npy")
    np.save(path, {"teacher/%s:0" % k: v for k, v in perturbed.items()},
            allow_pickle=True)
    params = lab._load_teacher_params(path, 0, torch.device("cpu"))
    for k, v in perturbed.items():
        np.testing.assert_array_equal(params[k].numpy(), v, err_msg=k)
    # untouched keys keep the seeded init's values
    k0 = "xception_65/entry_flow/conv1_2/weights"
    assert torch.equal(params[k0], base[k0])
    with pytest.raises(FileNotFoundError):
        lab.make_teacher_labeler(str(tmp_path / "typo.npy"), device="cpu")


def test_load_any_matches_jax_and_names_what_it_cannot_read(tmp_path):
    from ams_tpu.utils import checkpoint as jckpt

    params = {"a/weights": np.arange(6.0).reshape(2, 3),
              "a/weights/Adam": np.zeros(3), "global_step": np.int64(4)}
    npy = str(tmp_path / "m.npy")
    np.save(npy, params, allow_pickle=True)
    npz = str(tmp_path / "z.npz")
    np.savez(npz, **{"b:0": np.ones(2), "b/Momentum": np.ones(2)})
    for path in (npy, npy[:-4], npz, npz[:-4]):
        got, want = ckpt.load_any(path), jckpt.load_any(path)
        assert set(got) == set(want), path
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "tf.index").write_bytes(b"")   # a TF prefix, no table
    with pytest.raises(ValueError):
        ckpt.load_any(str(tmp_path / "tf"))
    orbax_dir = str(tmp_path / "orbax")
    jckpt.save_orbax(orbax_dir, params)         # OCDBT: orbax's default
    got, want = ckpt.load_any(orbax_dir), jckpt.load_any(orbax_dir)
    assert set(got) == set(want) == set(params)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        ckpt.load_any(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_any(str(tmp_path / "none"))


def test_f32_labeler_matches_jax(teacher):
    params, path = teacher
    frames = np.random.RandomState(4).randint(
        0, 256, (3, 24, 48, 3)).astype(np.uint8)
    got = lab.make_teacher_labeler(path, compute_dtype="float32", batch=2,
                                   device="cpu")(frames)
    want = jlab.make_teacher_labeler(path, compute_dtype="float32",
                                     batch=2)(frames)
    assert got.shape == want.shape and got.dtype == want.dtype
    padded = np.pad(frames, ((0, 0), (1, 0), (1, 0), (0, 0)),
                    mode="symmetric")
    decisive = _margins(params, padded) >= TIE
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(got[decisive], want[decisive])


@pytest.fixture(scope="module")
def extracted(teacher, tmp_path_factory):
    _, path = teacher
    root = tmp_path_factory.mktemp("extract")
    mp4 = str(root / "mp4" / CLIP)
    jax_write_clip(mp4, seconds=2, fps=3, size_hw=(24, 48))
    clip = str(root / "frames" / CLIP)
    assert frames_from_video(mp4, clip) == 6
    jax_dump = str(root / "jax") + "/"
    port_dump = str(root / "port") + "/"
    kw = dict(teacher_checkpoint=path, height=16, batch=4, max_frames=5,
              compute_dtype="float32")
    n_jax = jlab.extract_labels(mp4, jax_dump, **kw)
    n_port = lab.extract_labels(clip, port_dump, device="cpu", **kw)
    return dict(clip=clip, jax=jax_dump, port=port_dump, n=(n_jax, n_port))


def test_extract_labels_writes_jax_files_byte_for_byte(extracted):
    assert extracted["n"] == (5, 5)
    names = sorted(os.listdir(extracted["port"]))
    assert names == sorted(os.listdir(extracted["jax"]))
    assert names == sorted("%s_%06d.png" % (kind, i) for i in range(5)
                           for kind in ("gt", "annot", "vis"))
    for name in names:
        with open(extracted["port"] + name, "rb") as f:
            mine = f.read()
        with open(extracted["jax"] + name, "rb") as f:
            assert mine == f.read(), name
    gt = png_read(extracted["port"] + "gt_000000.png")
    assert gt.shape == (16, 32) and gt.dtype == np.uint8 and gt.max() < 19


@pytest.mark.parametrize("batch,chunks", [(2, [2, 2, 1]), (None, [5])],
                         ids=["batch2", "auto"])
def test_extract_labels_labels_through_one_labeler(teacher, extracted,
                                                   tmp_path, monkeypatch,
                                                   batch, chunks):
    """``extract_labels`` builds one ``make_teacher_labeler`` with the
    batch it resolved (``auto_batch`` of 16 rows: 32) and calls its
    ``label`` once per batch of unpadded frames; the files equal the
    batch-4 run's byte for byte."""
    _, path = teacher
    made, calls = [], []
    real = lab.make_teacher_labeler

    def spy(*args, **kwargs):
        made.append(kwargs)
        label = real(*args, **kwargs)

        def counted(frames):
            calls.append(frames.shape)
            return label(frames)
        return counted

    monkeypatch.setattr(lab, "make_teacher_labeler", spy)
    dump = str(tmp_path / "labels") + "/"
    n = lab.extract_labels(extracted["clip"], dump, teacher_checkpoint=path,
                           height=16, batch=batch, max_frames=5,
                           compute_dtype="float32", device="cpu")
    assert n == 5
    assert len(made) == 1
    assert made[0]["seed"] == 0 and made[0]["batch"] == (batch or 32)
    assert calls == [(k, 16, 32, 3) for k in chunks]
    names = sorted(os.listdir(dump))
    assert names == sorted(os.listdir(extracted["port"]))
    for name in names:
        with open(dump + name, "rb") as f:
            mine = f.read()
        with open(extracted["port"] + name, "rb") as f:
            assert mine == f.read(), name


def test_annot_and_vis_are_cv2_bytes_of_the_same_labels(extracted):
    cmap = colormap()
    for i in range(5):
        gt = png_read(extracted["port"] + "gt_%06d.png" % i)
        frame = frame_to_rgb(png_read(frame_path(extracted["clip"], i)),
                             (16, 32))
        colored = cmap[gt]
        annot = cv2.imencode(".png", cv2.cvtColor(colored,
                                                  cv2.COLOR_RGB2BGR))[1]
        vis = cv2.imencode(".png", cv2.cvtColor(
            cv2.addWeighted(frame, 0.5, colored, 0.5, 0),
            cv2.COLOR_RGB2BGR))[1]
        for kind, want in (("annot", annot), ("vis", vis)):
            with open(extracted["port"] + "%s_%06d.png" % (kind, i),
                      "rb") as f:
                assert f.read() == want.tobytes(), (kind, i)


@pytest.mark.parametrize("alpha,beta,gamma", [
    (0.5, 0.5, 0.0),            # extract_labels' overlay
    (0.3, 0.7, 5.0),
    (1.7, -0.4, 12.25),
])
def test_add_weighted_u8_matches_cv2_on_every_pair(alpha, beta, gamma):
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    np.testing.assert_array_equal(add_weighted_u8(a, alpha, b, beta, gamma),
                                  cv2.addWeighted(a, alpha, b, beta, gamma))
    rgb = np.dstack([a, b, a[::-1]])
    np.testing.assert_array_equal(
        add_weighted_u8(rgb, alpha, rgb[::-1], beta, gamma),
        cv2.addWeighted(rgb, alpha, rgb[::-1], beta, gamma))
    with pytest.raises(ValueError):
        add_weighted_u8(a, alpha, b[:, :3], beta, gamma)


def _parsed(module, argv, monkeypatch):
    """(parser, kwargs handed to extract_labels) of a CLI module's main."""
    parsers, calls = [], []
    orig = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        parsers.append(self)
        return orig(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(module, "extract_labels",
                        lambda *a, **k: calls.append((a, k)) or 0)
    module.main(argv)
    return parsers[-1], calls[-1]


def test_cli_flags_and_defaults_match_jax(monkeypatch):
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.required,
                         a.type) for a in parser._actions
                if a.dest != "help"}

    for argv in (["--dump_path", "d/", "--input_video", "v"],
                 ["--dump_path", "d/", "--input_video", "v", "--height",
                  "256", "--batch", "8", "--max_frames", "9",
                  "--teacher_checkpoint", "t.npy", "--gpu", "0"]):
        jp, (ja, jk) = _parsed(jax_cli, argv, monkeypatch)
        tp, (ta, tk) = _parsed(cli, argv + ["--device", "cpu"], monkeypatch)
        assert ta == ja
        assert tk.pop("device") == "cpu"
        assert tk.pop("teacher_config") == tx.TEACHER_OS16
        assert tk == jk
    mine, theirs = flags(tp), flags(jp)
    assert mine.pop("device") == (("--device",), "cuda", False, None)
    # DeepLab's flags, which the JAX package's CLI lacks
    assert mine.pop("output_stride") == (("--output_stride",), 16, False,
                                         int)
    assert mine.pop("decoder_output_stride") == (
        ("--decoder_output_stride",), None, False, int)
    assert mine == theirs
    _, (_, kw) = _parsed(cli, argv[:4] + ["--gpu", "1"], monkeypatch)
    assert kw["device"] == "cuda:1"


def test_cli_runs_on_cpu_and_refuses_cuda_without_a_card(extracted,
                                                         tmp_path, capsys):
    dump = str(tmp_path / "labels") + "/"
    cli.main(["--input_video", extracted["clip"], "--dump_path", dump,
              "--height", "16", "--max_frames", "3", "--device", "cpu"])
    assert "There were 3 frames extracted" in capsys.readouterr().out
    assert len(glob.glob(dump + "gt_*.png")) == 3
    assert len(glob.glob(dump + "vis_*.png")) == 3
    gt = png_read(dump + "gt_000002.png")
    assert gt.shape == (16, 32) and gt.max() < 19
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--input_video", extracted["clip"], "--dump_path",
                      str(tmp_path / "cuda") + "/"])
        assert not os.path.exists(tmp_path / "cuda")
