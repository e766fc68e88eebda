"""The port's parallel package against ams_tpu's, on the CPU.

Counterparts of tests/test_parallel_api.py, tests/test_vmapped_round.py
and tests/test_sharded_labeler.py, plus the multi-video round against
JAX's.  The port's mesh on this host is a grid of CPU entries
(``make_mesh(n, device="cpu")``), which the multi-video round and the
labeler split their work over, one host thread per entry.  JAX's tests
use ``model_parallelism=2``; these use 1, and
tests/test_torch_parallel_width.py holds the width-partitioned labeler
and round against JAX's ``model_parallelism=2``.

Gates:
- the multi-video round is V independent single-video port rounds to the
  bit (V=2 on two entries, V=4 on two: two videos per entry), and the
  "vmapped" round is the serial rounds to the bit, with class masks;
- against JAX's ``make_multi_video_round(with_class_mask=True)`` on its
  virtual CPU mesh (V=2, exps 25 and 12, h=32, batch 2, two full_model
  iterations from warm Adam slots, ``n_valid=1`` so that both packages
  draw row 0 whatever their generators): the gates of
  tests/test_torch_round.py (losses 1e-5 then 5e-4; no coordinate beyond
  2.05 lr per iteration, at most 15% beyond 1e-4; BN statistics within
  0.1 of max(|value|, 1)).  full_model keeps JAX's compile of its round
  to one train step (coord_desc_auto adds the peeled f32 step: 63 s of
  compile on this host, cold); the port's selection is held against
  JAX's in tests/test_torch_round.py and test_torch_bf16_round.py, and
  the multi-video round's against independent port rounds here;
- the sharded labeler over two entries equals the port's single-device
  ``teacher_predictions`` exactly, and agrees with JAX's
  ``make_sharded_labeler(model_parallelism=1)`` on more than 0.999 of
  pixels at 32x64 in f32 (the bar of tests/test_sharded_labeler.py).
"""

import os
import pkgutil
import time
import tomllib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu import parallel as jparallel
from ams_tpu.distill import train_step as jts
from ams_tpu.distill.optimizer import AdamState as JAdamState
from ams_tpu.parallel import mesh as jmesh
from ams_tpu.parallel import sharded as jsharded

import ams_tpu_torch
from ams_tpu_torch import parallel as tparallel
from ams_tpu_torch.convert import (
    adam_state_from_numpy,
    masks_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.distill import train_step as tts
from ams_tpu_torch.distill.optimizer import AdamState, adam_init
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.models.xception_deeplab import (
    init_teacher_params,
    teacher_predictions,
)
from ams_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, H, W, BATCH, LR = 3, 32, 64, 2, 1e-3
CI = (0, 1, 2, 10, 11, 13)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


# ------------------------------------------------------------------- API


def test_make_mesh_rejects_overrequest(monkeypatch):
    """As test_parallel_api.py:12, on a stand-in two-card host: a
    truncated mesh would train a fraction of the videos sized for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="only"):
        tmesh.make_mesh(3)
    mesh = tmesh.make_mesh()
    assert mesh.device_list() == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert mesh.shape == {"data": 2, "model": 1} and mesh.size == 2


def test_make_mesh_refuses_width_partitioning_and_needs_a_card():
    """A model axis that does not divide the devices raises ValueError
    (JAX asserts); one that does gives rows of that many devices."""
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_mesh(3, model_parallelism=2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_mesh(2, model_parallelism=0, device="cpu")
    mesh = tmesh.make_mesh(4, model_parallelism=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert tmesh.Mesh([[torch.device("cpu")] * 2]).shape == {"data": 1,
                                                            "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
    mesh = tmesh.make_mesh(3, device="cpu")
    assert mesh.devices.shape == (3, 1) and mesh.axis_names == ("data",
                                                                "model")


def test_package_exports_match_jax():
    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and callable(v)}
    assert public(tparallel) == public(jparallel)
    assert {"make_multi_video_round", "make_sharded_distill_round"} \
        <= public(tparallel)


def test_init_multi_host_joins_nothing_unconfigured(monkeypatch):
    for k in tmesh.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tparallel.init_multi_host() == 1
    assert not torch.distributed.is_initialized()


def test_every_subpackage_is_installed():
    """pyproject.toml's packages list names every subpackage of the port,
    so an install carries each one."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    found = {"ams_tpu_torch"} | {
        m.name for m in pkgutil.walk_packages(ams_tpu_torch.__path__,
                                              "ams_tpu_torch.") if m.ispkg}
    assert "ams_tpu_torch.parallel" in found
    assert found <= listed, sorted(found - listed)


def test_stack_videos_matches_jax():
    rng = np.random.RandomState(0)
    trees = [{"a": rng.randn(2, 3).astype(np.float32),
              "b": rng.rand(4) > 0.5} for _ in range(3)]
    want = jsharded.stack_videos([{k: jnp.asarray(v) for k, v in t.items()}
                                  for t in trees])
    got = tparallel.stack_videos([{k: torch.from_numpy(v)
                                   for k, v in t.items()} for t in trees])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    opts = [adam_init({"w": torch.from_numpy(t["a"])}) for t in trees]
    st = tparallel.stack_videos(opts)
    assert isinstance(st, AdamState) and st.step.shape == (3,)
    assert st.m["w"].shape == (3, 2, 3)


# ----------------------------------------------------- multi-video round


def _videos(V, seed=0):
    rng = np.random.RandomState(seed)
    params = [init_student_params(s, device="cpu") for s in range(V)]
    frames = [torch.from_numpy(rng.randint(0, 256, (CAP, H, W, 3))
                               .astype(np.uint8)) for _ in range(V)]
    labels = [torch.from_numpy(rng.randint(0, 19, (CAP, H, W))
                               .astype(np.uint8)) for _ in range(V)]
    return params, frames, labels


def _gens(V):
    return [torch.Generator().manual_seed(100 + j) for j in range(V)]


def _assert_video_equal(out, j, ref):
    p, o, m, losses = ref
    for k in p:
        assert torch.equal(out[0][k][j], p[k]), k
    assert torch.equal(out[1].step[j], o.step)
    for k in o.m:
        assert torch.equal(out[1].m[k][j], o.m[k])
        assert torch.equal(out[1].v[k][j], o.v[k])
    for k in m:
        assert torch.equal(out[2][k][j], m[k]), k
    assert torch.equal(out[3][j], losses)


@pytest.mark.parametrize("V", [2, 4])
def test_multi_video_round_is_independent_rounds(V):
    """V=4 on two entries is test_parallel_api.py:29's "two deep" case:
    every video of a block trains."""
    spec = tts.DistillSpec(iters=2, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy="coord_desc_auto",
                           coord_frac=0.1)
    params, frames, labels = _videos(V)
    base = tts.make_distill_round(spec)
    ref = [base(p, adam_init(tts.split_params(p)[0]), f, l, CAP, g, LR,
                tts.all_true_mask(p))
           for p, f, l, g in zip(params, frames, labels, _gens(V))]
    fn = tparallel.make_multi_video_round(
        spec, tparallel.make_mesh(2, device="cpu"))
    out = fn(tparallel.stack_videos(params),
             tparallel.stack_videos([adam_init(tts.split_params(p)[0])
                                     for p in params]),
             frames, labels, [CAP] * V, _gens(V), LR,
             tparallel.stack_videos([tts.all_true_mask(p) for p in params]))
    assert out[3].shape == (V, 2)
    for j in range(V):
        _assert_video_equal(out, j, ref[j])
    with pytest.raises(ValueError, match="multiple"):
        tparallel.make_multi_video_round(
            spec, tparallel.make_mesh(3, device="cpu"))(
                out[0], out[1], frames, labels, [CAP] * V, _gens(V), LR,
                out[2])


@pytest.mark.parametrize("strategy", ["full_model", "coord_desc_auto"])
def test_vmapped_round_equals_serial_with_class_masks(strategy):
    """The counterparts of test_vmapped_round.py:45 and :94: each video's
    result is its serial round's, and a class-mask row narrows a video's
    loss to its own subset."""
    V = 2
    spec = tts.DistillSpec(iters=2, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy=strategy,
                           coord_frac=0.1, compute_dtype="bfloat16")
    cm = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]],
                      dtype=torch.float32)
    params, frames, labels = _videos(V, seed=1)
    base = tts.make_distill_round(spec)
    reselect = strategy == "coord_desc_auto"
    ref = [base(p, adam_init(tts.split_params(p)[0]), f, l, CAP, g, LR,
                tts.all_true_mask(p), reselect=reselect, class_mask=cm[j])
           for j, (p, f, l, g) in enumerate(zip(params, frames, labels,
                                                _gens(V)))]
    fn = tparallel.make_vmapped_multi_video_round(spec, with_class_mask=True)
    out = fn(tparallel.stack_videos(params),
             tparallel.stack_videos([adam_init(tts.split_params(p)[0])
                                     for p in params]),
             torch.stack(frames), torch.stack(labels),
             torch.full((V,), CAP), _gens(V), LR,
             tparallel.stack_videos([tts.all_true_mask(p) for p in params]),
             cm)
    for j in range(V):
        _assert_video_equal(out, j, ref[j])
    # video 0's narrowed loss is the loss of a round over its own subset
    sub = tts.make_distill_round(tts.DistillSpec(
        iters=2, batch_size=BATCH, num_classes=19, class_indices=CI[:3],
        strategy=strategy, coord_frac=0.1, compute_dtype="bfloat16"))
    p = params[0]
    _, _, _, loss_sub = sub(p, adam_init(tts.split_params(p)[0]), frames[0],
                            labels[0], CAP, _gens(1)[0], LR,
                            tts.all_true_mask(p), reselect=reselect)
    np.testing.assert_allclose(out[3][0].numpy(), loss_sub.numpy(),
                               rtol=0.02, atol=0.02)
    with pytest.raises(ValueError, match="with_class_mask"):
        fn(*out[:2], frames, labels, [CAP] * V, _gens(V), LR, out[2])


def test_multi_video_round_against_jax():
    """JAX's shard_map round and the port's on the same params, class
    masks, warm Adam slots and buffers (``n_valid=1``)."""
    V, cap = 2, 2
    union = sorted(set(configs.class_indices(25)) |
                   set(configs.class_indices(12)))
    cm = np.array([[c in set(configs.class_indices(e)) for c in union]
                   for e in (25, 12)], np.float32)
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (V, cap, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 19, (V, cap, H, W)).astype(np.uint8)
    # the port's seeded init (JAX's eager init compiles op by op, cold)
    params = [params_to_numpy(init_student_params(s, device="cpu"))
              for s in range(V)]
    train = [k for k in params[0] if "moving_" not in k]
    warm = [(np.int32(10),
             {k: (rng.randn(*params[0][k].shape) * 1e-3).astype(np.float32)
              for k in train},
             {k: rng.uniform(1e-7, 1e-5, params[0][k].shape)
              .astype(np.float32) for k in train}) for _ in range(V)]
    spec_kw = dict(iters=2, batch_size=BATCH, num_classes=19,
                   class_indices=tuple(union), strategy="full_model",
                   coord_frac=0.1, compute_dtype="float32")
    masks = [{k: np.ones(params[0][k].shape, bool) for k in train}] * V

    jstack = jsharded.stack_videos
    mesh = jmesh.make_mesh(2)
    jfn = jsharded.make_multi_video_round(jts.DistillSpec(**spec_kw), mesh,
                                          with_class_mask=True)
    t0 = time.perf_counter()
    with mesh:
        jp, _, _, jl = jfn(
            jstack([{k: jnp.asarray(v) for k, v in p.items()}
                    for p in params]),
            jstack([JAdamState(jnp.asarray(s), {k: jnp.asarray(x)
                                                for k, x in m.items()},
                               {k: jnp.asarray(x) for k, x in v.items()})
                    for s, m, v in warm]),
            jnp.asarray(frames), jnp.asarray(labels),
            jnp.ones((V,), jnp.int32),
            jnp.stack([jax.random.PRNGKey(7 + j) for j in range(V)]),
            jnp.float32(LR),
            jstack([{k: jnp.asarray(v) for k, v in m.items()}
                    for m in masks]), jnp.asarray(cm))
        jl = np.asarray(jl)
    print("JAX multi-video round: compile and run %.1f s"
          % (time.perf_counter() - t0))

    tfn = tparallel.make_multi_video_round(
        tts.DistillSpec(**spec_kw), tparallel.make_mesh(2, device="cpu"),
        with_class_mask=True)
    tp, _, _, tl = tfn(
        tparallel.stack_videos([params_from_numpy(p, "cpu")
                                for p in params]),
        tparallel.stack_videos([adam_state_from_numpy(*w, device="cpu")
                                for w in warm]),
        torch.from_numpy(frames), torch.from_numpy(labels), [1] * V,
        _gens(V), LR,
        tparallel.stack_videos([masks_from_numpy(m, "cpu") for m in masks]),
        torch.from_numpy(cm))
    tl = tl.numpy()
    for j in range(V):
        assert np.all(np.abs(tl[j] - jl[j]) < [1e-5, 5e-4]), (j, tl, jl)
        total = beyond = 0
        for k in train:
            t, want = tp[k][j].numpy(), np.asarray(jp[k][j])
            d = np.abs(t - want)
            assert d.max() <= 2.05 * LR * 2, (j, k, d.max())
            beyond += int((d > 1e-4).sum())
            total += d.size
        assert beyond / total <= 0.15, (j, beyond / total)
        for k in params[0]:
            if "moving_" in k:
                t, want = tp[k][j].numpy(), np.asarray(jp[k][j])
                bound = 0.1 * np.maximum(np.abs(want), 1.0)
                assert np.all(np.abs(t - want) <= bound), k


# ----------------------------------------------------------- the labeler


@pytest.fixture(scope="module")
def teacher():
    return params_to_numpy(init_teacher_params(0, device="cpu"))


def test_sharded_labeler_matches_single_device_and_jax(teacher):
    frames = np.random.RandomState(0).randint(
        0, 256, (2, H, W, 3)).astype(np.float32)
    tparams = params_from_numpy(teacher, "cpu")
    label = tparallel.make_sharded_labeler(
        tparallel.make_mesh(2, device="cpu"), tparams,
        compute_dtype=torch.float32)
    got = label(torch.from_numpy(frames))
    assert got.shape == (2, H, W) and got.dtype == torch.int32
    want = teacher_predictions(tparams, torch.from_numpy(frames))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="divide"):
        label(torch.from_numpy(frames[:1]))

    mesh = jmesh.make_mesh(2, model_parallelism=1)
    jlabel = jsharded.make_sharded_labeler(mesh, teacher,
                                           compute_dtype=jnp.float32)
    t0 = time.perf_counter()
    with mesh:
        jids = np.asarray(jlabel(jnp.asarray(frames)))
    print("JAX sharded labeler: compile and run %.1f s"
          % (time.perf_counter() - t0))
    agree = float((got.numpy() == jids).mean())
    print("port against JAX labels: %.6f" % agree)
    assert agree > 0.999, agree
