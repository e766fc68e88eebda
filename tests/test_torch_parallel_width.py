"""Width partitioning (the mesh's ``model`` axis) in the port, on the CPU.

``parallel.spatial`` splits an activation's width over the devices of a
mesh row and builds each convolution's input as a column window; here
the row is CPU entries.  Checked:
- ``balanced_ranges`` and the column window: every column from the shard
  that holds it, zeros outside the tensor, a window wider than a shard;
- ``layers.conv2d`` and ``layers.depthwise_conv2d`` on 2 and 3 shards of
  uneven widths, at stride 1 and 2 and at rates 1, 2, 6, 12 and 18 (the
  teacher's ASPP, whose halo spans more than a neighbour's shard), and
  slim's fixed padding: the output and the input and weight gradients
  equal the unsharded op's within f32 reassociation;
- training BN's moments, the student's train-mode grid logits and BN
  statistics, and the teacher's grid logits and ids, sharded against
  unsharded;
- the round on a mesh row of two entries (``make_mesh(2,
  model_parallelism=2)``, no process group) against the single-device
  round, at tests/test_sharded_round.py's gates;
- the labeler over ``make_mesh(4, model_parallelism=2)`` against JAX's
  ``make_sharded_labeler`` on the same mesh shape at 32x64 in f32, at
  tests/test_sharded_labeler.py's 0.999, and equal to the port's own
  single-device labels off near ties.
tests/test_torch_parallel_width_dp.py holds two gloo ranks of such rows
against the single-device round and JAX's round.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.models.xception_deeplab import init_teacher_params as jteacher
from ams_tpu.parallel import mesh as jmesh
from ams_tpu.parallel import sharded as jsharded

from ams_tpu_torch import parallel as tparallel
from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
from ams_tpu_torch.distill.optimizer import adam_init
from ams_tpu_torch.distill.train_step import (
    DistillSpec,
    all_true_mask,
    make_distill_round,
    split_params,
)
from ams_tpu_torch.models import layers
from ams_tpu_torch.models import mobilenetv2_deeplab as sm
from ams_tpu_torch.models import xception_deeplab as xd
from ams_tpu_torch.parallel import spatial

CPU = torch.device("cpu")
LR = 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _tensor(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _close(got, want, rtol=1e-5):
    """Equal within f32 reassociation: the largest gap at most ``rtol``
    of the largest magnitude."""
    scale = float(want.detach().abs().max())
    gap = float((got - want).detach().abs().max())
    assert gap <= rtol * max(scale, 1e-30), (gap, scale)


# ------------------------------------------------------------- spatial


def test_balanced_ranges():
    assert spatial.balanced_ranges(33, 2) == [(0, 17), (17, 33)]
    assert spatial.balanced_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert spatial.balanced_ranges(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    with pytest.raises(ValueError, match="cannot be split"):
        spatial.balanced_ranges(2, 3)


@pytest.mark.parametrize("m", [2, 3])
def test_column_window(m):
    x = torch.arange(2 * 3 * 11, dtype=torch.float32).reshape(1, 2, 3, 11)
    xs = spatial.shard_width(x, [CPU] * m)
    assert [p.shape[3] for p in xs.parts] == [
        hi - lo for lo, hi in spatial.balanced_ranges(11, m)]
    assert torch.equal(xs.gather(), x)
    padded = torch.nn.functional.pad(x, (20, 20))
    for lo, hi in ((-20, 31), (-3, 2), (2, 9), (9, 14), (0, 11), (12, 15)):
        assert torch.equal(xs.window(lo, hi, CPU), padded[..., lo + 20:
                                                          hi + 20])
    # the window of a shard's own columns is that shard, not a copy
    assert xs.window(*xs.ranges[1], CPU) is xs.parts[1]


CONV_CASES = [(w, m, stride, rate, dw)
              for w in (13, 33) for m in (2, 3)
              for stride, rate in ((1, 1), (2, 1), (1, 2), (1, 6), (1, 12),
                                   (1, 18))
              for dw in (False, True)]


@pytest.mark.parametrize("w,m,stride,rate,depthwise", CONV_CASES)
def test_conv_on_shards_matches_unsharded(w, m, stride, rate, depthwise):
    rng = np.random.RandomState(w * 100 + m * 10 + stride + rate)
    x = _tensor(rng, 2, 4, 5, w).requires_grad_(True)
    wt = _tensor(rng, 3, 3, 4, 1 if depthwise else 6).requires_grad_(True)
    conv = layers.depthwise_conv2d if depthwise else layers.conv2d
    want = conv(x, wt, stride=stride, rate=rate)
    got = conv(spatial.shard_width(x, [CPU] * m), wt, stride=stride,
               rate=rate)
    assert got.ranges == spatial.balanced_ranges(want.shape[3], m)
    got = got.gather()
    assert got.shape == want.shape
    _close(got, want)
    seed = _tensor(rng, *want.shape)
    gx, gw = torch.autograd.grad(want, (x, wt), seed)
    sx, sw = torch.autograd.grad(got, (x, wt), seed)
    _close(sx, gx)
    _close(sw, gw)


@pytest.mark.parametrize("m", [2, 3])
def test_fixed_padding_and_1x1_stride2_on_shards(m):
    """The teacher's stride-2 convolutions: slim's (1, 1) padding and the
    1x1 stride-2 shortcut, on odd widths."""
    rng = np.random.RandomState(m)
    x = _tensor(rng, 1, 3, 7, 25)
    xs = spatial.shard_width(x, [CPU] * m)
    for wt, kw in ((_tensor(rng, 3, 3, 3, 5),
                    dict(stride=2, padding=((1, 1), (1, 1)))),
                   (_tensor(rng, 1, 1, 3, 5), dict(stride=2))):
        _close(layers.conv2d(xs, wt, **kw).gather(),
               layers.conv2d(x, wt, **kw))


@pytest.mark.parametrize("m", [2, 3])
def test_batch_norm_moments_weighted_by_columns(m):
    rng = np.random.RandomState(m)
    x = _tensor(rng, 3, 8, 5, 17) * 3 + 1
    gamma, beta = _tensor(rng, 8) + 2, _tensor(rng, 8)
    y, mean, var = layers.batch_norm_train(x, gamma, beta)
    ys, means, vars_ = layers.batch_norm_train(
        spatial.shard_width(x, [CPU] * m), gamma, beta)
    _close(means, mean)
    _close(vars_, var)
    _close(ys.gather(), y)
    _close(spatial.mean(spatial.shard_width(x, [CPU] * m), (2, 3),
                        keepdim=True), x.mean(dim=(2, 3), keepdim=True))


# -------------------------------------------------------------- models


@pytest.fixture(scope="module")
def student():
    return sm.init_student_params(0, device="cpu")


@pytest.mark.parametrize("m", [2, 3])
def test_student_train_forward_on_shards(student, m):
    """Train-mode grid logits and BN moments at 32x64 (widths 65, 33,
    17, 9, 5): on 3 shards the last grids split 2 + 2 + 1.  Train-mode BN
    at batch 2 amplifies f32 reassociation through the trunk, so the gap
    is held to 4x that of the unsharded forward on the batch in reverse
    order (the same sums in another order), and the stem's moments, taken
    before any amplification, to 1e-5."""
    frames = torch.from_numpy(np.random.RandomState(m).randint(
        0, 256, (2, 32, 64, 3)).astype(np.float32))
    want_stats, got_stats, flip_stats = {}, {}, {}
    want = sm.grid_logits_nchw(student, frames, train=True,
                               stats_out=want_stats)
    got = sm.grid_logits_nchw(student,
                              spatial.shard_width(frames, [CPU] * m, dim=2),
                              train=True, stats_out=got_stats)
    flip = sm.grid_logits_nchw(student, frames.flip(0), train=True,
                               stats_out=flip_stats).flip(0)
    assert got.shape == want.shape

    def gap(a, b):
        return float((a - b).abs().max())

    scale = float(want.abs().max())
    assert gap(got, want) <= max(4 * gap(flip, want), 1e-6 * scale)
    assert set(got_stats) == set(want_stats)
    for k, v in want_stats.items():
        bound = max(4 * gap(flip_stats[k], v), 1e-6 * float(v.abs().max()))
        assert gap(got_stats[k], v) <= bound, k
    for k in ("MobilenetV2/Conv/BatchNorm/moving_mean",
              "MobilenetV2/Conv/BatchNorm/moving_variance"):
        _close(got_stats[k], want_stats[k])


def test_preprocess_pads_the_last_shard():
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 4, 9, 3)).astype(np.float32))
    got = sm.preprocess(spatial.shard_width(frames, [CPU] * 2, dim=2))
    assert got.ranges == [(0, 5), (5, 10)] and got.width == 10
    assert torch.equal(got.gather(), sm.preprocess(frames))


@pytest.fixture(scope="module")
def teacher():
    return params_to_numpy(xd.init_teacher_params(0, device="cpu"))


def test_teacher_on_shards(teacher):
    """At 33x65 the ASPP runs on a 3x5 grid, so its rate-6, 12 and 18
    halos reach past every shard."""
    tparams = params_from_numpy(teacher, "cpu")
    frames = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 33, 65, 3)).astype(np.float32))
    shards = spatial.shard_width(frames, [CPU] * 2, dim=2)
    want = xd.teacher_logits_nchw(tparams, frames, out_hw=None)
    got = xd.teacher_logits_nchw(tparams, shards, out_hw=None)
    _close(got, want, rtol=1e-4)
    assert torch.equal(xd.teacher_predictions(tparams, shards),
                       xd.teacher_predictions(tparams, frames))


@pytest.mark.parametrize("path", ["gather", "matmul", "fused"])
def test_loss_and_gradients_on_shards(student, path):
    """``distill_loss`` on width shards: the plain losses resize each
    shard's own label columns (gather and matmul forms), the fused one
    gathers the labels and the grid; loss to 1e-5, gradients within 4x
    the gap of the unsharded loss on the batch in reverse order."""
    from ams_tpu_torch.distill.loss import distill_loss

    rng = np.random.RandomState(7)
    frames = torch.from_numpy(rng.randint(0, 256, (2, 32, 64, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 32, 64)).astype(
        np.uint8))
    keys = ("logits/semantic/weights", "MobilenetV2/Conv/weights",
            "aspp0/BatchNorm/gamma")

    def grads(f, lab):
        leaves = {k: v.clone().requires_grad_(k in keys)
                  for k, v in student.items()}
        loss, _ = distill_loss(leaves, f, lab, (0, 1, 2, 10, 11, 13), 19,
                               fused=path == "fused",
                               resize_via="gather" if path == "fused"
                               else path)
        return loss, torch.autograd.grad(loss, [leaves[k] for k in keys])

    want, gw = grads(frames, labels)
    flip, gf = grads(frames.flip(0), labels.flip(0))
    got, gs = grads(spatial.shard_width(frames, [CPU] * 2, dim=2),
                    spatial.shard_width(labels, [CPU] * 2, dim=2))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    for k, g, w, f in zip(keys, gs, gw, gf):
        bound = max(4 * float((f - w).abs().max()),
                    1e-5 * float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound, k


# --------------------------------------------------------------- round


@pytest.mark.parametrize("strategy,iters", [("full_model", 1),
                                            ("coord_desc_auto", 2)])
def test_round_on_one_mesh_row(student, strategy, iters):
    """The round over ``make_mesh(2, model_parallelism=2)`` with no
    process group (data axis 1) against the single-device round, from the
    same seeded params, cold Adam slots, buffers and ``idx_seq``."""
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randint(0, 256, (6, 64, 128, 3)).astype(
        np.uint8))
    labels = torch.from_numpy(rng.randint(0, 19, (6, 64, 128)).astype(
        np.uint8))
    idx = rng.randint(0, 6, (iters, 4))
    spec = DistillSpec(iters=iters, batch_size=4,
                       class_indices=(0, 1, 2, 10, 11, 13),
                       strategy=strategy)
    mesh = tparallel.make_mesh(2, model_parallelism=2, device="cpu")
    outs = []
    for fn in (make_distill_round(spec),
               tparallel.make_sharded_distill_round(spec, mesh)):
        params = {k: v.clone() for k, v in student.items()}
        outs.append(fn(params, adam_init(split_params(params)[0]), frames,
                       labels, 6, None, LR, all_true_mask(params),
                       idx_seq=idx))
    (p1, _, m1, l1), (p2, _, m2, l2) = outs
    np.testing.assert_allclose(l2[0].item(), l1[0].item(), rtol=1e-5)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=1e-3)
    if strategy == "full_model":
        for k in ("MobilenetV2/Conv/BatchNorm/moving_mean",
                  "concat_projection/BatchNorm/moving_variance"):
            np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        d = (p2["logits/semantic/weights"]
             - p1["logits/semantic/weights"]).abs().max()
        assert float(d) <= 2 * LR * 3.2 + 1e-6
    else:
        agree = sum(int((m1[k] == m2[k]).sum()) for k in m1) \
            / sum(m1[k].numel() for k in m1)
        assert agree > 0.999, agree


def test_width_axis_needs_a_mesh_row():
    spec = DistillSpec(width_axis="model")
    with pytest.raises(ValueError, match="model axis"):
        make_distill_round(spec)
    with pytest.raises(ValueError, match="model axis"):
        make_distill_round(DistillSpec(), width_devices=[CPU, CPU])
    with pytest.raises(ValueError, match="process group"):
        tparallel.make_sharded_distill_round(
            DistillSpec(), tparallel.make_mesh(4, model_parallelism=2,
                                               device="cpu"))


def test_multi_video_round_over_a_model_axis(student):
    """``make_multi_video_round`` and ``MultiVideoServer`` split the
    videos over every device of a mesh with a model axis, as JAX's
    ``P(axes)`` does: 4 videos over ``make_mesh(4, model_parallelism=2)``
    are 4 independent rounds, to the bit."""
    from ams_tpu_torch.runtime.multi_server import MultiVideoServer

    mesh = tparallel.make_mesh(4, model_parallelism=2, device="cpu")
    spec = DistillSpec(iters=1, batch_size=2, class_indices=(0, 1, 2, 10),
                       strategy="full_model")
    rng = np.random.RandomState(3)
    params = [{k: v + 0.01 * j for k, v in student.items()}
              for j in range(4)]
    frames = [torch.from_numpy(rng.randint(0, 256, (3, 32, 64, 3)).astype(
        np.uint8)) for _ in range(4)]
    labels = [torch.from_numpy(rng.randint(0, 19, (3, 32, 64)).astype(
        np.uint8)) for _ in range(4)]

    def gens():
        return [torch.Generator().manual_seed(7 + j) for j in range(4)]

    out = tparallel.make_multi_video_round(spec, mesh)(
        tparallel.stack_videos(params),
        tparallel.stack_videos([adam_init(split_params(p)[0])
                                for p in params]),
        frames, labels, [3] * 4, gens(), LR,
        tparallel.stack_videos([all_true_mask(p) for p in params]))
    base = make_distill_round(spec)
    for j, (p, f, lab, g) in enumerate(zip(params, frames, labels, gens())):
        ref = base(p, adam_init(split_params(p)[0]), f, lab, 3, g, LR,
                   all_true_mask(p))
        assert torch.equal(out[3][j], ref[3])
        for k in ref[0]:
            assert torch.equal(out[0][k][j], ref[0][k]), k
    srv = MultiVideoServer(video_ids=(25, 22, 12, 17), height=32,
                           batch_size=2, lr=LR, mesh=mesh, device="cpu")
    assert srv.mesh is mesh and srv.videos_per_device == 1


# ------------------------------------------------------------- labeler


def test_labeler_with_a_model_axis_matches_jax():
    """tests/test_sharded_labeler.py's case: 4 frames of 32x64 over
    ``make_mesh(4, model_parallelism=2)``, f32, JAX's seeded teacher."""
    import jax

    teacher = {k: np.array(v)
               for k, v in jteacher(jax.random.PRNGKey(0)).items()}
    frames = np.random.RandomState(0).randint(
        0, 256, (4, 32, 64, 3)).astype(np.float32)
    tparams = params_from_numpy(teacher, "cpu")
    mesh = tparallel.make_mesh(4, model_parallelism=2, device="cpu")
    label = tparallel.make_sharded_labeler(mesh, tparams,
                                           compute_dtype=torch.float32)
    got = label(torch.from_numpy(frames))
    assert got.shape == (4, 32, 64) and got.dtype == torch.int32
    logits = xd.teacher_logits_nchw(tparams, torch.from_numpy(frames))
    top2 = torch.topk(logits, 2, dim=1).values
    off_ties = (top2[:, 0] - top2[:, 1]) > 1e-5
    want = torch.argmax(logits, dim=1).to(torch.int32)
    assert torch.equal(got[off_ties], want[off_ties])
    with pytest.raises(ValueError, match="divide"):
        label(torch.from_numpy(frames[:1]))

    jm = jmesh.make_mesh(4, model_parallelism=2)
    jlabel = jsharded.make_sharded_labeler(jm, teacher,
                                           compute_dtype=jnp.float32)
    t0 = time.perf_counter()
    with jm:
        jids = np.asarray(jlabel(jnp.asarray(frames)))
    print("JAX labeler over model 2: compile and run %.1f s"
          % (time.perf_counter() - t0))
    agree = float((got.numpy() == jids).mean())
    print("port against JAX labels: %.6f" % agree)
    assert agree > 0.999, agree
