"""The port's training-mode primitives and student against ams_tpu's, on the CPU.

Batch norm, the moving-average update and the matmul-form resize take the
same seeded numpy inputs in both packages.  The train-mode student runs on
the TF-executed parity fixture's params and frames (read-only), and is
held to ams_tpu and to the fixture's TF ``logits_train_bn``.

Tolerances: batch norm and the moving-average update are a few f32 ops on
sums taken in another order: rtol 1e-5 / atol 1e-5 (statistics of 4k
values).  The matmul resize reassociates its sums: rtol 1e-5 / atol 1e-5.
Train-mode logits: rtol 1e-4 / atol 1e-4, the bar of test_torch_student.py
and tests/test_parity_student.py (f32 sums in another order through ~60
layers).  The recorded batch statistics of the trunk: rtol 1e-5 /
atol 5e-5 (measured worst 4.7e-5 on a variance of 5.7).  Those of the head
(aspp0, image_pooling, concat_projection): rtol 1e-4 / atol 3e-4, because
the image-pooling BN normalizes one pooled value per frame (2 values per
channel here, eps 1e-5), which magnifies the packages' f32 summation noise
in concat_projection's input (measured worst 2.2e-4, on a mean of 0.006).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.models import layers as jlayers
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.models import resize as jresize

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.models import layers as tlayers
from ams_tpu_torch.models import mobilenetv2_deeplab as tm
from ams_tpu_torch.models import resize as tresize


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("eps", [tlayers.BN_EPS, tm.HEAD_BN_EPS])
def test_batch_norm_train_matches(eps):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 9, 17, 8) * 2 + 1).astype(np.float32)
    gamma = rng.rand(8).astype(np.float32) + 0.5
    beta = rng.randn(8).astype(np.float32)
    jy, jmean, jvar = jlayers.batch_norm_train(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), eps=eps)
    ty, tmean, tvar = tlayers.batch_norm_train(
        _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), eps=eps)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-5,
                               atol=1e-5)
    assert tlayers.BN_DECAY == jlayers.BN_DECAY


@pytest.mark.parametrize("bessel", [True, False])
def test_moving_average_update_matches(bessel):
    rng = np.random.RandomState(1)
    moving = rng.rand(16).astype(np.float32)
    stat = rng.rand(16).astype(np.float32)
    want = np.asarray(jlayers.moving_average_update(
        jnp.asarray(moving), jnp.asarray(stat), n_elems=6 * 32 * 64,
        bessel=bessel))
    got = tlayers.moving_average_update(
        torch.from_numpy(moving), torch.from_numpy(stat),
        n_elems=6 * 32 * 64, bessel=bessel).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("out_hw", [(64, 128), (65, 127)])
def test_resize_bilinear_ac_matmul_matches(out_hw):
    x = np.random.RandomState(2).randn(2, 5, 9, 6).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_ac_matmul(jnp.asarray(x),
                                                        out_hw))
    got = tresize.resize_bilinear_ac_matmul(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    gather = tresize.resize_bilinear_ac(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def fixture_case(student_parity_fixture):
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    return params, fx["frames"], fx["logits_train_bn"]


def test_train_mode_logits_and_stats_match(fixture_case):
    params, frames, tf_logits = fixture_case
    j_stats = {}
    j_logits = np.asarray(jm.student_logits(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(frames),
        train=True, stats_out=j_stats))
    t_stats = {}
    with torch.no_grad():
        t_logits = tm.student_logits(params_from_numpy(params, "cpu"),
                                     torch.from_numpy(frames), train=True,
                                     stats_out=t_stats).numpy()
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_logits, tf_logits, rtol=1e-4, atol=1e-4)
    assert sorted(t_stats) == sorted(j_stats)
    assert len(t_stats) == len([k for k in params if "moving_" in k])
    for k, v in j_stats.items():
        trunk = k.startswith("MobilenetV2/")
        np.testing.assert_allclose(t_stats[k].numpy(), np.asarray(v),
                                   rtol=1e-5 if trunk else 1e-4,
                                   atol=5e-5 if trunk else 3e-4, err_msg=k)


def test_train_mode_grid_and_forward_match(fixture_case):
    params, frames, _ = fixture_case
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_numpy(params, "cpu")
    ci = (0, 1, 2, 5, 8, 13)
    j_grid = np.asarray(jm.student_grid_logits(
        jp, jnp.asarray(frames), train=True, compute_dtype=jnp.float32))
    j_red, _ = jm.student_forward(jp, jnp.asarray(frames), ci, train=True)
    with torch.no_grad():
        t_grid = tm.student_grid_logits(tp, torch.from_numpy(frames),
                                        train=True).numpy()
        t_red, _ = tm.student_forward(tp, torch.from_numpy(frames), ci,
                                      train=True)
    np.testing.assert_allclose(t_grid, j_grid, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_red.numpy(), np.asarray(j_red), rtol=1e-4,
                               atol=1e-4)
