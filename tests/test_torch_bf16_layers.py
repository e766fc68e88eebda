"""The port's bf16 layers and unfolded bf16 student against ams_tpu's.

``layers.conv2d`` / ``depthwise_conv2d`` with ``compute_dtype=bfloat16``
cast both operands and accumulate in f32 (oneDNN here, cuDNN on the card;
XLA in JAX), returning bf16: bar rtol 2^-7 / atol 2^-7 of the output's
scale (one bf16 ulp; a sum that lands on a rounding boundary may round
the other way); measured max |error| 0.0156 at |values| up to 10.75 (one
ulp), on under 0.01% of outputs.

The unfolded frozen student in bf16 (inference BN stays bf16, as JAX's
``batch_norm_infer`` casts its scale and offset to the activation's type)
is held against JAX on a 1x65x129 frame with the logits scaled x300:
logits within 2^-6 of their scale and argmax agreement above 0.99 (the
bar of tests/test_fused_mbconv.py:134).  Measured: the grid logits
(bf16 preprocessing, ``student_grid_logits``) equal bit for bit, and the
ids of ``student_predict_fast`` all equal; through ``student_forward``
(f32 preprocessing, then bf16) the logits are within 0.003 of their
scale and 0.99976 of the ids agree, a one-ulp rounding flip in an early
convolution carried through the trunk.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.models import layers as jl
from ams_tpu.models import mobilenetv2_deeplab as jm

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.models import layers as tl
from ams_tpu_torch.models import mobilenetv2_deeplab as tm

BAR = 2.0 ** -7
CI = (0, 1, 2, 5, 8, 10, 11, 13)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol, atol_scale):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


@pytest.mark.parametrize("k,stride,rate,hw", [
    (1, 1, 1, (9, 13)), (3, 2, 1, (17, 33)), (3, 2, 1, (16, 32)),
    (3, 1, 2, (11, 15))])
def test_bf16_conv2d_matches(k, stride, rate, hw):
    rng = np.random.RandomState(k * 10 + stride + rate)
    x = rng.randn(2, *hw, 24).astype(np.float32)
    w = (rng.randn(k, k, 24, 40) * 0.2).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(w),
                                stride=stride, rate=rate,
                                compute_dtype=jnp.bfloat16), np.float32)
    got = tl.conv2d(_nchw(x), torch.from_numpy(w), stride=stride, rate=rate,
                    compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(_nhwc(got), want, BAR, BAR)


@pytest.mark.parametrize("stride,rate,hw", [
    (1, 1, (9, 13)), (2, 1, (17, 33)), (2, 1, (16, 32)), (1, 2, (11, 15))])
def test_bf16_depthwise_conv2d_matches(stride, rate, hw):
    rng = np.random.RandomState(stride * 10 + rate)
    x = rng.randn(2, *hw, 48).astype(np.float32)
    w = (rng.randn(3, 3, 48, 1) * 0.3).astype(np.float32)
    want = np.asarray(jl.depthwise_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, rate=rate,
        compute_dtype=jnp.bfloat16), np.float32)
    got = tl.depthwise_conv2d(_nchw(x), torch.from_numpy(w), stride=stride,
                              rate=rate, compute_dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    _close(_nhwc(got), want, BAR, BAR)


def test_bf16_batch_norm_infer_stays_bf16():
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(2, 5, 6, 16), jnp.bfloat16)
    g, b, m, v = (rng.rand(16).astype(np.float32) + 0.5 for _ in range(4))
    want = np.asarray(jl.batch_norm_infer(x, g, b, m, v), np.float32)
    got = tl.batch_norm_infer(
        _nchw(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16),
        *(torch.from_numpy(a) for a in (g, b, m, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.fixture(scope="module")
def student():
    params = jm.init_student_params(jax.random.PRNGKey(1))
    params["logits/semantic/weights"] = (
        params["logits/semantic/weights"] * 300.0)
    frames = np.random.RandomState(1).randint(
        0, 256, (1, 65, 129, 3)).astype(np.float32)
    return params, params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu"), frames


def test_unfolded_bf16_forward_matches(student):
    jp, tp, frames = student
    j_red, j_ids = jm.student_forward(jp, jnp.asarray(frames), CI,
                                      compute_dtype=jnp.bfloat16)
    j_grid = np.asarray(jm.student_grid_logits(
        jp, jnp.asarray(frames), compute_dtype=jnp.bfloat16), np.float32)
    with torch.inference_mode():
        t_red, t_ids = tm.student_forward(tp, torch.from_numpy(frames), CI,
                                          compute_dtype=torch.bfloat16)
        t_grid = tm.student_grid_logits(tp, torch.from_numpy(frames),
                                        compute_dtype=torch.bfloat16)
    assert t_red.dtype == torch.float32 and t_grid.dtype == torch.bfloat16
    _close(t_red.numpy(), np.asarray(j_red), 2.0 ** -6, 2.0 ** -6)
    _close(t_grid.float().numpy(), j_grid, 2.0 ** -6, 2.0 ** -6)
    assert (t_ids.numpy() == np.asarray(j_ids)).mean() > 0.99


def test_bf16_predict_fast_matches(student):
    jp, tp, frames = student
    want = np.asarray(jm.student_predict_fast(
        jp, jnp.asarray(frames), CI, compute_dtype=jnp.bfloat16,
        interpret=True))
    with torch.inference_mode():
        got = tm.student_predict_fast(tp, torch.from_numpy(frames), CI,
                                      compute_dtype=torch.bfloat16)
        default = tm.student_predict_fast(tp, torch.from_numpy(frames), CI)
        f32 = tm.student_predict_fast(tp, torch.from_numpy(frames), CI,
                                      compute_dtype=torch.float32)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).mean() > 0.99
    # the port's default stays float32 (JAX's student_predict_fast
    # defaults to bfloat16)
    assert torch.equal(default, f32)


def test_bf16_training_raises(student):
    """Train mode runs in bf16 (the mixed-precision round): f32
    preprocessing, bf16 convolutions and activations, BN moments in f32.
    The first block's recorded moments match JAX's bf16 train forward to
    2e-5 (measured 3.5e-6 at worst, at 65x129; deeper blocks drift by
    bf16 rounding per operation, which tests/test_torch_bf16_round.py
    gates on a whole round).  A compute type other than float32 or
    bfloat16 raises."""
    jp, tp, frames = student
    js, ts = {}, {}
    jm.student_grid_logits(jp, jnp.asarray(frames), train=True,
                           stats_out=js, compute_dtype=jnp.bfloat16)
    grid = tm.student_grid_logits(tp, torch.from_numpy(frames), train=True,
                                  stats_out=ts, compute_dtype="bfloat16")
    assert grid.dtype == torch.bfloat16 and set(ts) == set(js)
    assert all(v.dtype == torch.float32 for v in ts.values())
    first = [k for k in js if k.startswith(("MobilenetV2/Conv/",
                                            "MobilenetV2/expanded_conv/"))]
    assert len(first) == 6
    for k in first:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=0, atol=2e-5, err_msg=k)
    with pytest.raises(ValueError):
        tm.student_logits(tp, torch.from_numpy(frames), train=True,
                          compute_dtype="float16")
