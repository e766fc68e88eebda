"""The port's primitives against ams_tpu's, in f32 on the CPU.

Convolutions: both sides accumulate in f32 but in different orders (XLA's
CPU convolution vs oneDNN), so values agree to rtol 1e-5 / atol 1e-5, not
bit for bit.  The resize is the same gather + lerp in the same order, so it
must match to 1 ulp-level noise (rtol 1e-6, atol 1e-6).  The lerp tables
and the resize matrix are host numpy and must be equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.models import layers as jlayers
from ams_tpu.models import resize as jresize

from ams_tpu_torch.models import layers as tlayers
from ams_tpu_torch.models import resize as tresize


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride,rate", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("hw", [(17, 33), (16, 32)])
@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_same_matches(stride, rate, hw, k):
    rng = np.random.RandomState(stride * 10 + rate + hw[0] + k)
    x = rng.randn(2, hw[0], hw[1], 8).astype(np.float32)
    w = rng.randn(k, k, 8, 12).astype(np.float32)
    want = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride, rate=rate))
    got = _nhwc(tlayers.conv2d(_nchw(x), torch.from_numpy(w), stride=stride,
                               rate=rate))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,rate", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("hw", [(17, 33), (16, 32)])
def test_depthwise_conv2d_same_matches(stride, rate, hw):
    rng = np.random.RandomState(stride * 10 + rate + hw[0])
    x = rng.randn(2, hw[0], hw[1], 16).astype(np.float32)
    w = rng.randn(3, 3, 16, 1).astype(np.float32)
    want = np.asarray(jlayers.depthwise_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, rate=rate))
    got = _nhwc(tlayers.depthwise_conv2d(_nchw(x), torch.from_numpy(w),
                                         stride=stride, rate=rate))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eps", [jlayers.BN_EPS, 1.001e-5])
def test_batch_norm_infer_matches(eps):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    g, b, m = (rng.randn(6).astype(np.float32) for _ in range(3))
    v = rng.rand(6).astype(np.float32) + 0.1
    want = np.asarray(jlayers.batch_norm_infer(jnp.asarray(x), g, b, m, v,
                                               eps=eps))
    got = _nhwc(tlayers.batch_norm_infer(
        _nchw(x), *(torch.from_numpy(a) for a in (g, b, m, v)), eps=eps))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_relu6_matches():
    x = np.linspace(-3, 9, 97, dtype=np.float32)
    np.testing.assert_array_equal(tlayers.relu6(torch.from_numpy(x)).numpy(),
                                  np.asarray(jlayers.relu6(jnp.asarray(x))))


@pytest.mark.parametrize("in_out", [(5, 64), (9, 128), (33, 512), (65, 1024),
                                    (17, 257), (7, 7), (1, 4)])
def test_lerp_weights_and_resize_matrix_equal(in_out):
    n_in, n_out = in_out
    jlo, jhi, jw = jresize._lerp_weights(n_in, n_out, jnp.float32)
    tlo, thi, tw = tresize._lerp_weights(n_in, n_out)
    np.testing.assert_array_equal(tlo, np.asarray(jlo))
    np.testing.assert_array_equal(thi, np.asarray(jhi))
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tresize.resize_matrix(n_in, n_out),
                                  jresize.resize_matrix(n_in, n_out))


@pytest.mark.parametrize("shape,out_hw", [((2, 5, 9, 19), (64, 128)),
                                          ((1, 17, 33, 6), (257, 513)),
                                          ((2, 9, 13, 4), (9, 13))])
def test_resize_bilinear_ac_matches(shape, out_hw):
    rng = np.random.RandomState(shape[1])
    x = (rng.randn(*shape) * 3).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_ac(jnp.asarray(x), out_hw))
    got = tresize.resize_bilinear_ac(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
