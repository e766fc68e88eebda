"""The port's space-to-depth stem (``layers.conv2d_stride2_s2d``,
``backbone(..., s2d_stem=True)``) on the CPU: the counterparts of the 3
tests of tests/test_s2d_stem.py, plus the layer against ams_tpu's
``conv2d_stride2_s2d`` on the same numpy inputs at 65x129 (atol 1e-4,
f32; the port's activations are NCHW, JAX's NHWC)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.models import layers as jlayers

from ams_tpu_torch.models import layers
from ams_tpu_torch.models import mobilenetv2_deeplab as m


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_s2d_conv_matches_stride2_same():
    rng = np.random.RandomState(0)
    # odd dims like the +1-padded DeepLab input
    for h, w in ((33, 65), (65, 129)):
        x = _nchw(rng.randn(2, h, w, 3).astype(np.float32))
        k = torch.from_numpy(rng.randn(3, 3, 3, 16).astype(np.float32) * 0.2)
        want = layers.conv2d(x, k, stride=2)
        got = layers.conv2d_stride2_s2d(x, k)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_fast_path_unchanged_predictions():
    """The s2d stem leaves the student's predictions as the plain stem
    gives them, and the fast path agrees with the precise forward (JAX's
    bar, 0.9)."""
    params = m.init_student_params(0, device="cpu")
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 64, 128, 3)).astype(np.float32))
    ci = (0, 1, 2, 10, 11, 13)
    _, precise = m.student_forward(params, frames, ci)
    fast = m.student_predict_fast(params, frames, ci)
    assert (precise == fast).float().mean() > 0.9
    x = m.preprocess(frames)
    plain = m.backbone(params, x)
    s2d = m.backbone(params, x, s2d_stem=True)
    np.testing.assert_allclose(s2d.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_s2d_conv_rejects_even_sizes():
    """Even H or W has another TF-SAME padding (0 on top/left): the
    restructuring would sample every tap one row/col off, so it raises."""
    x = torch.zeros((1, 3, 8, 9))
    w = torch.zeros((3, 3, 3, 4))
    with pytest.raises(ValueError, match="odd"):
        layers.conv2d_stride2_s2d(x, w)
    with pytest.raises(ValueError, match="odd"):
        layers.conv2d_stride2_s2d(torch.zeros((1, 3, 9, 8)), w)


@pytest.mark.parametrize("cout", [16, 32])
def test_s2d_matches_jax_layer(cout):
    rng = np.random.RandomState(cout)
    x = rng.randn(2, 65, 129, 3).astype(np.float32)
    k = (rng.randn(3, 3, 3, cout) * 0.2).astype(np.float32)
    want = np.asarray(jlayers.conv2d_stride2_s2d(jnp.asarray(x),
                                                 jnp.asarray(k)))
    got = layers.conv2d_stride2_s2d(_nchw(x), torch.from_numpy(k))
    assert got.shape == (2, cout, 33, 65)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)
