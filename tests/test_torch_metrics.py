"""The port's soft confusion matrices against ams_tpu's, on the CPU.

``iou_from_confusion``, ``prob_confmat``, ``prob_confmat_star`` and
``soft_miou`` of ``ams_tpu_torch/utils/metrics.py`` on the same seeded
numpy inputs as ``ams_tpu/utils/metrics.py``'s, at rtol 1e-6 (f32 sums in
another order: the port adds probability rows with ``index_add_`` where
JAX contracts a one-hot matmul); plus the two property tests of
tests/test_compat.py.
"""

import numpy as np
import pytest
import torch

from ams_tpu.utils import metrics as jmetrics

from ams_tpu_torch.utils import metrics as tmetrics

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _probs(rng, shape, c):
    p = rng.rand(*shape, c).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def test_iou_from_confusion_matches_with_absent_classes():
    rng = np.random.RandomState(0)
    cm = rng.randint(0, 50, (7, 7)).astype(np.float32)
    cm[3, :] = 0
    cm[:, 3] = 0          # class 3 absent: NaN in both
    want = np.asarray(jmetrics.iou_from_confusion(cm))
    got = tmetrics.iou_from_confusion(cm).numpy()
    assert np.isnan(got[3]) and np.isnan(want[3])
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("n_cls,shape", [(7, (4, 8, 8)), (19, (2, 32, 64))])
def test_prob_confmat_and_soft_miou_match(n_cls, shape):
    rng = np.random.RandomState(n_cls)
    labels = rng.randint(0, n_cls, shape)
    labels.reshape(-1)[::11] = 255         # outside [0, C): adds nothing
    probs = _probs(rng, shape, n_cls)
    want = np.asarray(jmetrics.prob_confmat(labels, probs, n_cls))
    got = tmetrics.prob_confmat(labels, probs, n_cls).numpy()
    assert got.shape == want.shape == (n_cls, n_cls)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(float(tmetrics.soft_miou(got)),
                               float(jmetrics.soft_miou(want)), rtol=RTOL)


def test_prob_confmat_star_matches():
    rng = np.random.RandomState(3)
    sl = rng.randint(0, 5, (2, 6, 6))
    tl = rng.randint(0, 5, (2, 6, 6))
    w = (rng.rand(2, 6, 6) > 0.3).astype(np.float32) * rng.rand(2, 6, 6)
    probs = _probs(rng, (2, 6, 6), 5)
    js, jt = jmetrics.prob_confmat_star(sl, tl, w, probs, 5)
    ts, tt = tmetrics.prob_confmat_star(sl, tl, w, probs, 5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL)


def test_soft_miou_has_no_nan_guard():
    """A class with no mass makes 0/0: JAX's plain mean is NaN, and so is
    the port's."""
    mat = np.eye(3, dtype=np.float32)
    mat[2, 2] = 0
    assert np.isnan(float(jmetrics.soft_miou(mat)))
    assert np.isnan(float(tmetrics.soft_miou(mat)))


def test_prob_confmat_properties():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 7, (4, 8, 8))
    probs = rng.rand(4, 8, 8, 7).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    mat = tmetrics.prob_confmat(labels, probs, 7).numpy()
    assert mat.shape == (7, 7)
    # total mass = number of pixels (probs are normalized)
    np.testing.assert_allclose(mat.sum(), labels.size, rtol=1e-5)
    # column i mass = count of pixels the student labelled i
    np.testing.assert_allclose(mat.sum(0), np.bincount(labels.ravel(),
                                                       minlength=7),
                               rtol=1e-4)
    m = float(tmetrics.soft_miou(mat))
    assert 0 <= m <= 1


def test_prob_confmat_star_masks_invalid():
    rng = np.random.RandomState(1)
    sl = rng.randint(0, 5, (2, 4, 4))
    tl = rng.randint(0, 5, (2, 4, 4))
    probs = rng.rand(2, 4, 4, 5).astype(np.float32)
    w = np.zeros((2, 4, 4), np.float32)  # everything invalid
    ms, mt = tmetrics.prob_confmat_star(sl, tl, w, probs, 5)
    assert float(ms.abs().sum()) == 0
    assert float(mt.abs().sum()) == 0
    w[...] = 1
    ms, _ = tmetrics.prob_confmat_star(sl, tl, w, probs, 5)
    expect = tmetrics.prob_confmat(sl, probs, 5).numpy()
    np.testing.assert_allclose(ms.numpy(), expect, rtol=1e-5)
