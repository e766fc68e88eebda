"""The port's student forward (inference mode) against ams_tpu's, on the CPU.

Weights: the TF-executed parity fixture's params (read-only), with moving
statistics set to the batch moments that ams_tpu's training-mode forward
records on the fixture frames, so inference-mode batch norm sees realistic
statistics.  The same numpy arrays go through both packages.

Tolerances: both sides compute in f32 but sum in different orders (XLA's
CPU convolutions vs oneDNN) through ~60 layers, so logits agree to
rtol 1e-4 / atol 1e-4 -- the bar tests/test_parity_student.py holds ams_tpu
to against TF.  Ids must be equal wherever the top-2 margin of the JAX
logits exceeds 1e-4, and that must be over 99% of pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.models import mobilenetv2_deeplab as jm

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.models import mobilenetv2_deeplab as tm

RTOL = ATOL = 1e-4
TIE_MARGIN = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case(student_parity_fixture):
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    frames = fx["frames"]
    stats = {}
    jm.student_logits({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(frames), train=True, stats_out=stats)
    params.update({k: np.asarray(v, np.float32) for k, v in stats.items()})
    return params, frames


def _decisive(logits):
    srt = np.sort(logits, -1)
    d = (srt[..., -1] - srt[..., -2]) > TIE_MARGIN
    assert d.mean() > 0.99
    return d


def test_init_params_names_and_shapes_match():
    ours = tm.init_student_params(0, device="cpu")
    ref = jm.init_student_params(jax.random.PRNGKey(0))
    assert list(ours) == list(ref)
    for k in ref:
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
    assert tm.trainable_names(ours) == jm.trainable_names(ref)


def test_preprocess_matches():
    frames = np.random.RandomState(0).randint(
        0, 256, (2, 9, 14, 3)).astype(np.uint8)
    want = np.asarray(jm.preprocess(jnp.asarray(frames)))
    got = tm.preprocess(torch.from_numpy(frames)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_grid_logits_match(case):
    params, frames = case
    want = np.asarray(jm.student_grid_logits(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(frames),
        compute_dtype=jnp.float32))
    with torch.inference_mode():
        got = tm.student_grid_logits(params_from_numpy(params, "cpu"),
                                     torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, 5, 9, 19)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("exp", [0, 25])
def test_logits_forward_and_fast_predict_match(case, exp):
    params, frames = case
    ci = tuple(int(c) for c in configs.class_indices(exp))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    logits = np.asarray(jm.student_logits(jp, jnp.asarray(frames)))
    j_red, j_preds = jm.student_forward(jp, jnp.asarray(frames), ci)
    j_fast = np.asarray(jm.student_predict_fast(
        jp, jnp.asarray(frames), ci, compute_dtype=jnp.float32,
        interpret=True))
    tp = params_from_numpy(params, "cpu")
    t_frames = torch.from_numpy(frames)
    with torch.inference_mode():
        t_logits = tm.student_logits(tp, t_frames).numpy()
        t_red, t_preds = tm.student_forward(tp, t_frames, ci)
        t_fast = tm.student_predict_fast(tp, t_frames, ci).numpy()
    np.testing.assert_allclose(t_logits, logits, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_red.numpy(), np.asarray(j_red), rtol=RTOL,
                               atol=ATOL)
    decisive = _decisive(np.asarray(j_red))
    for ours, ref in ((t_preds.numpy(), np.asarray(j_preds)),
                      (t_fast, j_fast)):
        assert ours.dtype == np.int32 and ours.shape == frames.shape[:3]
        np.testing.assert_array_equal(ours[decisive], ref[decisive])
