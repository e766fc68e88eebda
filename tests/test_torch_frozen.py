"""The port's BN-folded deploy against ams_tpu's, on the CPU.

Folding runs the same numpy expressions in both packages, so the folded
artifacts must be equal bit for bit.  The folded forwards agree to
rtol 1e-4 / atol 1e-4 (f32, different summation orders; the bar of
tests/test_parity_student.py).  The scoring functions must give equal
confusion matrices wherever every pixel is decisive (top-2 margin above
1e-4, asserted), and per-frame CE losses equal to rtol 1e-5 (f32
log-softmax and sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.models import frozen as jf
from ams_tpu.models import mobilenetv2_deeplab as jm

from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
from ams_tpu_torch.models import frozen as tf

RTOL = ATOL = 1e-4
TIE_MARGIN = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case(student_parity_fixture):
    """Fixture params with data-derived moving statistics, their folded
    form from ams_tpu, frames, and teacher labels with 5% ignore ids."""
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    frames = fx["frames"]
    stats = {}
    jm.student_logits({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(frames), train=True, stats_out=stats)
    params.update({k: np.asarray(v, np.float32) for k, v in stats.items()})
    rng = np.random.RandomState(11)
    labels = rng.randint(0, 19, frames.shape[:3]).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    j_folded = {k: np.asarray(v) for k, v in jf.fold_student(
        {k: jnp.asarray(v) for k, v in params.items()}).items()}
    return params, j_folded, frames, labels


def test_fold_student_bit_equal(case):
    params, j_folded = case[0], case[1]
    ours = params_to_numpy(tf.fold_student(params))
    assert list(ours) == list(j_folded)
    for k in j_folded:
        assert ours[k].dtype == j_folded[k].dtype
        np.testing.assert_array_equal(ours[k], j_folded[k])
    assert tf.is_folded(ours) and not tf.is_folded(params)


@pytest.mark.parametrize("exp", [0, 25])
def test_folded_forward_and_fast_predict_match(case, exp):
    _, j_folded, frames, _ = case
    ci = tuple(int(c) for c in configs.class_indices(exp))
    jp = {k: jnp.asarray(v) for k, v in j_folded.items()}
    want = np.asarray(jf.student_forward_folded(
        jp, jnp.asarray(frames), class_indices=ci, compute_dtype=jnp.float32))
    want_fast = np.asarray(jf.student_predict_fast_folded(
        jp, jnp.asarray(frames), ci, compute_dtype=jnp.float32,
        interpret=True))
    tp = params_from_numpy(j_folded, "cpu")
    with torch.inference_mode():
        got = tf.student_forward_folded(tp, torch.from_numpy(frames),
                                        class_indices=ci).numpy()
        got_grid = tf.student_forward_folded(tp, torch.from_numpy(frames),
                                             class_indices=ci,
                                             out_hw=None).numpy()
        got_fast = tf.student_predict_fast_folded(
            tp, torch.from_numpy(frames), ci).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got_grid.shape == (2, 5, 9, len(ci))
    srt = np.sort(want, -1)
    decisive = (srt[..., -1] - srt[..., -2]) > TIE_MARGIN
    assert decisive.mean() > 0.99
    np.testing.assert_array_equal(got_fast[decisive], want_fast[decisive])


@pytest.mark.parametrize("exp", [0, 25])
def test_folded_scoring_matches(case, exp):
    _, j_folded, frames, labels = case
    ci = tuple(int(c) for c in configs.class_indices(exp))
    jp = {k: jnp.asarray(v) for k, v in j_folded.items()}
    j_preds, j_cm, j_loss = jf.make_predict_fn_folded(19, ci)(
        jp, jnp.asarray(frames), jnp.asarray(labels))
    js_preds, js_cm, js_loss = jf.make_predict_seq_fn_folded(19, ci)(
        jp, jnp.asarray(frames), jnp.asarray(labels))
    reduced = np.asarray(jf.student_forward_folded(
        jp, jnp.asarray(frames), class_indices=ci, compute_dtype=jnp.float32))
    srt = np.sort(reduced, -1)
    assert ((srt[..., -1] - srt[..., -2]) > TIE_MARGIN).all()

    tp = params_from_numpy(j_folded, "cpu")
    t_frames, t_labels = torch.from_numpy(frames), torch.from_numpy(labels)
    t_preds, t_cm, t_loss = tf.make_predict_fn_folded(19, ci)(
        tp, t_frames, t_labels)
    ts_preds, ts_cm, ts_loss = tf.make_predict_seq_fn_folded(19, ci)(
        tp, t_frames, t_labels)
    np.testing.assert_array_equal(t_preds.numpy(), np.asarray(j_preds))
    np.testing.assert_array_equal(ts_preds.numpy(), np.asarray(js_preds))
    np.testing.assert_array_equal(t_cm.numpy(), np.asarray(j_cm))
    np.testing.assert_array_equal(ts_cm.numpy(), np.asarray(js_cm))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(ts_loss.numpy(), np.asarray(js_loss),
                               rtol=1e-5)
