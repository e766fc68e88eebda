"""The port's legacy builder API (``ams_tpu_torch/compat.py``) against
ams_tpu's ``compat.py``, on the CPU.

The counterparts of tests/test_compat.py's builder tests and of its
``PhaseTimer`` test, on the port's seeded init (``meta_dir=None``) and
``device="cpu"`` (its two soft-confusion-matrix property tests are in
tests/test_torch_metrics.py, beside the metrics); the slow-marked v2 test
runs in seconds here and is not marked.  Then each builder against JAX's
builder on JAX's init passed to both as a .npy ``meta_dir`` (the teacher's
as a .npz under ``teacher/`` names; the client's, the TF1 fixture's
prefix): predictions equal off near-ties (where JAX's top-2 logit margin
exceeds twice the largest logit difference between the packages, and off
the confidence gate's edge by 1e-4); loss, drift and regularizer
at rtol 1e-5; ``training_var_names`` as equal lists; two train steps at
tests/test_torch_round.py's gates (losses within 1e-5, then 5e-4; no
weight beyond 2.05 lr per step; BN statistics within 0.1 of max(|v|, 1));
``train_coord``'s unmasked coordinates bitwise frozen.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu import compat as jcompat
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.models.mobilenetv2_deeplab import init_student_params

from ams_tpu_torch import compat
from ams_tpu_torch.distill.train_step import split_params
from ams_tpu_torch.models import mobilenetv2_deeplab as tm
from ams_tpu_torch.models.xception_deeplab import init_teacher_params
from ams_tpu_torch.utils.trace import PhaseTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")
LR = 1e-3
# tests/test_torch_round.py's loss gates per iteration, train-mode BN
STEP_LOSS_ATOL = (1e-5, 5e-4)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _cw(idx, n=19):
    w = np.zeros((n, 1), np.float32)
    w[list(idx)] = 1
    return w


def _frames(seed, b=1, h=32, w=64):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(
        np.float32)


def _labels(seed, b=1, h=32, w=64):
    lab = np.random.RandomState(seed).randint(0, 19, (b, h, w))
    lab[:, :2] = 255                       # ignored pixels
    return lab


# --- the counterparts of tests/test_compat.py ---------------------------

def test_create_student_v3_handles():
    student = compat.create_student_v3(None, class_weights=_cw([0, 2, 13]),
                                       device="cpu")
    frames, labels = _frames(0), _labels(1)
    lg = student["logits"](student["params"], frames)
    assert lg.shape == (1, 32, 64, 19)
    red = student["logits_reduced"](student["params"], frames)
    assert red.shape == (1, 32, 64, 3)
    preds = student["predictions"](student["params"], frames)
    assert int(preds.max()) <= 2
    loss = student["loss"](student["params"], frames, labels)
    assert np.isfinite(float(loss))
    cm = student["update_op"](student["params"], frames, labels)
    assert cm.shape == (3, 3)
    # raw labels in: 255 and unselected classes weigh 0
    assert float(cm.sum()) == np.isin(labels, [0, 2, 13]).sum()


def test_create_teacher_handles():
    teacher = compat.create_teacher(None, class_weights=_cw([0, 13]),
                                    device="cpu")
    frames = _frames(0, h=33, w=65)
    preds = teacher["predictions"](frames)
    assert preds.shape == (1, 33, 65)
    red = teacher["predictions_reduced"](frames)
    assert int(red.max()) <= 1


def test_create_client_threshold():
    client = compat.create_client(None, class_weights=_cw([0, 2, 13]),
                                  threshold=0.99, map_misc=1, device="cpu")
    frames = _frames(0)
    preds = client["predictions"](frames)
    assert isinstance(preds, np.ndarray)
    # with random weights max softmax over 3 classes rarely exceeds 0.99:
    # most pixels map to map_misc
    assert (preds == 1).mean() > 0.5
    colored = client["output_colored"](frames)
    assert colored.shape == (1, 32, 64, 3)


def test_phase_timer():
    t = PhaseTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    s = t.summary()
    assert "a" in s and "mean_ms" in s


def test_v3_training_var_names_filters():
    """No expanded_conv_4..12 (by substring), nothing >= 1e4 elements;
    biases-only drops 'weight' names."""
    s = compat.create_student_v3(None, class_weights=_cw([0, 2, 13]),
                                 device="cpu")
    names = s["training_var_names"]
    assert names
    assert not any("conv_%d/" % i in n for n in names for i in range(4, 13))
    assert all(s["params"][n].numel() < 1e4 for n in names)
    s_b = compat.create_student_v3(None, class_weights=_cw([0, 2, 13]),
                                   train_biases_only=True, device="cpu")
    assert all("weight" not in n for n in s_b["training_var_names"])


def test_v3_drift_and_regularize():
    cw = _cw([0, 2, 13])
    s = compat.create_student_v3(None, class_weights=cw, regularize=True,
                                 device="cpu")
    s0 = compat.create_student_v3(None, class_weights=cw, device="cpu")
    frames, labels = _frames(0), _labels(1)
    base = float(s0["loss"](s0["params"], frames, labels))
    reg = float(s["loss"](s["params"], frames, labels))
    expect = 0.01 * float(np.mean(
        [np.sum(np.square(s["params"][k].numpy())) / 2
         for k in s["training_var_names"]]))
    np.testing.assert_allclose(reg - base, expect, rtol=1e-4)
    assert float(s["drift_loss"](s["params"])) == 0.0
    moved = dict(s["params"])
    k = s["training_var_names"][0]
    moved[k] = moved[k] + 0.1
    assert float(s["drift_loss"](moved)) > 0
    assert np.isfinite(float(s0["loss_sel"](s0["params"], frames, labels)))


def test_v2_threshold_gate_and_biases_only_train():
    cw = _cw([0, 2, 13])
    frames, labels = _frames(0), _labels(1)
    gated = compat.create_student_v2(None, class_weights=cw, threshold=0.99,
                                     map_misc=2, device="cpu")
    preds = gated["predictions"](gated["params"], frames).numpy()
    assert (preds == 2).mean() > 0.5  # random weights rarely clear 0.99

    # v2 honors train_biases_only in the train op (var_list=tvars):
    # weights must not move, non-weight trainables must
    s = compat.create_student_v2(None, class_weights=cw,
                                 train_biases_only=True, device="cpu")
    opt = s["opt_init"]()
    p0 = {k: v.clone() for k, v in s["params"].items()}
    p1, opt, loss = s["train"](s["params"], opt, frames, labels, 1e-2)
    assert np.isfinite(float(loss))
    moved = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    assert moved
    assert all("weight" not in k for k in moved)
    assert all("moving_" not in k for k in moved)


def test_v1_cache_flow():
    """v1's image/label cache: load once, train repeatedly on the pair."""
    s = compat.create_student(None, class_weights=_cw([0, 2, 13]),
                              device="cpu")
    s["load_image"](_frames(0))
    s["load_label"](_labels(1))
    opt = s["opt_init"]()
    p, opt, l1 = s["train_cached"](s["params"], opt, 1e-2)
    p, opt, l2 = s["train_cached"](p, opt, 1e-2)
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    empty = compat.create_student(None, device="cpu")
    with pytest.raises(ValueError, match="load_image"):
        empty["train_cached"](empty["params"], empty["opt_init"](), 1e-2)


def test_v3_train_advances_bn_and_masks_freeze_params():
    """v3 train runs under BN control deps: moving statistics advance
    every step; the masked train_coord reverts unmasked coords while Adam
    slots advance."""
    student = compat.create_student_v3(None, class_weights=_cw([0, 2, 13]),
                                       device="cpu")
    params = student["params"]
    opt = student["opt_init"]()
    frames, labels = _frames(2, b=2), _labels(3, b=2)

    new_p, opt1, loss = student["train"](params, opt, frames, labels, LR)
    assert np.isfinite(float(loss))
    assert set(new_p) == set(params)
    stat = "MobilenetV2/Conv/BatchNorm/moving_mean"
    assert not torch.allclose(new_p[stat], params[stat])
    w = "logits/semantic/weights"
    assert not torch.allclose(new_p[w], params[w])
    assert int(opt1.step) == 1

    sub, _ = split_params(params)
    masks = {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in sub.items()}
    frozen_p, opt2, _ = student["train_coord"](params, opt, frames, labels,
                                               LR, masks)
    for k in sub:
        assert torch.equal(frozen_p[k], params[k]), k
    assert int(opt2.step) == 1
    assert not torch.allclose(opt2.m[w], torch.zeros(()))


def test_compat_missing_checkpoint_raises():
    """meta_dir=None opts into a seeded init; a missing PATH raises."""
    with pytest.raises(FileNotFoundError):
        compat.create_student_v3("/no/such/ckpt.npz", device="cpu")
    with pytest.raises(FileNotFoundError):
        compat.create_teacher("/no/such/teacher.npz", device="cpu")
    with pytest.raises(FileNotFoundError):
        compat.create_client("/no/such/student", device="cpu")


# --- against JAX's builders on JAX's init --------------------------------

@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    params = {k: np.asarray(v)
              for k, v in init_student_params(jax.random.PRNGKey(0)).items()}
    path = str(tmp_path_factory.mktemp("compat") / "student.npy")
    np.save(path, params, allow_pickle=True)
    return path, params


def _equal_off_ties(ours, ref, our_logits, ref_logits, keep=True):
    """Ids equal wherever JAX's top-2 logit margin exceeds twice the
    largest logit difference between the packages (and ``keep`` holds)."""
    our_logits = np.asarray(our_logits, np.float64)
    ref_logits = np.asarray(ref_logits, np.float64)
    eps = 2 * np.abs(our_logits - ref_logits).max()
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = ((top2[..., 1] - top2[..., 0]) > eps) & keep
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert clear.mean() > 0.5, clear.mean()
    np.testing.assert_array_equal(ours[clear], ref[clear])


def _close_steps(ours, ref, steps, lr):
    for k, rv in ref.items():
        rv = np.asarray(rv)
        d = np.abs(ours[k].numpy() - rv)
        if "moving_" in k:        # test_torch_round.py's BN bar
            assert np.all(d <= 0.1 * np.maximum(np.abs(rv), 1)), k
        else:
            assert d.max() <= 2.05 * lr * steps, (k, d.max())


@pytest.mark.parametrize("regularize", [False, True])
def test_v3_matches_jax(jax_init, regularize):
    path, _ = jax_init
    cw = _cw([0, 2, 13])
    J = jcompat.create_student_v3(path, class_weights=cw,
                                  regularize=regularize)
    T = compat.create_student_v3(path, class_weights=cw,
                                 regularize=regularize, device="cpu")
    assert T["training_var_names"] == J["training_var_names"]
    np.testing.assert_array_equal(T["class_indices"], J["class_indices"])
    frames, labels = _frames(4, b=2), _labels(5, b=2)
    jf, jl = jnp.asarray(frames), jnp.asarray(labels)
    j_red = np.asarray(J["logits_reduced"](J["params"], jf))
    t_red = T["logits_reduced"](T["params"], frames).numpy()
    np.testing.assert_allclose(t_red, j_red, rtol=1e-4, atol=1e-4)
    _equal_off_ties(T["predictions"](T["params"], frames),
                    J["predictions"](J["params"], jf), t_red, j_red)
    for key in ("loss", "loss_sel"):
        np.testing.assert_allclose(float(T[key](T["params"], frames, labels)),
                                   float(J[key](J["params"], jf, jl)),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(
        T["update_op"](T["params"], frames, labels).numpy(),
        np.asarray(J["update_op"](J["params"], jf, jl)))

    tp, to = T["params"], T["opt_init"]()
    jp, jo = J["params"], J["opt_init"]()
    for atol in STEP_LOSS_ATOL:
        tp, to, tl = T["train"](tp, to, frames, labels, LR)
        jp, jo, jlv = J["train"](jp, jo, jf, jl, LR)
        assert abs(float(tl) - float(jlv)) < atol, (float(tl), float(jlv))
    _close_steps(tp, jp, 2, LR)
    # drift from the load-time anchor, on the same stepped params
    same = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    np.testing.assert_allclose(float(T["drift_loss"](same)),
                               float(J["drift_loss"](jp)), rtol=1e-5)

    # train_coord on a random mask: unmasked coordinates bitwise frozen
    rng = np.random.RandomState(6)
    sub, _ = split_params(T["params"])
    masks = {k: rng.rand(*v.shape) < 0.2 for k, v in sub.items()}
    out, opt, _ = T["train_coord"](T["params"], T["opt_init"](), frames,
                                   labels, LR, masks)
    jout, _, _ = J["train_coord"](J["params"], J["opt_init"](), jf, jl, LR,
                                  {k: jnp.asarray(m)
                                   for k, m in masks.items()})
    for k, m in masks.items():
        assert torch.equal(out[k][~torch.from_numpy(m)],
                           T["params"][k][~torch.from_numpy(m)]), k
    _close_steps(out, jout, 1, LR)
    assert int(opt.step) == 1


@pytest.mark.parametrize("builder,kw", [
    ("create_student_v2", dict(threshold=0.5, map_misc=2, regularize=True)),
    ("create_student_v2", dict(train_biases_only=True)),
    ("create_student", dict(threshold=0.5, map_misc=1)),
    ("create_student_v2", dict(class_weights=None, threshold=2.0)),
])
def test_legacy_builders_match_jax(jax_init, builder, kw):
    path, _ = jax_init
    kw = dict(dict(class_weights=_cw([0, 2, 13])), **kw)
    J = getattr(jcompat, builder)(path, **kw)
    T = getattr(compat, builder)(path, device="cpu", **kw)
    assert T["training_var_names"] == J["training_var_names"]
    frames, labels = _frames(7, b=2), _labels(8, b=2)
    jf, jl = jnp.asarray(frames), jnp.asarray(labels)
    j_lg = np.asarray(J["logits"](J["params"], jf))
    t_lg = T["logits"](T["params"], frames).numpy()
    if kw["class_weights"] is not None:
        j_lg, t_lg = j_lg[..., [0, 2, 13]], t_lg[..., [0, 2, 13]]
        p = np.exp(j_lg - j_lg.max(-1, keepdims=True))
        gated = (p / p.sum(-1, keepdims=True)).max(-1)   # softmax gate
    else:
        gated = j_lg.max(-1)                             # raw-logit gate
    far = True
    if kw.get("threshold") is not None:   # off the gate's own knife edge
        far = np.abs(gated - kw["threshold"]) > 1e-4
    _equal_off_ties(T["predictions"](T["params"], frames),
                    J["predictions"](J["params"], jf), t_lg, j_lg, far)
    np.testing.assert_allclose(float(T["loss"](T["params"], frames, labels)),
                               float(J["loss"](J["params"], jf, jl)),
                               rtol=1e-5)
    tp, to = T["params"], T["opt_init"]()
    jp, jo = J["params"], J["opt_init"]()
    for atol in STEP_LOSS_ATOL:
        tp, to, tl = T["train"](tp, to, frames, labels, LR)
        jp, jo, jlv = J["train"](jp, jo, jf, jl, LR)
        assert abs(float(tl) - float(jlv)) < atol, (float(tl), float(jlv))
    _close_steps(tp, jp, 2, LR)
    for k in tp:                  # no BN update, frozen names untouched
        if "moving_" in k or k not in T["training_var_names"]:
            assert torch.equal(tp[k], T["params"][k]), k


def test_client_matches_jax():
    """On the TF1 fixture's weights (JAX's init gives inference logits
    tied to 1e-4 everywhere), read from the prefix by both packages; the
    threshold splits the pixels near the median confidence."""
    cw = _cw([0, 2, 13])
    J = jcompat.create_client(FIXTURE, class_weights=cw, threshold=0.38,
                              map_misc=1)
    T = compat.create_client(FIXTURE, class_weights=cw, threshold=0.38,
                             map_misc=1, device="cpu")
    frames = _frames(9, b=2)
    j_red = np.asarray(jm.student_logits(J["params"], jnp.asarray(frames)))[
        ..., [0, 2, 13]]
    t_red = tm.student_logits(T["params"], torch.from_numpy(frames)).numpy()[
        ..., [0, 2, 13]]
    p = np.exp(j_red - j_red.max(-1, keepdims=True))
    far = np.abs((p / p.sum(-1, keepdims=True)).max(-1) - 0.38) > 1e-4
    ours, ref = T["predictions"](frames), J["predictions"](frames)
    _equal_off_ties(ours, ref, t_red, j_red, far)
    assert (ref == 1).any() and (ref != 1).any()
    keep = ours == ref
    np.testing.assert_array_equal(T["output_colored"](frames)[keep],
                                  J["output_colored"](frames)[keep])


def test_teacher_matches_jax_and_strips_its_prefix(tmp_path):
    params = {"teacher/" + k: v.numpy()
              for k, v in init_teacher_params(4, device="cpu").items()}
    path = str(tmp_path / "teacher.npz")
    np.savez(path, **params)
    cw = _cw([0, 13])
    J = jcompat.create_teacher(path, class_weights=cw)
    T = compat.create_teacher(path, class_weights=cw, device="cpu")
    for k in J["params"]:
        assert T["params"][k].numpy().tobytes() == \
            np.asarray(J["params"][k]).tobytes(), k
    frames = _frames(10, h=33, w=65)
    j_lg = np.asarray(J["logits"](frames))
    t_lg = T["logits"](frames).numpy()
    np.testing.assert_allclose(t_lg, j_lg, rtol=1e-4, atol=1e-4)
    _equal_off_ties(T["predictions"](frames), J["predictions"](frames),
                    t_lg, j_lg)
    v2 = compat.create_teacher_v2(path, device="cpu")
    np.testing.assert_array_equal(
        v2["predictions_reduced_fn"](frames, [0, 13]).numpy(),
        T["predictions_reduced"](frames).numpy())
