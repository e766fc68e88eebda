"""The port's distillation loss, Adam and selective loss against ams_tpu's.

The loss runs on the TF-executed parity fixture's params and frames
(read-only) in training mode, with the fixture's labels and a sprinkle of
255 ("ignore") ids, for each branch of ``distill_loss``: the gather
resize, the matmul resize, the fused path (the plain version on the CPU),
``class_mask`` and the soft-teacher ``teacher_logits``.  The value and the
gradient of every trainable tensor are compared with
``jax.value_and_grad`` of ams_tpu's ``distill_loss``.

Tolerances: the loss to rtol 1e-5.  Gradients: the error's norm over all
trainables within 2e-2 of the JAX gradient's norm, and per tensor within
5e-2 of max(its norm, 1e-3 of the gradient's RMS scale).  The gradients
are ill-conditioned at this size: the fixture's batch of 2 gives the
image-pooling BN two values per channel, and a 1e-7 relative perturbation
of the params moves JAX's own gradients by up to 0.6% per tensor
(measured).  The project-BN betas, which feed another train-mode BN, have
a gradient of 0 in exact arithmetic, hence the floor.  Measured worst:
7.5e-3 overall, 1.7e-2 per tensor.  The port's own fused and gather paths
give the same bits on the CPU.  Adam: f32 elementwise arithmetic in the
same order, rtol 1e-6 / atol 1e-9 on params and slots (``lr_t``'s f32
power may round differently by an ulp).  The selective loss to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.distill import loss as jloss
from ams_tpu.distill import optimizer as jopt
from ams_tpu.models import mobilenetv2_deeplab as jm

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.distill import loss as tloss
from ams_tpu_torch.distill import optimizer as topt
from ams_tpu_torch.distill import train_step as tts

EXP = 25
GRAD_REL_ALL = 2e-2
GRAD_REL_TENSOR = 5e-2


def grad_errors(got, want):
    """(relative error of the whole gradient, worst per-tensor error
    relative to max(the tensor's norm, 1e-3 of the RMS scale))."""
    keys = sorted(want)
    d_all = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2.0) for k in keys))
    n_all = np.sqrt(sum(np.sum(want[k] ** 2.0) for k in keys))
    rms = n_all / np.sqrt(sum(want[k].size for k in keys))
    per = max(np.linalg.norm(got[k] - want[k])
              / max(np.linalg.norm(want[k]), 1e-3 * rms * np.sqrt(want[k].size))
              for k in keys)
    return d_all / n_all, per


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case(student_parity_fixture):
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    frames = fx["frames"]
    rng = np.random.RandomState(7)
    labels = fx["labels"].astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    teacher = rng.randn(*labels.shape, 19).astype(np.float32) * 3
    return params, frames, labels, teacher


VARIANTS = {
    "gather": {},
    "matmul": {"resize_via": "matmul"},
    "fused": {"fused": True},
    "class_mask": {"class_mask": np.array([1, 0, 1, 1, 0, 1], np.float32)},
    "teacher_logits": {"teacher": True},
}


def _jax_value_and_grad(params, frames, labels, teacher, kw):
    ci = jnp.asarray(configs.class_indices(EXP))
    train, state = {}, {}
    for k, v in params.items():
        (train if "moving_" not in k else state)[k] = jnp.asarray(v)
    jkw = dict(kw)
    if "class_mask" in jkw:
        jkw["class_mask"] = jnp.asarray(jkw["class_mask"])
    if jkw.pop("teacher", False):
        jkw["teacher_logits"] = jnp.asarray(teacher)

    def f(pt):
        merged = dict(pt)
        merged.update(state)
        loss, _ = jloss.distill_loss(merged, jnp.asarray(frames),
                                     jnp.asarray(labels), ci, 19,
                                     train=True, **jkw)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(f))(train)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _torch_value_and_grad(params, frames, labels, teacher, kw):
    tp = params_from_numpy(params, "cpu")
    train, state = tts.split_params(tp)
    leaves = {k: v.requires_grad_(True) for k, v in train.items()}
    merged = dict(leaves)
    merged.update(state)
    tkw = dict(kw)
    if "class_mask" in tkw:
        tkw["class_mask"] = torch.from_numpy(tkw["class_mask"])
    if tkw.pop("teacher", False):
        tkw["teacher_logits"] = torch.from_numpy(teacher)
    stats = {}
    loss, aux = tloss.distill_loss(
        merged, torch.from_numpy(frames), torch.from_numpy(labels),
        configs.class_indices(EXP), 19, train=True, stats_out=stats, **tkw)
    keys = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return float(loss.detach()), dict(zip(keys, (g.numpy() for g in grads))), \
        aux, stats


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_distill_loss_value_and_gradients_match(case, name):
    params, frames, labels, teacher = case
    kw = VARIANTS[name]
    j_loss, j_grads = _jax_value_and_grad(params, frames, labels, teacher, kw)
    t_loss, t_grads, aux, stats = _torch_value_and_grad(
        params, frames, labels, teacher, kw)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    assert sorted(t_grads) == sorted(j_grads)
    rel_all, rel_tensor = grad_errors(t_grads, j_grads)
    assert rel_all < GRAD_REL_ALL, (name, rel_all)
    assert rel_tensor < GRAD_REL_TENSOR, (name, rel_tensor)
    if name == "fused":
        _, g_gather, _, _ = _torch_value_and_grad(params, frames, labels,
                                                  teacher, {})
        for k, g in g_gather.items():
            np.testing.assert_array_equal(t_grads[k], g)
    assert len(stats) == len([k for k in params if "moving_" in k])
    if kw.get("fused"):
        assert sorted(aux) == ["grid_logits_reduced", "reduced_labels",
                               "weights"]
        assert aux["grid_logits_reduced"].shape == (2, 5, 9, 6)
    else:
        assert sorted(aux) == ["logits_reduced", "predictions",
                               "reduced_labels", "weights"]


def test_fused_path_rejects_class_mask(case):
    params, frames, labels, _ = case
    with pytest.raises(ValueError):
        tloss.distill_loss(params_from_numpy(params, "cpu"),
                           torch.from_numpy(frames),
                           torch.from_numpy(labels),
                           configs.class_indices(EXP), 19, fused=True,
                           class_mask=torch.ones(6))


def test_softmax_xent_and_masked_mean_match():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 7, 6).astype(np.float32) * 3
    soft = rng.dirichlet(np.ones(6), (4, 7)).astype(np.float32)
    mask = rng.rand(4, 7) < 0.5
    want = jloss.softmax_xent_with_soft_labels(jnp.asarray(logits),
                                               jnp.asarray(soft))
    got = tloss.softmax_xent_with_soft_labels(torch.from_numpy(logits),
                                              torch.from_numpy(soft))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(tloss.masked_mean(got, torch.from_numpy(mask))),
        float(jloss.masked_mean(want, jnp.asarray(mask))), rtol=1e-6)
    assert float(tloss.masked_mean(got, torch.zeros(4, 7))) == 0.0
    assert tts.softmax_xent_with_soft_labels is \
        tloss.softmax_xent_with_soft_labels


def test_selective_loss_matches_and_keeps_nan_convention():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 8, 16, 6).astype(np.float32)
    labels = rng.randint(0, 6, (2, 8, 16)).astype(np.int32)
    weights = (rng.rand(2, 8, 16) < 0.9).astype(np.float32)

    def both(lg, lb):
        want = float(jloss.selective_loss(jnp.asarray(lg), jnp.asarray(lb),
                                          jnp.asarray(weights), 6))
        got = float(tloss.selective_loss(torch.from_numpy(lg),
                                         torch.from_numpy(lb),
                                         torch.from_numpy(weights), 6))
        return got, want

    got, want = both(logits, labels)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # class 5 neither labelled nor predicted anywhere -> NaN
    logits[..., 5] = -100.0
    got, want = both(logits, labels % 5)
    assert np.isnan(want) and np.isnan(got)


@pytest.mark.parametrize("step", [0, 7])
def test_adam_apply_matches(step):
    rng = np.random.RandomState(5 + step)
    shapes = {"a": (3, 3, 4, 8), "b": (8,), "c": (1, 1, 16, 19)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) * 1e-3
             for k, s in shapes.items()}
    m = {k: rng.randn(*s).astype(np.float32) * 1e-3 * (step > 0)
         for k, s in shapes.items()}
    v = {k: rng.rand(*s).astype(np.float32) * 1e-6 * (step > 0)
         for k, s in shapes.items()}
    j_state = jopt.AdamState(step=jnp.int32(step),
                             m={k: jnp.asarray(x) for k, x in m.items()},
                             v={k: jnp.asarray(x) for k, x in v.items()})
    j_params, j_new = jopt.adam_apply(
        {k: jnp.asarray(x) for k, x in params.items()},
        {k: jnp.asarray(x) for k, x in grads.items()}, j_state,
        jnp.float32(1e-3))
    from ams_tpu_torch.convert import adam_state_from_numpy, \
        adam_state_to_numpy
    t_state = adam_state_from_numpy(step, m, v, "cpu")
    t_params, t_new = topt.adam_apply(
        params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu"),
        t_state, 1e-3)
    t_step, t_m, t_v = adam_state_to_numpy(t_new)
    assert t_step == int(j_new.step) == step + 1
    for k in shapes:
        np.testing.assert_allclose(t_params[k].numpy(),
                                   np.asarray(j_params[k]), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(t_m[k], np.asarray(j_new.m[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(t_v[k], np.asarray(j_new.v[k]),
                                   rtol=1e-6, atol=1e-15)
    # the step moves params by about lr where |g| >> eps (TF1 formula)
    d = np.abs(t_params["a"].numpy() - params["a"])
    assert d.max() < 2e-2 and d.max() > 1e-4
    assert topt.adam_init(params_from_numpy(params, "cpu")).step.item() == 0
