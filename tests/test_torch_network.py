"""The edge client's call sequence on both SemanticNetwork facades.

Both clients are built from the same numpy params (the parity fixture with
data-derived moving statistics) and take the same calls: predict_input,
apply_downlink of one ams_tpu-encoded payload per wire, per-frame scoring,
then save_to_frozen_graph, reload and predict again.

Tolerances: parameters after apply_downlink must be equal bit for bit (the
codec is host numpy in both).  Ids must be equal wherever the top-2 margin
of the JAX logits exceeds 1e-4 (f32 summation-order noise between the
packages is below that), and each confusion matrix may differ only by the
pixels below that margin: each such pixel moves at most one count out of
one cell into another.  Per-frame CE losses agree to rtol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.runtime.network import SemanticNetwork as JaxNetwork
from ams_tpu.stream import codec as jcodec

from ams_tpu_torch.runtime.network import SemanticNetwork as TorchNetwork

EXP = 25
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
    rng = np.random.RandomState(21)
    labels = rng.randint(0, 19, frames.shape[:3]).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    train = jm.trainable_names(params)
    masks = {k: rng.rand(*params[k].shape) < 0.1 for k in train}
    moved = dict(params)
    for k in train:
        step = rng.randn(*params[k].shape).astype(np.float32) * 0.02
        moved[k] = np.where(masks[k], params[k] + step, params[k])
    return params, moved, masks, frames, labels


def _clients(params):
    kw = dict(class_weights_exp=configs.class_weights(EXP), height=64,
              frozen=True)
    return JaxNetwork(dict(params), **kw), \
        TorchNetwork(dict(params), device="cpu", **kw)


def _near_ties(jnet, frames):
    """(B, H, W) bool: pixels whose top-2 reduced logit margin in the JAX
    client is at most TIE_MARGIN."""
    ci = tuple(int(c) for c in configs.class_indices(EXP))
    params = {k: jnp.asarray(v) for k, v in jnet.params.items()}
    if jnet._folded:
        from ams_tpu.models.frozen import student_forward_folded
        red = student_forward_folded(params, jnp.asarray(frames),
                                     class_indices=ci,
                                     compute_dtype=jnp.float32)
    else:
        red, _ = jm.student_forward(params, jnp.asarray(frames), ci)
    srt = np.sort(np.asarray(red), -1)
    near = (srt[..., -1] - srt[..., -2]) <= TIE_MARGIN
    assert near.mean() < 0.01
    return near


def _assert_ids_equal(jnet, tnet, frames):
    near = _near_ties(jnet, frames)
    j_ids, t_ids = jnet.predict_input(frames), tnet.predict_input(frames)
    np.testing.assert_array_equal(t_ids[~near], j_ids[~near])
    return near


def _assert_cm_close(t_cm, j_cm, n_near):
    assert np.abs(t_cm - j_cm).sum() <= 2 * n_near


def _assert_scoring_equal(jnet, tnet, frames, labels):
    near = _assert_ids_equal(jnet, tnet, frames)
    j_ids, j_cms, j_mious, j_losses = jnet.predict_with_metric_seq(frames,
                                                                   labels)
    t_ids, t_cms, t_mious, t_losses = tnet.predict_with_metric_seq(frames,
                                                                   labels)
    np.testing.assert_array_equal(t_ids[~near], j_ids[~near])
    for b in range(len(frames)):
        _assert_cm_close(t_cms[b], j_cms[b], int(near[b].sum()))
    if not near.any():
        np.testing.assert_array_equal(t_mious, j_mious)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    j_one = jnet.predict_with_metric(frames[:1], labels[:1])
    t_one = tnet.predict_with_metric(frames[:1], labels[:1])
    np.testing.assert_array_equal(t_one[0][~near[:1]], j_one[0][~near[:1]])
    _assert_cm_close(t_one[1], j_one[1], int(near[0].sum()))
    np.testing.assert_allclose(t_one[4], j_one[4], rtol=1e-5)


@pytest.mark.parametrize("wire,base_initial", [("float16", False),
                                               ("int8", False),
                                               ("int8d", True)])
def test_client_call_sequence_matches(case, tmp_path, wire, base_initial):
    params, moved, masks, frames, labels = case
    jnet, tnet = _clients(params)

    _assert_ids_equal(jnet, tnet, frames)

    stats = {k: v * 1.01 for k, v in params.items() if "moving_" in k}
    blob = jcodec.encode_delta(
        moved, masks, strategy="coord_desc_auto", use_native=False,
        wire_dtype=wire, stats=stats,
        base=params if wire == "int8d" else None)
    for net in (jnet, tnet):
        net.apply_downlink(blob, strategy="coord_desc_auto", wire_dtype=wire,
                           base_initial=base_initial)
    j_vars, t_vars = jnet.get_vars(), tnet.get_vars()
    assert sorted(t_vars) == sorted(j_vars)
    for k in j_vars:
        assert t_vars[k].dtype == j_vars[k].dtype
        np.testing.assert_array_equal(t_vars[k], j_vars[k])
    assert any(not np.array_equal(t_vars[k], params[k]) for k in masks)

    _assert_scoring_equal(jnet, tnet, frames, labels)

    j_path, t_path = str(tmp_path / "jax_client"), str(tmp_path / "torch_client")
    jnet.save_to_frozen_graph(j_path)
    tnet.save_to_frozen_graph(t_path)
    with np.load(j_path + ".npz") as jz, np.load(t_path + ".npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            np.testing.assert_array_equal(tz[k], jz[k])
    kw = dict(class_weights_exp=configs.class_weights(EXP), height=64,
              frozen=True)
    j_folded = JaxNetwork(j_path + ".npz", **kw)
    t_folded = TorchNetwork(t_path + ".npz", device="cpu", **kw)
    assert t_folded._folded
    _assert_scoring_equal(j_folded, t_folded, frames, labels)


def test_unfolded_save_and_visualisation_match(case, tmp_path):
    params, _, _, frames, labels = case
    jnet, tnet = _clients(params)
    path = str(tmp_path / "raw")
    tnet.save_to_frozen_graph(path, fold=False)
    with np.load(path + ".npz") as z:
        assert sorted(z.files) == sorted(params)
    frame = np.clip(frames[0], 0, 255).astype(np.uint8)
    teacher = np.where(labels[0] == 255, 0, labels[0])
    for a, b in ((tnet.colorize(frame=frame), jnet.colorize(frame=frame)),
                 (tnet.colorize_teacher(teacher, frame),
                  jnet.colorize_teacher(teacher, frame)),
                 (tnet.cross_ignore(teacher, frame_student=frame),
                  jnet.cross_ignore(teacher, frame_student=frame))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_client_rejects_what_is_not_ported(case, tmp_path):
    params = case[0]
    kw = dict(class_weights_exp=configs.class_weights(EXP), height=64,
              device="cpu")
    with pytest.raises(NotImplementedError):
        TorchNetwork(dict(params), frozen=False, scale=[1],
                     mini_batch_size=4, lr=1e-3, **kw)
    with pytest.raises(NotImplementedError):
        TorchNetwork(dict(params), frozen=True, compute_dtype="bfloat16",
                     **kw)
    net = TorchNetwork(dict(params), frozen=True, **kw)
    with pytest.raises(NotImplementedError):
        net.train_with_deque([], [], 1)
    with pytest.raises(FileNotFoundError):
        TorchNetwork(os.path.join(str(tmp_path), "missing"), frozen=True,
                     **kw)
