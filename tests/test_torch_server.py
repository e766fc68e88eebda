"""The server's call sequence on both SemanticNetwork facades, on the CPU.

Both servers are built from the same numpy params (the parity fixture's
trained weights with data-derived moving statistics) and take the same
calls: restore_initial -> train_with_deque (full_model, then
coord_desc_auto, then coord_desc_auto with keep_mask=True), each followed
by encode_delta of the round's train_params/curr_mask; plus the
cross-mIoU, restore and train-mode scoring calls.  The frame memory holds
one frame, so every minibatch draw is entry 0 in both packages (their
random draws differ: torch.Generator vs jax.random).  Both start from the
same seeded warm Adam slots: from cold slots every coordinate's first
step is +-lr, whose sign for a gradient at the f32 noise floor differs
between the packages; and slots built by repeating one frame make
|m|/sqrt(v) the same for nearly every coordinate, a tie cluster that
coord_desc_auto's quantile cannot split reproducibly.

Each round runs one iteration: the facade's job is the call sequence (the
strategies, the masks, the wire order and the payloads), and longer
horizons are tests/test_torch_round.py's and the TF-fixture tests'.  At
one frame of 32x64 the second iteration's loss already differs by up to
2.6e-2 between the packages (measured): every Adam step moves each
coordinate by about lr, so f32 noise on the first gradient becomes +-lr
steps on knife-edge coordinates, and this small input amplifies them.
Tolerances: losses to 1e-5; parameters within 2.05 lr per iteration and
BN statistics within 0.1 of max(|value|, 1), as in
tests/test_torch_round.py; the coord_desc_auto
masks agree on at least 99.5% of coordinates; the delta payloads decode
to the same masks on at least 99.5% of coordinates and to values within
those bounds plus float16 rounding where both masks are set.
Cross-mIoU confusion matrices are counts and must be equal; train-mode
scoring losses agree to rtol 1e-5 and ids off 1e-4 ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.distill.optimizer import AdamState as JaxAdamState
from ams_tpu.runtime.network import SemanticNetwork as JaxNetwork

from ams_tpu_torch.convert import adam_state_from_numpy
from ams_tpu_torch.runtime.network import SemanticNetwork as TorchNetwork
from ams_tpu_torch.stream.codec import decode_delta, encode_delta

EXP = 25
H = 32
ITERS, LR = 1, 1e-3
WARM_STEPS = 10


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case(student_parity_fixture):
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    stats = {}
    jm.student_logits({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(fx["frames"]), train=True, stats_out=stats)
    params.update({k: np.asarray(v, np.float32) for k, v in stats.items()})
    rng = np.random.RandomState(31)
    frame = rng.randint(0, 256, (H, 2 * H, 3)).astype(np.uint8)
    frame[: H // 2] //= 3
    label = rng.randint(0, 19, (H, 2 * H)).astype(np.uint8)
    label[: H // 2, : H] = 0           # a block of class 0
    return params, frame, label


def _servers(params, warm=False):
    kw = dict(class_weights_exp=configs.class_weights(EXP), height=H,
              frozen=False, scale=[1], mini_batch_size=2, lr=LR,
              coord_frac=0.1)
    jnet = JaxNetwork(dict(params), **kw)
    tnet = TorchNetwork(dict(params), device="cpu", fused_loss=True, **kw)
    if warm:
        # the same seeded Adam slots in both, as if from earlier rounds
        rng = np.random.RandomState(8)
        m = {k: (rng.randn(*v.shape) * 1e-2).astype(np.float32)
             for k, v in jnet.opt_state.m.items()}
        v = {k: ((rng.rand(*x.shape) + 0.1) * 1e-4).astype(np.float32)
             for k, x in m.items()}
        jnet.opt_state = JaxAdamState(
            step=jnp.int32(WARM_STEPS),
            m={k: jnp.asarray(x) for k, x in m.items()},
            v={k: jnp.asarray(x) for k, x in v.items()})
        tnet.opt_state = adam_state_from_numpy(WARM_STEPS, m, v, "cpu")
    return jnet, tnet


def _payload(net, strategy):
    from ams_tpu_torch.stream.codec import delta_order
    names = delta_order(strategy, present=net.get_vars())
    stats = net.stats_vars() if strategy != "full_model" else None
    return encode_delta(dict(zip(names, net.train_params)),
                        dict(zip(names, net.curr_mask)), strategy=strategy,
                        stats=stats)


def _check_round(jnet, tnet, j_losses, t_losses, strategy, params):
    assert t_losses.shape == j_losses.shape == (ITERS,)
    np.testing.assert_allclose(t_losses, j_losses, rtol=0, atol=1e-5)
    assert len(tnet.train_params) == len(jnet.train_params)
    from ams_tpu_torch.stream.codec import delta_order
    names = delta_order(strategy, present=params)
    assert len(names) == len(tnet.train_params)
    agree = total = 0
    for k, tp, jp, tm, jm_ in zip(names, tnet.train_params,
                                  jnet.train_params, tnet.curr_mask,
                                  jnet.curr_mask):
        assert tp.shape == jp.shape == params[k].shape
        assert tm.shape == jm_.shape and tm.dtype == np.bool_
        d = np.abs(tp - jp)
        if "moving_" in k:
            assert np.all(d <= 0.1 * np.maximum(np.abs(jp), 1)), k
        else:
            assert d.max() <= 2.05 * LR * ITERS, k
        agree += int((tm == jm_).sum())
        total += tm.size
    assert agree / total >= 0.995, (strategy, agree / total)
    shapes = {k: v.shape for k, v in params.items()}
    (tm, tv), (jm2, jv) = (decode_delta(_payload(n, strategy), shapes,
                                        strategy=strategy)
                           for n in (tnet, jnet))
    both = agree = total = 0
    for k in jm2:
        agree += int((tm[k] == jm2[k]).sum())
        total += jm2[k].size
        sel = tm[k] & jm2[k]
        both += int(sel.sum())
        ref = jv[k][sel]
        tol = 0.1 * np.maximum(np.abs(ref), 1) if "moving_" in k \
            else 2.05 * LR * ITERS
        # float16 on the wire: one rounding of each side's value
        tol = tol + 2 * 2.0 ** -11 * np.abs(ref)
        assert np.all(np.abs(tv[k][sel] - ref) <= tol), k
    assert agree / total >= 0.995 and both > 0


def test_server_call_sequence_matches(case):
    params, frame, label = case
    memory = ([frame], [label])
    jnet, tnet = _servers(params, warm=True)
    assert tnet.fused_loss and not tnet.frozen
    for strategy, keep in (("full_model", False), ("coord_desc_auto", False),
                           ("coord_desc_auto", True)):
        for net in (jnet, tnet):
            net.restore_initial()
        j_losses = jnet.train_with_deque(*memory, ITERS, strategy,
                                         keep_mask=keep)
        t_losses = tnet.train_with_deque(*memory, ITERS, strategy,
                                         keep_mask=keep)
        _check_round(jnet, tnet, j_losses, t_losses, strategy, params)
        if keep:   # the kept selection is the previous round's, exactly
            for m_prev, m in zip(prev_mask, tnet.curr_mask):
                np.testing.assert_array_equal(m, m_prev)
        prev_mask = tnet.curr_mask
    # Adam slots persist across restore_initial
    assert int(tnet.opt_state.step) == int(jnet.opt_state.step) == \
        WARM_STEPS + 3 * ITERS
    # masked-out coordinates sit bitwise at the initial values
    init = tnet.initial_vars()
    from ams_tpu_torch.stream.codec import delta_order
    for k, m in zip(delta_order("coord_desc_auto", present=init),
                    tnet.curr_mask):
        np.testing.assert_array_equal(tnet.get_vars()[k][~m], init[k][~m])
    assert sorted(tnet.stats_vars()) == sorted(jnet.stats_vars())


def test_cross_miou_matches(case):
    params, _, _ = case
    jnet, tnet = _servers(params)
    rng = np.random.RandomState(5)
    seq = rng.randint(0, 19, (5, H, 2 * H)).astype(np.int32)
    seq[1:] = np.where(rng.rand(4, H, 2 * H) < 0.7, seq[:-1], seq[1:])
    seq[2, :4] = 255
    j_cm, j_iou, j_miou = jnet.calc_cross_miou(seq[:2])
    t_cm, t_iou, t_miou = tnet.calc_cross_miou(seq[:2])
    np.testing.assert_array_equal(t_cm, j_cm)
    np.testing.assert_array_equal(t_iou, j_iou)
    assert t_miou == j_miou
    assert tnet.calc_cross_miou_seq(seq) == jnet.calc_cross_miou_seq(seq)
    assert tnet.calc_cross_miou_seq(seq[:1]) == []
    with pytest.raises(ValueError):
        tnet.calc_cross_miou(seq[:3])


def test_server_scoring_restores_and_rejections_match(case, tmp_path):
    params, frame, label = case
    jnet, tnet = _servers(params)
    frames = np.stack([frame, frame[::-1]])
    labels = np.stack([label, label[::-1]])
    j = jnet.predict_with_metric(frames, labels)
    t = tnet.predict_with_metric(frames, labels)
    ref = np.asarray(jm.student_forward(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(frames, jnp.float32), configs.class_indices(EXP),
        train=True)[0])
    srt = np.sort(ref, -1)
    decisive = (srt[..., -1] - srt[..., -2]) > 1e-4
    np.testing.assert_array_equal(t[0][decisive], j[0][decisive])
    np.testing.assert_allclose(t[4], j[4], rtol=1e-5)
    np.testing.assert_array_equal(tnet.predict_input(frames)[decisive],
                                  jnet.predict_input(frames)[decisive])
    with pytest.raises(ValueError):
        tnet.predict_with_metric_seq(frames, labels)

    moved = {k: v + 0.5 for k, v in params.items() if "weights" in k}
    for net in (jnet, tnet):
        net.restore(moved)
    for k, v in jnet.get_vars().items():
        np.testing.assert_array_equal(tnet.get_vars()[k], v)
    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **params)
    tnet.restore(path)
    np.testing.assert_array_equal(
        tnet.get_vars()["MobilenetV2/Conv/weights"],
        params["MobilenetV2/Conv/weights"])
    tnet.set_restore_target(moved)
    tnet.restore_initial()
    np.testing.assert_array_equal(tnet.initial_vars()["aspp0/weights"],
                                  moved["aspp0/weights"])

    with pytest.raises(NotImplementedError):
        TorchNetwork(dict(params), class_weights_exp=configs.class_weights(
            EXP), height=H, frozen=False, scale=[0.5, 1], mini_batch_size=2,
            lr=LR, device="cpu").train_with_deque([frame], [label], 1)
    with pytest.raises(ValueError):
        TorchNetwork(dict(params), class_weights_exp=configs.class_weights(
            EXP), height=H, frozen=False, device="cpu")
    with pytest.raises(TypeError):
        tnet.train_with_deque([frame.astype(np.float32)], [label], 1)
    with pytest.raises(ValueError):
        tnet.train_with_deque([], [], 1)
