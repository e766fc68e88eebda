"""``conv_precision="default"`` in the port, on the CPU.

On the card "default" runs a round's f32 convolutions and products in
TF32 (``utils.platform.conv_precision``); the CPU has no TF32, so here it
must give the bits of "highest".  Checked:
- ``DistillSpec``, ``RunConfig.validate``, the facade's round and
  ``cli.run``'s parser accept "default", and the round's outputs equal the
  "highest" round's to the bit (``MultiVideoServer`` takes no precision,
  as JAX's takes none);
- the port's "default" round against ams_tpu's "default" round
  (``lax.Precision.DEFAULT``) on the same params, frames, ``idx_seq`` and
  warm Adam slots, at tests/test_torch_round.py's gates (coord_desc_auto,
  2 iterations of batch 3 at 32x64);
- the TF32 flags are on inside the round and restored after a round that
  raises, and concurrent spans on more threads than cores leave them on
  for each span's whole length and restored at the end.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu import configs as jconfigs
from ams_tpu.cli import run as jax_run
from ams_tpu.distill import train_step as jts
from ams_tpu.distill.optimizer import adam_init as jadam_init
from ams_tpu.models import mobilenetv2_deeplab as jm

from ams_tpu_torch import configs
from ams_tpu_torch.cli import run as torch_run
from ams_tpu_torch.convert import (
    adam_state_from_numpy,
    masks_from_numpy,
    masks_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.distill import train_step as tts
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.runtime.config import RunConfig
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.utils import platform

ITERS, BATCH, LR = 2, 3, 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_off():
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture(scope="module")
def setup(student_parity_fixture):
    """test_torch_round.py's inputs: the parity fixture's weights with
    data-derived moving statistics, seeded buffers with some 255 labels,
    and Adam slots warmed by one JAX round under an all-False mask."""
    fx = student_parity_fixture
    params = {k: v for k, v in fx["params"].items() if "_patch" not in k}
    stats = {}
    jm.student_logits({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(fx["frames"]), train=True, stats_out=stats)
    params.update({k: np.asarray(v, np.float32) for k, v in stats.items()})
    rng = np.random.RandomState(17)
    frames = rng.randint(0, 256, (8, 32, 64, 3)).astype(np.uint8)
    frames[:, :16] //= 2
    labels = rng.randint(0, 19, (8, 32, 64)).astype(np.uint8)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    idx_warm = rng.randint(0, 8, (ITERS, BATCH)).astype(np.int32)
    idx = rng.randint(0, 8, (ITERS, BATCH)).astype(np.int32)
    train = jm.trainable_names(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jround = jts.make_distill_round(jts.DistillSpec(**_spec("full_model")))
    zero = {k: jnp.zeros(params[k].shape, bool) for k in train}
    _, warm, _, _ = jround(jparams, jadam_init(jts.split_params(jparams)[0]),
                           jnp.asarray(frames), jnp.asarray(labels),
                           jnp.int32(8), jnp.zeros((2,), jnp.uint32),
                           jnp.float32(LR), zero, reselect=False,
                           idx_seq=jnp.asarray(idx_warm))
    warm = (np.asarray(warm.step),
            {k: np.asarray(v) for k, v in warm.m.items()},
            {k: np.asarray(v) for k, v in warm.v.items()})
    all_true = {k: np.ones(params[k].shape, bool) for k in train}
    return dict(params=params, frames=frames, labels=labels, idx=idx,
                warm=warm, all_true=all_true)


def _spec(strategy, **kw):
    return dict(iters=ITERS, batch_size=BATCH, num_classes=19,
                class_indices=tuple(int(c) for c in jconfigs.class_indices(0)),
                strategy=strategy, coord_frac=0.1, **kw)


def _run_torch(setup, precision):
    tround = tts.make_distill_round(tts.DistillSpec(
        **_spec("coord_desc_auto", conv_precision=precision)))
    out, opt, mask, losses = tround(
        params_from_numpy(setup["params"], "cpu"),
        adam_state_from_numpy(*setup["warm"], device="cpu"),
        torch.from_numpy(setup["frames"]), torch.from_numpy(setup["labels"]),
        8, None, LR, masks_from_numpy(setup["all_true"], "cpu"),
        reselect=True, idx_seq=setup["idx"])
    return (params_to_numpy(out), int(opt.step), masks_to_numpy(mask),
            losses.numpy())


def test_default_round_is_highest_on_the_cpu(setup, tf32_off):
    default = _run_torch(setup, "default")
    highest = _run_torch(setup, "highest")
    assert _flags() == (False, False)
    np.testing.assert_array_equal(default[3], highest[3])
    for k in highest[0]:
        np.testing.assert_array_equal(default[0][k], highest[0][k],
                                      err_msg=k)
        if k in highest[2]:
            np.testing.assert_array_equal(default[2][k], highest[2][k])


def test_default_round_matches_jax_default_round(setup):
    jround = jts.make_distill_round(jts.DistillSpec(
        **_spec("coord_desc_auto", conv_precision="default")))
    step, m, v = setup["warm"]
    state = jts.AdamState(step=jnp.asarray(step),
                          m={k: jnp.asarray(x) for k, x in m.items()},
                          v={k: jnp.asarray(x) for k, x in v.items()})
    j_out, j_opt, j_mask, j_losses = jround(
        {k: jnp.asarray(x) for k, x in setup["params"].items()}, state,
        jnp.asarray(setup["frames"]), jnp.asarray(setup["labels"]),
        jnp.int32(8), jnp.zeros((2,), jnp.uint32), jnp.float32(LR),
        {k: jnp.asarray(x) for k, x in setup["all_true"].items()},
        reselect=True, idx_seq=jnp.asarray(setup["idx"]))
    t_out, t_step, t_mask, t_losses = _run_torch(setup, "default")
    j_losses = np.asarray(j_losses)
    # test_torch_round.py's gates for a train-mode BN round
    for i, atol in enumerate((1e-5, 5e-4)):
        assert abs(t_losses[i] - j_losses[i]) < atol, (i, t_losses,
                                                       j_losses)
    assert t_step == int(j_opt.step) == int(step) + ITERS
    tot = bad = 0
    for k, rv in j_out.items():
        rv = np.asarray(rv)
        d = np.abs(t_out[k] - rv)
        if "moving_" in k:
            assert np.all(d <= 0.1 * np.maximum(np.abs(rv), 1)), (k, d.max())
            continue
        tot += d.size
        bad += int((d > 1e-4).sum())
        assert d.max() <= 2.05 * LR * ITERS, (k, d.max())
    assert bad / tot <= 0.15, bad / tot
    for k, msk in t_mask.items():
        np.testing.assert_array_equal(t_out[k][~msk],
                                      setup["params"][k][~msk], err_msg=k)
    total = sum(np.asarray(x).size for x in j_mask.values())
    agree = sum(int((t_mask[k] == np.asarray(j_mask[k])).sum())
                for k in j_mask)
    assert agree / total >= 0.995, agree / total


def test_tf32_is_on_inside_and_restored_after_a_round_that_raises(
        setup, tf32_off, monkeypatch):
    seen = []

    def failing_loss(*args, **kwargs):
        seen.append(_flags())
        raise RuntimeError("loss failed")

    monkeypatch.setattr(tts, "distill_loss", failing_loss)
    tround = tts.make_distill_round(tts.DistillSpec(
        **_spec("full_model", conv_precision="default")))
    with pytest.raises(RuntimeError, match="loss failed"):
        tround(params_from_numpy(setup["params"], "cpu"),
               adam_state_from_numpy(*setup["warm"], device="cpu"),
               torch.from_numpy(setup["frames"]),
               torch.from_numpy(setup["labels"]), 8, None, LR,
               masks_from_numpy(setup["all_true"], "cpu"),
               idx_seq=setup["idx"])
    assert seen == [(True, True)]
    assert _flags() == (False, False)
    # an idx_seq that is too short raises inside the span too
    monkeypatch.undo()
    with pytest.raises(ValueError):
        tround(params_from_numpy(setup["params"], "cpu"), None,
               torch.from_numpy(setup["frames"]),
               torch.from_numpy(setup["labels"]), 8, None, LR,
               masks_from_numpy(setup["all_true"], "cpu"),
               idx_seq=setup["idx"][:1])
    assert _flags() == (False, False)


def test_concurrent_spans_keep_tf32_on_and_restore_it(tf32_off):
    errors = []

    def worker():
        try:
            for _ in range(200):
                with platform.conv_precision("default"):
                    if _flags() != (True, True):
                        errors.append(_flags())
                with platform.conv_precision("highest"):
                    pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert _flags() == (False, False)
    with pytest.raises(ValueError):
        with platform.conv_precision("single"):
            pass


def _facade_round(precision, frames, labels):
    net = SemanticNetwork(
        params_to_numpy(init_student_params(1, device="cpu")),
        class_weights_exp=configs.class_weights(0), height=32, frozen=False,
        scale=[1], mini_batch_size=2, lr=1e-3, conv_precision=precision,
        seed=3, device="cpu")
    losses = net.train_with_deque(frames, labels, 2, "coord_desc_auto")
    return losses, net.get_vars()


def test_facade_accepts_default(tf32_off):
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 256, (32, 64, 3)).astype(np.uint8)
              for _ in range(4)]
    labels = [rng.randint(0, 19, (32, 64)).astype(np.uint8)
              for _ in range(4)]
    (l_def, v_def), (l_hi, v_hi) = (_facade_round(p, frames, labels)
                                    for p in ("default", "highest"))
    np.testing.assert_array_equal(l_def, l_hi)
    for k in v_hi:
        np.testing.assert_array_equal(v_def[k], v_hi[k], err_msg=k)
    assert _flags() == (False, False)


def test_spec_config_and_cli_accept_default():
    for kw in ({"conv_precision": "default"},
               {"conv_precision": "default", "compute_dtype": "bfloat16"}):
        tts.DistillSpec(**kw).check_supported()
        assert RunConfig(**kw).validate().conv_precision == "default"
    argv = ["--mode", "early", "--input_video", "v/90-a", "--gt_video", "g/",
            "--student_checkpoint", "c/m.npz", "--output_dir", "o/",
            "--conv_precision", "default"]
    ours = torch_run.config_from_args(torch_run.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    ref = jax_run.config_from_args(jax_run.build_parser().parse_args(argv))
    assert ours.validate().conv_precision == ref.validate().conv_precision \
        == "default"
