"""The port's bf16 distillation round against ams_tpu's, on the CPU.

The mixed-precision round: bf16 convolutions, f32 parameters, Adam slots,
BN moments and statistics and loss; the peeled coord_desc_auto selection
iteration in f32.  Both packages get JAX's seeded student (through the
converter), the same uint8 frames and labels (seeded, 32x64), the same
``idx_seq`` (batch 2, 3 iterations) and the same Adam slots: a warm-up
round of ams_tpu under an all-False mask advances the slots with the
params frozen, so the selection does not sit on the first step's tie
cluster (as tests/test_torch_round.py does).

Gates against ams_tpu's bf16 round (bf16 rounds after every operation and
XLA fuses and sums in its own order, so per-coordinate gates would be
noise):
- the selection mask agrees on at least 99.5% of coordinates (the bar of
  tests/test_torch_round.py; measured 0.99995);
- losses within rtol 0.05 (measured 3.7e-4);
- parameter deltas with cosine above 0.9 (measured 0.973).
Gates of the port's bf16 round against its f32 round (those of
tests/test_mixed_precision.py): losses within rtol 0.05 (measured
3.8e-4), the same mask (iteration 0 runs the same f32 step in both),
cosine above 0.9 (measured 0.967).
Also ``resize_via``/``select_cdtype`` and the run config's compute type
against ams_tpu's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.cli import run as jax_run
from ams_tpu.distill import train_step as jts
from ams_tpu.distill.optimizer import adam_init as jadam_init
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.runtime.config import RunConfig as JaxRunConfig

from ams_tpu_torch.cli import run as torch_run
from ams_tpu_torch.convert import (
    adam_state_from_numpy,
    masks_from_numpy,
    masks_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.distill import train_step as tts
from ams_tpu_torch.runtime.config import RunConfig

ITERS, BATCH, LR = 3, 2, 1e-3
CI = (0, 1, 2, 10, 11, 13)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _spec(strategy, compute_dtype):
    return dict(iters=ITERS, batch_size=BATCH, num_classes=19,
                class_indices=CI, strategy=strategy, coord_frac=0.1,
                compute_dtype=compute_dtype)


@pytest.fixture(scope="module")
def setup():
    params = {k: np.asarray(v) for k, v in
              jm.init_student_params(jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (4, 32, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 19, (4, 32, 64)).astype(np.uint8)
    idx_warm = rng.randint(0, 4, (ITERS, BATCH)).astype(np.int32)
    idx = rng.randint(0, 4, (ITERS, BATCH)).astype(np.int32)
    train = jm.trainable_names(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    warm_round = jts.make_distill_round(
        jts.DistillSpec(**_spec("full_model", "float32")))
    zero = {k: jnp.zeros(params[k].shape, bool) for k in train}
    _, warm, _, _ = warm_round(
        jparams, jadam_init(jts.split_params(jparams)[0]),
        jnp.asarray(frames), jnp.asarray(labels), jnp.int32(4),
        jax.random.PRNGKey(7), jnp.float32(LR), zero, reselect=False,
        idx_seq=jnp.asarray(idx_warm))
    warm_np = (np.asarray(warm.step),
               {k: np.asarray(v) for k, v in warm.m.items()},
               {k: np.asarray(v) for k, v in warm.v.items()})
    all_true = {k: np.ones(params[k].shape, bool) for k in train}
    setup = dict(params=params, frames=frames, labels=labels, idx=idx,
                 warm=warm_np, all_true=all_true)

    jround = jts.make_distill_round(
        jts.DistillSpec(**_spec("coord_desc_auto", "bfloat16")))
    step, m, v = warm_np
    state = jts.AdamState(step=jnp.asarray(step),
                          m={k: jnp.asarray(x) for k, x in m.items()},
                          v={k: jnp.asarray(x) for k, x in v.items()})
    out, _, mask, losses = jround(
        jparams, state, jnp.asarray(frames), jnp.asarray(labels),
        jnp.int32(4), jax.random.PRNGKey(7), jnp.float32(LR),
        {k: jnp.asarray(x) for k, x in all_true.items()}, reselect=True,
        idx_seq=jnp.asarray(idx))
    setup["jax_bf16"] = _summary(
        params, {k: np.asarray(x) for k, x in out.items()},
        {k: np.asarray(x) for k, x in mask.items()}, np.asarray(losses))
    setup["port_bf16"] = _run_torch(setup, "bfloat16")
    setup["port_f32"] = _run_torch(setup, "float32")
    return setup


def _summary(params, out, mask, losses):
    train = sorted(mask)
    delta = np.concatenate([(out[k] - params[k]).ravel() for k in train])
    return dict(out=out, mask=mask, losses=losses, delta=delta)


def _run_torch(setup, compute_dtype):
    tround = tts.make_distill_round(
        tts.DistillSpec(**_spec("coord_desc_auto", compute_dtype)))
    out, opt, mask, losses = tround(
        params_from_numpy(setup["params"], "cpu"),
        adam_state_from_numpy(*setup["warm"], device="cpu"),
        torch.from_numpy(setup["frames"]), torch.from_numpy(setup["labels"]),
        4, None, LR, masks_from_numpy(setup["all_true"], "cpu"),
        reselect=True, idx_seq=setup["idx"])
    assert int(opt.step) == int(setup["warm"][0]) + ITERS
    out = params_to_numpy(out)
    assert all(v.dtype == np.float32 for v in out.values())
    return _summary(setup["params"], out, masks_to_numpy(mask),
                    losses.numpy())


def _cosine(a, b):
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    assert denom > 0
    return float(np.dot(a, b) / denom)


def test_bf16_round_matches_jax(setup):
    ours, ref = setup["port_bf16"], setup["jax_bf16"]
    assert ours["losses"].shape == ref["losses"].shape == (ITERS,)
    assert np.isfinite(ours["losses"]).all()
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=0.05)
    total = sum(m.size for m in ref["mask"].values())
    agree = sum(int((ours["mask"][k] == ref["mask"][k]).sum())
                for k in ref["mask"])
    assert agree / total >= 0.995, agree / total
    sel = sum(int(m.sum()) for m in ours["mask"].values())
    assert abs(sel / total - 0.1) < 0.01, sel / total
    assert _cosine(ours["delta"], ref["delta"]) > 0.9
    # masked-out coordinates stay bitwise at their round-start values
    for k, m in ours["mask"].items():
        np.testing.assert_array_equal(ours["out"][k][~m],
                                      setup["params"][k][~m], err_msg=k)


def test_bf16_round_tracks_f32(setup):
    b16, f32 = setup["port_bf16"], setup["port_f32"]
    assert np.isfinite(f32["losses"]).all()
    np.testing.assert_allclose(b16["losses"], f32["losses"], rtol=0.05)
    for k in f32["mask"]:
        np.testing.assert_array_equal(b16["mask"][k], f32["mask"][k],
                                      err_msg=k)
    assert _cosine(b16["delta"], f32["delta"]) > 0.9
    # the two rounds really differ: bf16 is not f32 under another name
    assert not np.array_equal(b16["delta"], f32["delta"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss_resize", ["auto", "gather", "matmul"])
def test_spec_dtype_rules_match_jax(compute_dtype, loss_resize):
    for select in ("float32", "compute"):
        kw = dict(compute_dtype=compute_dtype, loss_resize=loss_resize,
                  select_dtype=select)
        ours, ref = tts.DistillSpec(**kw), jts.DistillSpec(**kw)
        assert ours.resize_via(ours.cdtype) == ref.resize_via(ref.cdtype)
        assert ours.resize_via(ours.select_cdtype) == \
            ref.resize_via(ref.select_cdtype)
        assert str(ours.select_cdtype).replace("torch.", "") == \
            str(ref.select_cdtype)
        assert str(ours.cdtype).replace("torch.", "") == str(ref.cdtype)


def test_bf16_run_config_matches_jax():
    argv = ["--mode", "early", "--input_video", "90-bands", "--gt_video",
            "gt/", "--student_checkpoint", "student.npz", "--output_dir",
            "out/", "--compute_dtype", "bfloat16"]
    ours = torch_run.config_from_args(
        torch_run.build_parser().parse_args(argv + ["--device", "cpu"]))
    ref = jax_run.config_from_args(jax_run.build_parser().parse_args(argv))
    assert ours.compute_dtype == ref.compute_dtype == "bfloat16"
    assert ours.validate() is ours and ref.validate() is ref
    assert RunConfig(compute_dtype="bfloat16").validate().compute_dtype == \
        JaxRunConfig(compute_dtype="bfloat16").validate().compute_dtype
    kw = dict(compute_dtype="bfloat16", conv_precision="default")
    assert RunConfig(**kw).validate().conv_precision == \
        JaxRunConfig(**kw).validate().conv_precision == "default"
