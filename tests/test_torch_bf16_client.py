"""The port's bf16 folded client against ams_tpu's, on the CPU.

Both packages fold the same JAX-initialised student (logits scaled x300,
as tests/test_fused_mbconv.py:118-120 does, so that the argmax means
something) and run a 1x65x129 frame.

- Unfused bf16 forward: both round to bf16 after every operation, so the
  bar is max |error| <= 2^-7 of the logits' scale with argmax agreement
  above 0.999; measured: equal bit for bit.
- ``fused_blocks=True`` against JAX's ``fused_blocks=True`` (Pallas in
  interpret mode): the bars of tests/test_fused_mbconv.py:132-135, max
  error below 0.05 of the scale and argmax agreement above 0.99;
  measured 0.0063 and 1.0.  The two differ by routing as well as
  summation order: JAX runs a stage unfused when its VMEM estimate fails,
  the port fuses every stride-1 stage (ROADMAP §C).
- ``fused_blocks="banded"`` with ``banded_min_hw=8*8`` against JAX's
  unfused bf16 forward, at the bars of
  tests/test_fused_mbconv_banded.py:107-111 (0.05, 0.99); measured 0.0125
  and 1.0.  At least 4 blocks take the banded wrapper, as that test
  asserts of JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.models import frozen as jf
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.ops.fused_mbconv import FusedBlock as JFusedBlock
from ams_tpu.ops.fused_mbconv import stage_fits_vmem

from ams_tpu_torch import configs
from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.models import frozen as tf
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    _BLOCKS,
    block_name,
    trainable_names,
)
from ams_tpu_torch.ops import fused_mbconv as F
from ams_tpu_torch.ops import fused_mbconv_banded as FB
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.stream.codec import encode_delta

from test_torch_mbconv import _OCC    # the planner's H100 stand-in

CI = tuple(range(19))
EXACT_BAR = 2.0 ** -7


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    params = jm.init_student_params(jax.random.PRNGKey(0))
    params["logits/semantic/weights"] = (
        params["logits/semantic/weights"] * 300.0)
    folded = jf.fold_student(params)
    frames = np.random.RandomState(0).randint(
        0, 256, (1, 65, 129, 3)).astype(np.float32)
    ref = np.asarray(jf.student_forward_folded(
        folded, jnp.asarray(frames), CI, out_hw=None,
        compute_dtype=jnp.bfloat16), np.float32)
    tp = params_from_numpy({k: np.asarray(v) for k, v in folded.items()},
                           "cpu")
    return folded, tp, frames, ref, {k: np.asarray(v)
                                     for k, v in params.items()}


def _forward(tp, frames, **kw):
    with torch.inference_mode():
        return tf.student_forward_folded(tp, torch.from_numpy(frames), CI,
                                         compute_dtype=torch.bfloat16, **kw)


def _assert_bars(got, ref, err_bar, agree_bar):
    assert got.shape == ref.shape
    scale = np.abs(ref).max() + 1e-9
    assert np.abs(got - ref).max() / scale <= err_bar
    agree = (ref.argmax(-1) == got.argmax(-1)).mean()
    assert agree > agree_bar, agree


def test_unfused_grid_matches(case):
    _, tp, frames, ref, _ = case
    got = _forward(tp, frames, out_hw=None)
    assert got.dtype == torch.bfloat16
    _assert_bars(got.float().numpy(), ref, EXACT_BAR, 0.999)


def test_unfused_resized_and_fast_predict_match(case):
    folded, tp, frames, _, _ = case
    ci = (0, 2, 5, 8, 11, 13)
    want = np.asarray(jf.student_forward_folded(
        folded, jnp.asarray(frames), ci, compute_dtype=jnp.bfloat16))
    want_ids = np.asarray(jf.student_predict_fast_folded(
        folded, jnp.asarray(frames), ci, compute_dtype=jnp.bfloat16,
        interpret=True))
    with torch.inference_mode():
        got = tf.student_forward_folded(tp, torch.from_numpy(frames), ci,
                                        compute_dtype=torch.bfloat16)
        ids = tf.student_predict_fast_folded(tp, torch.from_numpy(frames), ci,
                                             compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_bars(got.numpy(), want, EXACT_BAR, 0.999)
    assert (ids.numpy() == want_ids).mean() > 0.999


def test_fused_true_matches_jax_fused(case):
    folded, tp, frames, ref, _ = case
    want = np.asarray(jf.student_forward_folded(
        folded, jnp.asarray(frames), CI, out_hw=None,
        compute_dtype=jnp.bfloat16, fused_blocks=True, interpret=True),
        np.float32)
    got = _forward(tp, frames, out_hw=None, fused_blocks=True)
    _assert_bars(got.float().numpy(), want, 0.05, 0.99)
    _assert_bars(got.float().numpy(), ref, 0.05, 0.99)


def test_banded_matches_jax_unfused(case, monkeypatch):
    _, tp, frames, ref, _ = case
    calls = []
    real = FB.mbconv_banded

    def counting(x, *args, **kw):
        calls.append((tuple(x.shape), kw["stride"]))
        return real(x, *args, **kw)

    monkeypatch.setattr(FB, "mbconv_banded", counting)
    got = _forward(tp, frames, out_hw=None, fused_blocks="banded",
                   banded_min_hw=8 * 8)
    assert len(calls) >= 4, calls
    _assert_bars(got.float().numpy(), ref, 0.05, 0.99)


def test_fused_true_fuses_every_stride1_stage(case, monkeypatch):
    """The routing difference: JAX's ``stage_fits_vmem`` keeps the large,
    narrow stages of a 512x1024 frame unfused; the port's tile choice fits
    every stage, so each of the 14 stride-1 blocks takes the fused
    wrapper, at any frame size."""
    folded, tp, frames, _, _ = case
    h, w = 257, 513                    # the stem grid of a 512x1024 frame
    stage0 = [JFusedBlock(folded, block_name(0), False, 1, False)]
    assert not stage_fits_vmem(h, w, stage0)
    cin, cmid, cout = 32, 32, 16
    assert F.smem_bytes(cin, cout, 1, 1, False,
                        *F.stage_tile(cin, cmid, cout, 1, 1, False,
                                      occupancy=_OCC)) <= F.SMEM_LIMIT
    calls = []
    real = F.mbconv_block

    def counting(x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(x, *args, **kw)

    monkeypatch.setattr(F, "mbconv_block", counting)
    _forward(tp, frames, out_hw=None, fused_blocks=True)
    assert len(calls) == sum(1 for b in _BLOCKS if b[2] == 1) == 14


def test_defaults_stay_float32_and_fused_needs_bf16(case):
    """The port's folded forward defaults to float32 (JAX's to bfloat16):
    the default output equals the explicit float32 one and is f32."""
    _, tp, frames, _, _ = case
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        default = tf.student_forward_folded(tp, x, CI, out_hw=None)
        f32 = tf.student_forward_folded(tp, x, CI, out_hw=None,
                                        compute_dtype=torch.float32)
        assert default.dtype == torch.float32
        assert torch.equal(default, f32)
        assert torch.equal(tf.student_predict_fast_folded(tp, x, CI),
                           tf.student_predict_fast_folded(
                               tp, x, CI, compute_dtype="float32"))
        for fused in (True, "banded"):
            with pytest.raises(ValueError):
                tf.student_forward_folded(tp, x, CI, fused_blocks=fused)
        with pytest.raises(ValueError):
            tf.student_forward_folded(tp, x, CI, fused_blocks="yes",
                                      compute_dtype=torch.bfloat16)


def test_fused_forward_follows_apply_downlink(case):
    """The cached kernel-layout weights never outlive a parameter change:
    after apply_downlink on a client and a new fold, the fused forward
    equals the unfused forward on the new weights, not the old ones."""
    params, frames = case[4], case[2]
    net = SemanticNetwork(dict(params), configs.class_weights(0), height=64,
                          frozen=True, compute_dtype="bfloat16", device="cpu")
    before = _forward(tf.fold_student(net.params), frames, out_hw=None,
                      fused_blocks=True).float().numpy()
    rng = np.random.RandomState(9)
    masks = {k: rng.rand(*params[k].shape) < 0.2
             for k in trainable_names(params)}
    moved = {k: np.where(masks[k], params[k] * np.float32(1.5), params[k])
             for k in masks}
    net.apply_downlink(encode_delta(moved, masks, strategy="coord_desc_auto",
                                    wire_dtype="float16"),
                       strategy="coord_desc_auto", wire_dtype="float16")
    new = tf.fold_student(net.params)
    fused = _forward(new, frames, out_hw=None,
                     fused_blocks=True).float().numpy()
    unfused = _forward(new, frames, out_hw=None).float().numpy()
    _assert_bars(fused, unfused, 0.05, 0.99)
    scale = np.abs(unfused).max()
    assert np.abs(fused - before).max() > 0.1 * scale
