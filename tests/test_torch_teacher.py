"""The port's Xception-65 teacher held against the TF fixtures and the JAX
package, on the CPU.

Weights: the TF fixtures' own (``tools/teacher_oracle.params_for``, a
value per variable name), carried into both packages as numpy arrays, so
that every comparison runs the same weights on the same frames.

Tolerances, with what was measured on this host (2 threads):
- f32 logits within 1e-4 of the TF logits (the gate of
  tests/test_parity_teacher.py; measured 3.7e-7 at h65, 6.1e-7 at h129)
  and of JAX's, argmax equal off ties (top-2 margin below 1e-3);
- the ``teacher_outputs`` bundle against JAX's key by key: ids and one-hot
  maps equal off ties, float maps within 1e-4;
- ``resize_nearest_ac`` and the explicitly padded convolutions in float32:
  equal, and within 1e-5; in bfloat16 the convolutions within one bf16
  rounding of JAX's (rtol 2**-7: both sum in float32 in their own order
  and round once);
- the bf16 fast path (``teacher_predict_fast``, the plain K1 on the CPU)
  against JAX's (the Pallas kernel in interpret mode): ids agree on at
  least 0.99 of pixels, the bar tests/test_torch_bf16_network.py holds
  the bf16 student to (bf16 rounds after every operation in the port,
  inside XLA's fused chains in JAX).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.models import layers as jlayers
from ams_tpu.models import xception_deeplab as jx
from ams_tpu.models.resize import resize_nearest_ac as jax_nearest

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.models import layers
from ams_tpu_torch.models import xception_deeplab as tx
from ams_tpu_torch.models.resize import resize_nearest_ac

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from teacher_oracle import params_for  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HEIGHTS = (65, 129)
TIE = 1e-3
FAST_AGREE = 0.99


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tf_cases():
    out = {}
    for h in HEIGHTS:
        with np.load(os.path.join(FIXTURES, "teacher_parity_h%d.npz" % h),
                     allow_pickle=True) as z:
            data = {k: z[k] for k in z.files}
        shapes = {k[len("shape:"):]: tuple(int(s) for s in v)
                  for k, v in data.items() if k.startswith("shape:")}
        out[h] = dict(frames=data["frames"], logits=data["logits"],
                      params=params_for(shapes, int(data["seed"])),
                      shapes=shapes)
    return out


@pytest.fixture(scope="module")
def torch_params(tf_cases):
    # the oracle's values depend on the name alone: both fixtures share them
    return params_from_numpy(tf_cases[HEIGHTS[0]]["params"], "cpu")


@pytest.fixture(scope="module")
def jax_params(tf_cases):
    return {k: jnp.asarray(v)
            for k, v in tf_cases[HEIGHTS[0]]["params"].items()}


def _off_tie_mismatches(got, want_logits):
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE
    return int(((got != want_logits.argmax(-1)) & ~tie).sum())


def test_param_names_and_shapes_match_jax_and_inventory(tf_cases):
    mine = tx.init_teacher_params(0, device="cpu")
    want = {k: tuple(v.shape) for k, v in
            jx.init_teacher_params(jax.random.PRNGKey(0)).items()}
    got = {k: tuple(v.shape) for k, v in mine.items()}
    assert got == want
    with open(os.path.join(FIXTURES, "teacher_inventory.json")) as f:
        inventory = {k: tuple(v) for k, v in json.load(f).items()}
    assert got == inventory == tf_cases[HEIGHTS[0]]["shapes"]
    assert all(v.dtype == torch.float32 for v in mine.values())
    w = mine["xception_65/middle_flow/block1/unit_1/xception_module/"
             "separable_conv1_pointwise/weights"]
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / 728) + 1e-7


@pytest.mark.parametrize("h", HEIGHTS)
def test_f32_logits_match_tf_fixture(tf_cases, torch_params, h):
    case = tf_cases[h]
    with torch.inference_mode():
        got = tx.teacher_logits(torch_params,
                                torch.from_numpy(case["frames"])).numpy()
    want = case["logits"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    print("h%d: max |port - TF| = %.3g" % (h, err))
    assert err < 1e-4
    assert _off_tie_mismatches(got.argmax(-1), want) == 0


@pytest.mark.parametrize("h", HEIGHTS)
def test_f32_logits_match_jax(tf_cases, torch_params, jax_params, h):
    frames = tf_cases[h]["frames"]
    want = np.asarray(jax.jit(lambda p, f: jx.teacher_logits(
        p, f, compute_dtype=jnp.float32))(jax_params, jnp.asarray(frames)))
    want_grid = np.asarray(jax.jit(lambda p, f: jx.teacher_logits(
        p, f, compute_dtype=jnp.float32, out_hw=None))(
            jax_params, jnp.asarray(frames)))
    with torch.inference_mode():
        f = torch.from_numpy(frames)
        got = tx.teacher_logits(torch_params, f).numpy()
        grid = tx.teacher_logits(torch_params, f, out_hw=None).numpy()
    assert grid.shape == want_grid.shape
    assert float(np.abs(grid - want_grid).max()) < 1e-4
    assert float(np.abs(got - want).max()) < 1e-4
    assert _off_tie_mismatches(got.argmax(-1), want) == 0


def test_teacher_outputs_match_jax_key_by_key(tf_cases, torch_params,
                                              jax_params):
    frames = tf_cases[HEIGHTS[0]]["frames"]
    ci, small = (0, 13), (16, 32)
    want = jax.jit(lambda p, f: jx.teacher_outputs(
        p, f, class_indices=ci, small_hw=small))(jax_params,
                                                 jnp.asarray(frames))
    want = {k: np.asarray(v) for k, v in want.items()}
    with torch.inference_mode():
        f = torch.from_numpy(frames)
        got = {k: v.numpy() for k, v in tx.teacher_outputs(
            torch_params, f, class_indices=ci, small_hw=small).items()}
        preds = tx.teacher_predictions(torch_params, f).numpy()
    assert set(got) == set(want) == {
        "logits", "predictions", "probabilities", "logits_sml",
        "predictions_reduced", "weights", "predictions_one_hot_reduced"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype,
                                               want[k].dtype)
    logits = want["logits"]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) >= TIE
    for k in ("predictions", "predictions_reduced", "weights"):
        np.testing.assert_array_equal(got[k][decisive], want[k][decisive],
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["predictions_one_hot_reduced"][decisive],
        want["predictions_one_hot_reduced"][decisive])
    for k in ("logits", "probabilities", "logits_sml"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(preds, got["predictions"])
    assert set(np.unique(got["weights"])) <= {0.0, 1.0}


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((3, 3), (5, 5)),        # align-corners sources 0, .5, 1, 1.5, 2
    ((5, 9), (9, 17)),       # .5 at every odd output
    ((64, 128), (16, 32)),   # the teacher's logits_sml, down
    ((7, 11), (7, 11)),      # same size: unchanged
    ((4, 6), (1, 1)),        # one output pixel
    ((2, 3), (13, 20)),
])
def test_resize_nearest_ac_matches_jax(in_hw, out_hw, align_corners):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, *in_hw).astype(np.float32)          # NCHW
    want_nhwc = np.asarray(jax_nearest(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       out_hw, align_corners=align_corners))
    got = resize_nearest_ac(torch.from_numpy(x), out_hw,
                            align_corners=align_corners).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want_nhwc)
    plane = x[0, 0]                                         # (H, W)
    np.testing.assert_array_equal(
        resize_nearest_ac(torch.from_numpy(plane), out_hw,
                          align_corners=align_corners).numpy(),
        np.asarray(jax_nearest(jnp.asarray(plane), out_hw,
                               align_corners=align_corners)))


def test_resize_nearest_ac_rounds_half_away_from_zero():
    x = torch.arange(3.0)
    # sources 0, 0.5, 1, 1.5, 2 -> 0, 1, 1, 2, 2 (np.rint would give 0, 0,
    # 1, 2, 2)
    got = resize_nearest_ac(x[None, :], (1, 5))
    assert got.tolist() == [[0.0, 1.0, 1.0, 2.0, 2.0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(16, 24), (17, 33)])
@pytest.mark.parametrize("kind,stride,rate,padding", [
    ("conv", 2, 1, ((1, 1), (1, 1))),          # slim's fixed padding
    ("depthwise", 2, 1, ((1, 1), (1, 1))),
    ("conv", 1, 1, ((0, 2), (1, 0))),          # asymmetric pairs
    ("depthwise", 1, 2, ((2, 2), (2, 2))),
    ("depthwise", 1, 6, "SAME"),               # the default unchanged
])
def test_explicit_padding_matches_jax(kind, stride, rate, padding, hw,
                                      dtype):
    rng = np.random.RandomState(7)
    cin = 8
    x = rng.randn(2, *hw, cin).astype(np.float32)
    if kind == "conv":
        w = rng.randn(3, 3, cin, 5).astype(np.float32) * 0.3
        jfn, tfn = jlayers.conv2d, layers.conv2d
    else:
        w = rng.randn(3, 3, cin, 1).astype(np.float32) * 0.3
        jfn, tfn = jlayers.depthwise_conv2d, layers.depthwise_conv2d
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), stride=stride,
                          rate=rate, padding=padding, compute_dtype=jd)
                      .astype(jnp.float32))
    got = tfn(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
              stride=stride, rate=rate, padding=padding,
              compute_dtype=dtype)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-2)


def test_padding_rejects_other_strings():
    x, w = torch.zeros(1, 2, 5, 5), torch.zeros(3, 3, 2, 1)
    with pytest.raises(ValueError):
        layers.depthwise_conv2d(x, w, padding="VALID")


def test_bf16_predict_fast_agrees_with_jax(tf_cases, torch_params,
                                           jax_params):
    frames = tf_cases[HEIGHTS[1]]["frames"]
    want = np.asarray(jax.jit(jx.teacher_predict_fast)(
        jax_params, jnp.asarray(frames)))
    with torch.inference_mode():
        f = torch.from_numpy(frames)
        grid = tx.teacher_logits_nchw(torch_params, f,
                                      compute_dtype=torch.bfloat16,
                                      out_hw=None)
        got = tx.teacher_predict_fast(torch_params, f).numpy()
    # the grid goes to K1 as the bf16 forward leaves it: channels-last
    assert grid.dtype == torch.bfloat16
    assert grid.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape and got.dtype == np.int32
    agree = float((got == want).mean())
    f32_agree = float((got == tf_cases[HEIGHTS[1]]["logits"].argmax(-1))
                      .mean())
    print("bf16 fast path: ids agree with JAX's on %.5f of pixels, with "
          "the f32 TF argmax on %.5f" % (agree, f32_agree))
    assert agree >= FAST_AGREE


@pytest.mark.cuda
def test_k1_on_teacher_grid_and_one_labeler_chunk_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: K1 is CUDA only")
    from ams_tpu_torch.ops import build
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.runtime.labeler import make_teacher_labeler

    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 256, 512, 3)).astype(np.uint8)
    params = tx.init_teacher_params(0, device="cuda")
    padded = torch.from_numpy(np.pad(frames, ((0, 0), (1, 0), (1, 0), (0, 0)),
                                     mode="symmetric")).cuda()
    with torch.inference_mode():
        grid = tx.teacher_logits_nchw(params, padded,
                                      compute_dtype=torch.bfloat16,
                                      out_hw=None)
        assert grid.shape == (2, 19, 17, 33)
        before = build.launch_count("resize_argmax")
        got = fra.fused_resize_argmax(grid, (257, 513))
        want = fra.resize_argmax_plain(grid, (257, 513))
        torch.cuda.synchronize()
    assert build.launch_count("resize_argmax") == before + 1
    assert torch.equal(got, want)
    label = make_teacher_labeler(batch=2, device="cuda")
    before = build.launch_count("resize_argmax")
    ids = label(frames)
    assert build.launch_count("resize_argmax") == before + 1
    assert ids.shape == (2, 256, 512) and ids.dtype == np.uint8
    np.testing.assert_array_equal(ids, got.cpu().numpy()[:, 1:, 1:])
