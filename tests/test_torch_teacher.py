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
  inside XLA's fused chains in JAX);
- BN folded into the convolutions (``fold_teacher``), on the benchmark's
  seeded weights with BN statistics calibrated by its reference (scales
  U(0.75, 1.25), offsets U(1, 2), statistics from the frames), for the
  AMS teacher and DeepLabV3+ at output stride 8: the float32 grid logits
  within 1e-4 * max|unfused| (measured 3.2e-6 and 2.2e-6 on 2 threads);
  raw params run every BN unfused, as before; the 1x1 GEMM route
  (``layers.conv2d_bias``) in bf16 within one bf16 rounding of the
  float32 convolution plus its bias.
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
from ams_tpu_torch.utils.trace import GLOBAL_TIMER

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
from teacher_oracle import params_for  # noqa: E402
from perfbench.entries.labeler import pad_like_ams  # noqa: E402
from perfbench.lib import frames as bench_frames  # noqa: E402
from perfbench.lib import weights  # noqa: E402
from perfbench.reference import teacher as ref_os16  # noqa: E402
from perfbench.reference import teacher_v3plus as ref_os8  # noqa: E402
from perfbench.reference.common import tf32_off  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
HEIGHTS = (65, 129)
TIE = 1e-3
FAST_AGREE = 0.99
CONFIGS = [tx.TEACHER_OS16, tx.DEEPLABV3PLUS_OS8]
CONFIG_IDS = ["ams", "os8"]
BN_SITES = {tx.TEACHER_OS16: 141, tx.DEEPLABV3PLUS_OS8: 146}


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


def _bf16_fast_agrees_with_jax(tf_cases, params, jax_params, route):
    frames = tf_cases[HEIGHTS[1]]["frames"]
    want = np.asarray(jax.jit(jx.teacher_predict_fast)(
        jax_params, jnp.asarray(frames)))
    with torch.inference_mode():
        f = torch.from_numpy(frames)
        grid = tx.teacher_logits_nchw(params, f,
                                      compute_dtype=torch.bfloat16,
                                      out_hw=None)
        got = tx.teacher_predict_fast(params, f).numpy()
    # the grid goes to K1 as the bf16 forward leaves it: channels-last
    assert grid.dtype == torch.bfloat16
    assert grid.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape and got.dtype == np.int32
    agree = float((got == want).mean())
    f32_agree = float((got == tf_cases[HEIGHTS[1]]["logits"].argmax(-1))
                      .mean())
    print("bf16 fast path (%s): ids agree with JAX's on %.5f of pixels, "
          "with the f32 TF argmax on %.5f" % (route, agree, f32_agree))
    assert agree >= FAST_AGREE


def test_bf16_predict_fast_agrees_with_jax(tf_cases, torch_params,
                                           jax_params):
    _bf16_fast_agrees_with_jax(tf_cases, torch_params, jax_params, "raw")


def test_bf16_folded_predict_fast_agrees_with_jax(tf_cases, torch_params,
                                                  jax_params):
    """The labeler's bf16 route, BN folded at load (``fold_teacher``),
    against the JAX package's bf16 fast path on all pixels, at the bar
    the raw route is held to."""
    folded = tx.fold_teacher(torch_params, torch.bfloat16)
    _bf16_fast_agrees_with_jax(tf_cases, folded, jax_params, "folded")


@pytest.mark.cuda
def test_k1_on_teacher_grid_and_one_labeler_chunk_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: K1 is CUDA only")
    from ams_tpu_torch.ops import build
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.runtime.labeler import make_teacher_labeler

    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (2, 256, 512, 3)).astype(np.uint8)
    # the labeler's bf16 params: BN folded at load
    params = tx.fold_teacher(tx.init_teacher_params(0, device="cuda"),
                             torch.bfloat16)
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


# --- BN folded into the convolutions ------------------------------------------

@pytest.fixture(scope="module")
def calibrated():
    """{config: (the benchmark's seeded weights with BN statistics
    calibrated by its reference, two seeded frames of 64x128 padded as
    AMS pads to 65x129)}."""
    tf32_off()
    padded = pad_like_ams(bench_frames.frames(2, 64, 128, 4, "cpu"))
    out = {}
    for config, ref, kw in ((tx.TEACHER_OS16, ref_os16, {}),
                            (tx.DEEPLABV3PLUS_OS8, ref_os8,
                             {"output_stride": 8})):
        p = weights.init(ref.param_specs(), 9, "cpu")
        ref.calibrate(p, padded, **kw)
        out[config] = (p, padded)
    return out


@pytest.mark.parametrize("config", CONFIGS, ids=CONFIG_IDS)
def test_folded_f32_grid_logits_equal_the_unfused(calibrated, config):
    params, frames = calibrated[config]
    scales = [params[k] for k in params if k.endswith("/gamma")]
    assert min(float(g.min()) for g in scales) < 0.8
    folded = tx.fold_teacher(params)
    with torch.inference_mode():
        want = tx.teacher_logits_nchw(params, frames, out_hw=None,
                                      config=config)
        got = tx.teacher_logits_nchw(folded, frames, out_hw=None,
                                     config=config)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max()) / float(want.abs().max())
    print("folded f32 grid: max |folded - unfused| / max|unfused| = %.3g"
          % err)
    assert err <= 1e-4


@pytest.mark.parametrize("config", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_raw_params_run_every_bn_unfused(calibrated, monkeypatch, config,
                                         dtype):
    """Raw params take the unfused route: one ``batch_norm_infer`` per BN
    site, no BN counter, and the forward of before."""
    params, frames = calibrated[config]
    calls = []
    infer = layers.batch_norm_infer

    def spy(x, *args, **kwargs):
        calls.append(x.dtype)
        return infer(x, *args, **kwargs)

    monkeypatch.setattr(layers, "batch_norm_infer", spy)
    GLOBAL_TIMER.reset()
    with torch.inference_mode():
        tx.teacher_logits_nchw(params, frames[:1], out_hw=None,
                               compute_dtype=dtype, config=config)
    assert len(calls) == BN_SITES[config]
    assert set(calls) == {dtype}
    assert not any(k.startswith("teacher/bn_") for k in GLOBAL_TIMER.counts)
    GLOBAL_TIMER.reset()


@pytest.mark.parametrize("config", CONFIGS, ids=CONFIG_IDS)
def test_folded_params_refuse_width_shards(calibrated, config):
    from ams_tpu_torch.parallel import spatial

    params, frames = calibrated[config]
    shards = spatial.shard_width(frames[:1], ["cpu", "cpu"], dim=2)
    with pytest.raises(ValueError, match="width shards"):
        tx.teacher_logits_nchw(tx.fold_teacher(params), shards,
                               config=config)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 11, 16, 24),
                                            (1, 1, 1, 32, 8)])
def test_conv2d_bias_gemm_route(n, h, w, cin, cout, relu):
    """A bf16 1x1 at stride 1 is one GEMM on the channels-last view with
    the bias (and ReLU) in its epilogue, and returns the channels-last
    output; within one bf16 rounding of the float32 convolution plus the
    bias (bf16's)."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(n, cin, h, w, generator=g)
    wt = torch.randn(1, 1, cin, cout, generator=g) * 0.2
    b = torch.randn(cout, generator=g)
    y, fused = layers.conv2d_bias(x, wt, b, compute_dtype=torch.bfloat16,
                                  relu=relu)
    assert fused and y.dtype == torch.bfloat16
    assert y.shape == (n, cout, h, w)
    assert y.is_contiguous(memory_format=torch.channels_last)
    xb, wb = x.bfloat16().float(), wt.bfloat16().float()
    want = torch.nn.functional.conv2d(xb, wb.permute(3, 2, 0, 1)) \
        + b.bfloat16().float()[:, None, None]
    if relu:
        want = torch.relu(want)
    np.testing.assert_allclose(y.float().numpy(), want.numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("case", ["stride2", "kernel3x3", "nchw_f32"])
def test_conv2d_bias_pass_route(case):
    """Everything else is ``conv2d`` then the bias as a pass, the sum
    rounded once to the output's type."""
    x, wt = torch.randn(2, 8, 9, 11), torch.randn(1, 1, 8, 6) * 0.3
    b, kw = torch.randn(6), {"compute_dtype": torch.bfloat16}
    if case == "stride2":
        kw["stride"] = 2
    elif case == "kernel3x3":
        wt = torch.randn(3, 3, 8, 6) * 0.1
    else:
        kw["compute_dtype"] = torch.float32
    y, fused = layers.conv2d_bias(x, wt, b, **kw)
    assert not fused
    want = layers.conv2d(x, wt, **kw)
    assert torch.equal(y, (want.float() + b[:, None, None]).to(want.dtype))
