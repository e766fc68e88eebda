"""DeepLabV3+ Xception-65 in the port (``models.xception_deeplab`` under a
``TeacherConfig``) held against the benchmark's plain float32 reference
(``perfbench/reference/teacher_v3plus.py``) on the CPU; its labeler, its
checkpoint guard, the CLI's flags and the teacher's spans.

Weights: ``perfbench.lib.weights.init`` of the reference's specs, BN
statistics calibrated by the reference on the frames compared, as the
benchmark's cell makes them.  Gates, with TF32 off:
- the float32 grid logits within 1e-4 * max|ref| (the gate of
  ``perfbench/tests/test_bench_reference.py``; measured 2.9e-6 at output
  stride 8 and 2.1e-6 at 16 with the decoder, on 2 frames of 129x257 on
  2 CPU threads), at 16 so that the decoder is held alone;
- the float32 labeler's ids equal to the reference's argmax wherever its
  top-two margin exceeds 2e-4 * max|ref|, twice the logits' gate;
- the bfloat16 labeler, which folds BN into the convolutions at load
  (``fold_teacher``), against the unfused bf16 forward of the raw params
  for DeepLabV3+ at 8 and the AMS teacher, on 2 frames of 64x128: ids
  agree on at least 0.99 of the pixels whose float32 top-two margin
  exceeds 1% of max|logit| (the bar of the port's bf16 tests, off the
  near-ties that the bf16 routes' grid error, up to 3-5% of max|logit|,
  can flip: over every pixel the two bf16 routes agree on 0.970-0.978 of
  them here, while each agrees with the float32 argmax on 0.971-0.989;
  measured 0.998-1.0 on the decisive pixels); every BN site counted once
  per forward, as an epilogue or as a pass (``teacher/bn_epilogue``,
  ``teacher/bn_pass``): 131 and 15 at 8, 76 and 65 at 16.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ams_tpu_torch.cli import extract_labels as cli  # noqa: E402
from ams_tpu_torch.data.image import bgr_to_rgb, png_read  # noqa: E402
from ams_tpu_torch.data.video import (  # noqa: E402
    open_video,
    write_synthetic_clip,
)
from ams_tpu_torch.models import layers  # noqa: E402
from ams_tpu_torch.models import xception_deeplab as tx  # noqa: E402
from ams_tpu_torch.ops import fused_resize_argmax as k1  # noqa: E402
from ams_tpu_torch.runtime import labeler as lab  # noqa: E402
from ams_tpu_torch.utils.trace import GLOBAL_TIMER, SpanRecord  # noqa: E402
from perfbench.entries.labeler import pad_like_ams  # noqa: E402
from perfbench.lib import frames as bench_frames  # noqa: E402
from perfbench.lib import spans, weights  # noqa: E402
from perfbench.lib.trace import Trace  # noqa: E402
from perfbench.reference import teacher as ref_os16  # noqa: E402
from perfbench.reference import teacher_v3plus as ref  # noqa: E402
from perfbench.reference.common import resize_ac, tf32_off  # noqa: E402

CPU = torch.device("cpu")
PARAMETERS = 41_257_699
DECODER_PARAMETERS = 165_168
OS16_DECODER = tx.TeacherConfig(16, 4, True)
CONFIG_FILE = os.path.join(ROOT, "perfbench", "configs",
                           "xception65-deeplabv3plus-os8-cityscapes.json")
FOLD_CONFIGS = [tx.TEACHER_OS16, tx.DEEPLABV3PLUS_OS8]
FOLD_IDS = ["ams", "os8"]
# {config: (offsets in an epilogue, offsets as a pass)} per bf16 forward:
# at 8, 63 pointwise, 57 dilated depthwise, 9 head and decoder 1x1s and 2
# stride-1 shortcuts, against 2 stems, 11 rate-1 depthwise and 2 stride-2
# shortcuts; at 16, 63, 6, 6 and 1 against 2, 60 and 3
BN_SPLIT = {tx.TEACHER_OS16: (76, 65), tx.DEEPLABV3PLUS_OS8: (131, 15)}
# the AMS teacher's block table before configurations existed
TODAY = (
    [("entry_flow/block1/unit_1", [128, 128, 128], 2, 1, "conv")] +
    [("entry_flow/block2/unit_1", [256, 256, 256], 2, 1, "conv")] +
    [("entry_flow/block3/unit_1", [728, 728, 728], 2, 1, "conv")] +
    [("middle_flow/block1/unit_%d" % (i + 1), [728, 728, 728], 1, 1, "sum")
     for i in range(16)] +
    [("exit_flow/block1/unit_1", [728, 1024, 1024], 1, 1, "conv")] +
    [("exit_flow/block2/unit_1", [1536, 1536, 2048], 1, 2, "none")]
)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture
def global_timer():
    """GLOBAL_TIMER emptied before and after the test."""
    GLOBAL_TIMER.reset()
    yield GLOBAL_TIMER
    GLOBAL_TIMER.reset()


@pytest.fixture(scope="module")
def raw():
    """Two seeded frames of 128x256: 129x257 once padded as AMS pads."""
    return bench_frames.frames(2, 128, 256, 4, CPU)


@pytest.fixture(scope="module")
def cases(raw):
    """{output stride: (weights calibrated there, the reference's float32
    grid logits of the padded frames)}."""
    tf32_off()
    padded = pad_like_ams(raw)
    out = {}
    for stride in (8, 16):
        p = weights.init(ref.param_specs(), 9, CPU)
        ref.calibrate(p, padded, output_stride=stride)
        with torch.no_grad():
            out[stride] = (p, ref.grid_logits(p, padded,
                                              output_stride=stride))
    return out


def test_inventory_matches_the_reference_and_the_configuration():
    port = tx.init_teacher_params(0, device="cpu",
                                  config=tx.DEEPLABV3PLUS_OS8)
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {n: s for n, s, _ in ref.param_specs()}
    assert sum(v.numel() for v in port.values()) == PARAMETERS
    with open(CONFIG_FILE) as f:
        assert json.load(f)["parameters"] == PARAMETERS
    base = tx.init_teacher_params(0, device="cpu")
    added = set(port) - set(base)
    assert set(base) < set(port)
    assert all(k.startswith("decoder/") for k in added)
    assert sum(port[k].numel() for k in added) == DECODER_PARAMETERS
    # everything drawn before the decoder's variables draws as before
    for k in base:
        if k != "logits/semantic/weights":
            assert torch.equal(port[k], base[k]), k


def test_default_block_table_and_rates_are_the_ams_teachers():
    assert tx.xception_blocks() == tx.xception_blocks(tx.TEACHER_OS16) \
        == TODAY
    assert tx.aspp_rates() == tx.ASPP_RATES == (6, 12, 18)
    assert tx.deeplab_teacher() is tx.TEACHER_OS16
    assert tx.deeplab_teacher(8, 4) == tx.DEEPLABV3PLUS_OS8


@pytest.mark.parametrize("config", [tx.DEEPLABV3PLUS_OS8, OS16_DECODER,
                                    tx.TEACHER_OS16],
                         ids=["os8", "os16_decoder", "ams"])
def test_block_table_follows_stack_blocks_dense(config):
    """The port's table against the reference's, which writes DeepLab's
    rule out again; at 8 the entry flow's last block runs at stride 1,
    the middle flow and the exit flow's first block at rate 2, its last
    at rate 4, and the ASPP at 12/24/36."""
    got = tx.xception_blocks(config)
    assert [(s, tuple(c), st, r, k) for s, c, st, r, k in got] == \
        ref.units(config.output_stride)
    if config.output_stride == 8:
        assert [(st, r) for _, _, st, r, _ in got] == \
            [(2, 1), (2, 1), (1, 1)] + [(1, 2)] * 16 + [(1, 2), (1, 4)]
        assert tx.aspp_rates(config) == (12, 24, 36)


@pytest.mark.parametrize("kwargs", [dict(output_stride=32),
                                    dict(decoder_output_stride=8)])
def test_config_refuses_what_deeplab_does_not_publish(kwargs):
    with pytest.raises(ValueError):
        tx.TeacherConfig(**kwargs)


@pytest.mark.parametrize("stride,config", [(8, tx.DEEPLABV3PLUS_OS8),
                                           (16, OS16_DECODER)],
                         ids=["os8", "os16_decoder"])
def test_f32_grid_logits_match_the_reference(cases, raw, stride, config):
    p, want = cases[stride]
    with torch.inference_mode():
        got = tx.teacher_logits_nchw(p, pad_like_ams(raw), out_hw=None,
                                     config=config)
    assert got.shape == want.shape == (2, 19, 33, 65)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_f32_labeler_matches_the_reference_argmax(cases, raw, tmp_path):
    p, grid = cases[8]
    path = str(tmp_path / "v3plus.npz")
    np.savez(path, **{k: v.numpy() for k, v in p.items()})
    label = lab.make_teacher_labeler(path, compute_dtype="float32", batch=2,
                                     device="cpu",
                                     teacher_config=tx.DEEPLABV3PLUS_OS8)
    ids = label(raw.numpy())
    assert ids.shape == (2, 128, 256) and ids.dtype == np.uint8
    logits = resize_ac(grid, (129, 257))[:, :, 1:, 1:]
    top2 = logits.topk(2, dim=1).values
    decisive = ((top2[:, 0] - top2[:, 1])
                > 2e-4 * float(logits.abs().max())).numpy()
    assert decisive.mean() > 0.99
    want = logits.argmax(1).numpy()
    np.testing.assert_array_equal(ids[decisive], want[decisive])


def test_fast_path_hands_k1_the_decoders_grid(monkeypatch):
    """bfloat16: K1 gets the stride-4 grid as the last convolution left
    it, channels-last, with no cast or copy before it."""
    seen = []
    real = k1.fused_resize_argmax

    def spy(grid, out_hw, class_index=None):
        seen.append((tuple(grid.shape), grid.dtype, grid.is_contiguous(
            memory_format=torch.channels_last), tuple(out_hw)))
        return real(grid, out_hw, class_index)

    monkeypatch.setattr(k1, "fused_resize_argmax", spy)
    p = tx.init_teacher_params(0, device="cpu", config=tx.DEEPLABV3PLUS_OS8)
    f = torch.randint(0, 256, (2, 33, 65, 3), dtype=torch.uint8)
    with torch.inference_mode():
        ids = tx.teacher_predict_fast(p, f, config=tx.DEEPLABV3PLUS_OS8)
    assert ids.shape == (2, 33, 65) and ids.dtype == torch.int32
    assert seen == [((2, 19, 9, 17), torch.bfloat16, True, (33, 65))]


def test_width_shards_refuse_other_teachers():
    from ams_tpu_torch.parallel import spatial

    p = tx.init_teacher_params(0, device="cpu", config=tx.DEEPLABV3PLUS_OS8)
    f = torch.randint(0, 256, (1, 17, 33, 3), dtype=torch.uint8)
    shards = spatial.shard_width(f, [CPU, CPU], dim=2)
    with pytest.raises(ValueError, match="width shards"):
        tx.teacher_logits_nchw(p, shards, config=tx.DEEPLABV3PLUS_OS8)


def _save_npy(path, params, drop=()):
    np.save(path, {"teacher/%s:0" % k: v.numpy() for k, v in params.items()
                   if k not in drop}, allow_pickle=True)
    return str(path)


def test_checkpoint_without_the_decoder_raises(tmp_path):
    """A seeded decoder never stands in under a checkpoint that has none
    (the AMS teacher's), nor for one variable it lacks."""
    os16 = _save_npy(tmp_path / "os16.npy",
                     tx.init_teacher_params(0, device="cpu"))
    full = tx.init_teacher_params(1, device="cpu",
                                  config=tx.DEEPLABV3PLUS_OS8)
    short = _save_npy(tmp_path / "short.npy", full,
                      drop=("decoder/decoder_conv1_pointwise/weights",))
    for path in (os16, short):
        with pytest.raises(ValueError, match="decoder"):
            lab._load_teacher_params(path, 0, CPU, tx.DEEPLABV3PLUS_OS8)
    with pytest.raises(ValueError, match="decoder"):
        lab.make_teacher_labeler(os16, device="cpu",
                                 teacher_config=tx.DEEPLABV3PLUS_OS8)
    whole = _save_npy(tmp_path / "whole.npy", full)
    got = lab._load_teacher_params(whole, 0, CPU, tx.DEEPLABV3PLUS_OS8)
    assert set(got) == set(full)
    assert all(torch.equal(got[k], full[k]) for k in full)
    assert set(lab._load_teacher_params(os16, 0, CPU)) < set(full)


@pytest.mark.parametrize("flags,want", [
    ([], tx.TEACHER_OS16),
    (["--output_stride", "8", "--decoder_output_stride", "4"],
     tx.DEEPLABV3PLUS_OS8),
    (["--output_stride", "16", "--decoder_output_stride", "4"],
     OS16_DECODER),
    (["--output_stride", "8"], tx.TeacherConfig(8, None, True)),
], ids=["omitted", "os8_decoder", "os16_decoder", "os8"])
def test_cli_flags_name_the_teacher(monkeypatch, flags, want):
    calls = []
    monkeypatch.setattr(cli, "extract_labels",
                        lambda *a, **k: calls.append(k) or 0)
    cli.main(["--input_video", "v", "--dump_path", "d/", "--device", "cpu"]
             + flags)
    assert calls[0]["teacher_config"] == want


@pytest.mark.parametrize("flags", [["--output_stride", "32"],
                                   ["--decoder_output_stride", "8"]])
def test_cli_refuses_other_strides(flags):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--input_video", "v", "--dump_path",
                                       "d/"] + flags)


def test_cli_labels_with_the_decoder_on_cpu(tmp_path, capsys):
    clip = str(tmp_path / "90-synthetic")
    write_synthetic_clip(clip, seconds=1, fps=3, size_hw=(16, 32))
    dump = str(tmp_path / "labels") + "/"
    cli.main(["--input_video", clip, "--dump_path", dump, "--output_stride",
              "8", "--decoder_output_stride", "4", "--device", "cpu"])
    assert "There were 3 frames extracted" in capsys.readouterr().out
    reader = open_video(clip)
    frames = np.stack([bgr_to_rgb(reader.read()) for _ in range(3)])
    reader.release()
    want = lab.make_teacher_labeler(
        device="cpu", teacher_config=tx.DEEPLABV3PLUS_OS8)(frames)
    for i in range(3):
        np.testing.assert_array_equal(png_read(dump + "gt_%06d.png" % i),
                                      want[i])


def _forward_children(recs):
    """The names of the spans inside each ``labeler/forward``."""
    out = []
    for f in spans.named(recs, "labeler/forward"):
        out.append([r.name for r in sorted(recs, key=lambda r: r.id)
                    if r.parent == f.id])
    return out


@pytest.mark.parametrize("config,inside", [
    (tx.DEEPLABV3PLUS_OS8, ["teacher/trunk", "teacher/aspp",
                            "teacher/decoder"]),
    (None, ["teacher/trunk", "teacher/aspp"]),
], ids=["os8_decoder", "ams"])
def test_teacher_spans_nest_in_the_labeler_forward(global_timer, config,
                                                   inside):
    label = lab.make_teacher_labeler(compute_dtype="float32", batch=2,
                                     device="cpu", teacher_config=config)
    frames = np.random.RandomState(1).randint(0, 256, (5, 8, 16, 3)) \
        .astype(np.uint8)
    label(frames)
    assert global_timer.records == []       # nothing without a profile
    assert global_timer.counts["teacher/trunk"] == 3
    with profile(activities=[ProfilerActivity.CPU]):
        label(frames)
    recs = global_timer.records
    assert _forward_children(recs) == [inside] * 3      # one per chunk
    assert len(spans.named(recs, "teacher/decoder")) == \
        (3 if config else 0)


def _load_reader(name):
    from perfbench.harness import load_module

    return load_module(os.path.join(ROOT, "perfbench", "layer_metrics",
                                    name + ".py"), "reader_" + name)


def test_teacher_forward_reader(global_timer, monkeypatch):
    """Device time other than copies, memsets and K1, per
    ``teacher/decoder`` record; None where records and K1's launches
    disagree, or there is nothing to read."""
    reader = _load_reader("teacher_forward_ms_per_chunk.os8")
    t = Trace([("conv", 0, 100),
               ("Memcpy HtoD (Pageable -> Device)", 90, 150),
               ("resize_argmax_bf16", 150, 160), ("bn", 200, 300),
               ("Memset (Device)", 300, 310),
               ("resize_argmax_bf16", 310, 320)], [], 1e-6)
    decoder = [SpanRecord("teacher/decoder", 0, 1, i, -1, i, 0)
               for i in range(2)]

    def read(trace, records):
        monkeypatch.setattr(global_timer, "records", records)
        return reader.read(SimpleNamespace(trace_data=trace))

    assert read(t, decoder) == pytest.approx(1e3 * 200e-9 / 2)
    assert read(t, decoder[:1]) is None
    assert read(t, []) is None
    assert read(None, decoder) is None


# --- BN folded into the convolutions ------------------------------------------

@pytest.fixture(scope="module")
def fold_cases():
    """{config: (the benchmark's seeded weights calibrated by its
    reference, 2 seeded frames of 64x128)}."""
    tf32_off()
    raw = bench_frames.frames(2, 64, 128, 4, CPU)
    padded = pad_like_ams(raw)
    out = {}
    for config, reference, kw in ((tx.TEACHER_OS16, ref_os16, {}),
                                  (tx.DEEPLABV3PLUS_OS8, ref,
                                   {"output_stride": 8})):
        p = weights.init(reference.param_specs(), 9, CPU)
        reference.calibrate(p, padded, **kw)
        out[config] = (p, raw)
    return out


@pytest.mark.parametrize("config", FOLD_CONFIGS, ids=FOLD_IDS)
def test_fold_teacher_folds_every_bn(fold_cases, config):
    """Every BN's scale goes into its convolution's weights (cast once to
    the dtype asked for: within bf16's rounding of the float32 product)
    and its offset into a ``folded_bias``, with the trunk's eps or the
    head's: float32 for a depthwise convolution, which adds it to its f32
    sum, the dtype asked for otherwise; the logits layer is untouched."""
    p, _ = fold_cases[config]
    folded = tx.fold_teacher(p, torch.bfloat16)
    prefixes = [k[:-len("/BatchNorm/gamma")] for k in p
                if k.endswith("/BatchNorm/gamma")]
    assert len(prefixes) == sum(BN_SPLIT[config])
    assert not any("/BatchNorm/" in k for k in folded)
    assert set(folded) == {k for k in p if "/BatchNorm/" not in k} | {
        q + "/folded_bias" for q in prefixes}
    for q in prefixes:
        eps = layers.BN_EPS if q.startswith("xception_65/") \
            else tx.HEAD_BN_EPS
        bn = {k: p[q + "/BatchNorm/" + k] for k in (
            "gamma", "beta", "moving_mean", "moving_variance")}
        scale = bn["gamma"] / torch.sqrt(bn["moving_variance"] + eps)
        wk = q + ("/depthwise_weights" if q.endswith("_depthwise")
                  else "/weights")
        want_w = p[wk] * (scale[:, None] if q.endswith("_depthwise")
                          else scale)
        assert folded[wk].dtype == torch.bfloat16
        torch.testing.assert_close(folded[wk].float(), want_w,
                                   rtol=2 ** -8, atol=1e-30, msg=wk)
        bias = folded[q + "/folded_bias"]
        depthwise = q.endswith("_depthwise")
        assert bias.dtype == (torch.float32 if depthwise
                              else torch.bfloat16)
        torch.testing.assert_close(
            bias.float(), bn["beta"] - bn["moving_mean"] * scale,
            rtol=1e-6 if depthwise else 2 ** -8, atol=1e-6)
    for k in ("logits/semantic/weights", "logits/semantic/biases"):
        assert folded[k] is p[k]


@pytest.mark.parametrize("config", FOLD_CONFIGS, ids=FOLD_IDS)
def test_bf16_labeler_folds_and_agrees_with_the_unfused_forward(
        fold_cases, config, tmp_path, monkeypatch):
    p, raw = fold_cases[config]
    path = str(tmp_path / "teacher.npz")
    np.savez(path, **{k: v.numpy() for k, v in p.items()})
    folds = []
    monkeypatch.setattr(lab, "fold_teacher",
                        lambda *a: folds.append(a[1]) or tx.fold_teacher(*a))
    label = lab.make_teacher_labeler(path, compute_dtype="bfloat16",
                                     batch=2, device="cpu",
                                     teacher_config=config)
    assert folds == [torch.bfloat16]
    ids = label(raw.numpy())
    with torch.inference_mode():
        padded = pad_like_ams(raw)
        want = tx.teacher_predict_fast(p, padded, config=config)
        f32 = tx.teacher_logits_nchw(p, padded, config=config)
    want = want[:, 1:, 1:].numpy()
    f32 = f32[:, :, 1:, 1:]
    top2 = f32.topk(2, dim=1).values
    decisive = ((top2[:, 0] - top2[:, 1])
                > 0.01 * float(f32.abs().max())).numpy()
    assert decisive.mean() > 0.8 and len(np.unique(want)) > 1
    agree = float((ids == want)[decisive].mean())
    f32_ids = f32.argmax(1).numpy()
    print("folded bf16 labeler: ids agree with the unfused bf16 forward's "
          "on %.5f of the decisive pixels (%.5f of all); with the f32 "
          "argmax on %.5f of all pixels, the unfused route on %.5f"
          % (agree, float((ids == want).mean()),
             float((ids == f32_ids).mean()), float((want == f32_ids).mean())))
    assert agree >= 0.99
    assert float((ids == f32_ids)[decisive].mean()) >= 0.99
    # the fold takes bf16 roundings away (the scale's, BN's intermediate)
    # and adds none: its grid logits lie no farther from the f32 grid's
    # than the unfused route's, over all pixels
    with torch.inference_mode():
        grids = [tx.teacher_logits_nchw(q, padded, out_hw=None,
                                        compute_dtype=torch.bfloat16,
                                        config=config).float()
                 for q in (p, tx.fold_teacher(p, torch.bfloat16))]
        grid32 = tx.teacher_logits_nchw(p, padded, out_hw=None,
                                        config=config)
    unfused_err, folded_err = (float((g - grid32).norm() / grid32.norm())
                               for g in grids)
    print("grid logits' relative error against f32: folded %.5f, unfused "
          "%.5f" % (folded_err, unfused_err))
    assert folded_err <= unfused_err
    lab.make_teacher_labeler(path, compute_dtype="float32", batch=2,
                             device="cpu", teacher_config=config)
    assert folds == [torch.bfloat16]        # float32 stays unfolded


@pytest.mark.parametrize("config", FOLD_CONFIGS, ids=FOLD_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bn_counters_cover_every_site(fold_cases, global_timer, config,
                                      dtype):
    """One count per BN site and forward, as an epilogue or as a pass; in
    bf16 the CPU takes the card's routes (the dilated kernel's plain
    version adds its epilogue), so the split is the card's."""
    p, raw = fold_cases[config]
    folded = tx.fold_teacher(p, dtype)
    with torch.inference_mode():
        for _ in range(2):
            tx.teacher_logits_nchw(folded, pad_like_ams(raw), out_hw=None,
                                   compute_dtype=dtype, config=config)
    fused = global_timer.counts["teacher/bn_epilogue"]
    passes = global_timer.counts["teacher/bn_pass"]
    assert fused + passes == 2 * sum(BN_SPLIT[config])
    if dtype == torch.bfloat16:
        assert (fused, passes) == tuple(2 * n for n in BN_SPLIT[config])
