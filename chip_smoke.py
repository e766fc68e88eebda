#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ams_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at the real student's full width
(MobileNetV2-DeepLabV3, 19 logits) from seeded random weights: the
deployed edge client's serving path (512x1024 frames, batch 8) and the
server's distillation events (256x512 frames, minibatch 10, 200
iterations of coord_desc_auto), and checks each kernel of the paths on
the card:

0. device line (name, power limit, torch and CUDA versions); a watchdog
   turns a hang into a traceback and a non-zero exit;
1. builds the kernels from ams_tpu_torch/csrc with nvcc (all in parallel);
2. holds each kernel against its plain PyTorch version at the paths'
   shapes, by CUDA events per call and on the device by torch.profiler,
   beside the plain version and the nearest library call (resize+argmax
   at eight shapes, f32 NCHW and bf16 channels-last with a class table,
   each run twice for the same bits; resize+CE, loss only and loss with
   gradient, up to 256 classes; the fused MBConv block through K3's and
   K4's wrappers, against the unfused bf16 block);
3. the f32 client path, with every launch counter set to 0 just before it:
   predict_input on full-class and class-subset clients, delta apply on the
   float16 and int8d wires, predict again, BN-folded export, reload,
   predict_input and per-frame scoring on the folded client; plus a small
   input held against the port's own CPU forward;
4. the server path, with every launch counter set to 0 just before it:
   two events of restore_initial -> train_with_deque (fused resize+CE
   loss) -> encode_delta (float16, then int8d) -> apply_downlink on an
   unfolded client -> predict_input, with the round's invariants checked,
   then the trained student's loss on the memory without a gradient
   (the loss-only kernel) against the gather loss; plus one iteration of
   the fused loss against the gather loss, the device time per iteration
   of both, a small round held against the port's own CPU round, and a
   profile of one iteration;
5. the bf16 folded client path, with every launch counter set to 0 just
   before it: the facade in bf16 (predict, a float16 delta, fold, reload,
   predict and score), then the folded fast path with unfused, fused (K3)
   and banded (K4) blocks, held against the unfused bf16 ids and the f32
   client's, with each variant's launches per forward and frames/s; and
   the kernels of five fast forwards (folded and unfolded, bf16 and f32)
   in launch order, checked to run K1 straight after the forward's last
   kernel, with no cast, gather or copy between;
6. the emulated experiment, with every launch counter set to 0 just
   before each run: a bands clip written as a frame directory (8 s of
   512x1024 frames at 10 fps, exp 90), then `python -m
   ams_tpu_torch.cli.run` with run.py's defaults and --mode early
   (cutoff 6 s: one training event of 200 iterations) and --mode
   pretrained, on the card; every artifact checked, one update, the uplink
   and downlink bits above 0, finite per-frame scores, no kernel launched
   (the JAX package's routing: the client keeps its logits, the round uses
   the gather loss), the card's client against the CPU client on the same
   artifacts, and the PNG bytes of two probe images against OpenCV's (the
   card's zlib); with the spans of both runs, decode's share of each loop,
   the client's frames/s and both runs' mIoU;
7. one JSON line of kernel numbers, the wall-clock, and as the last line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.  It imports nothing
of JAX or of ams_tpu.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

BUDGET_S = 1100          # the watchdog: well inside the 1200 s limit
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 peak outside tensor cores
BF16_MMA_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
TIE_MARGIN = 1e-5        # top-2 margin below which ids may differ
SEED = 0
B, H, W = 8, 512, 1024   # the client's batch and frame size
ODD_HW = (511, 1023)     # frames whose stem grid (256x512) is even
SUBSET_EXP = 25          # Cityscapes-Frankfurt: 6 of the 19 classes
# the server's distillation round: run.py's defaults
SH, SW = 256, 512        # server frames (run.py --height 256)
MEMORY = 64              # frames in the server's memory
MINI_BATCH = 10          # run.py --batch_size
ROUND_ITERS = 200        # run.py --iter
LR = 1e-3                # run.py --lr
COORD_FRAC = 0.1         # run.py --coord_fraction
# the emulated experiment (phase 6): run.py's defaults, one training event
EXP_CLIP = "90-bands"     # exp 90: 8 s registered length, 5 of 19 classes
EXP_FPS, EXP_HW = 10, (512, 1024)   # frames 2x the --height 256 grid
EXP_CUTOFF = 6           # --early_cutoff_time: events at seconds 0 and 6
# sizes and SHA-256 of cv2.imencode(".png", ·) of png_probe_images(), as
# tests/test_torch_data.py records them from OpenCV: the card's zlib must
# reproduce them for the uplink's bits to be cv2's
PNG_PROBE = {
    "frame": (195584, "9d979909ad33c35e1217cb93b33da02c"
                      "102723114117a8e7da00d184ade90298"),
    "label": (11736, "bc62c4cf6b59a0c24f4342326eeecc4a"
                     "a52811ef5daa64603e36a39c18e9f1f4"),
}


def reset_counters():
    """Every kernel wrapper's launch count to 0."""
    from ams_tpu_torch.ops import fused_mbconv as fm
    from ams_tpu_torch.ops import fused_mbconv_banded as fb
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc

    fra.fused_resize_argmax.launches = 0
    frc.resize_ce_loss.launches = frc.resize_ce_loss_grad.launches = 0
    fm.mbconv_block.launches = fb.mbconv_banded.launches = 0


def launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    from ams_tpu_torch.ops import fused_mbconv as fm
    from ams_tpu_torch.ops import fused_mbconv_banded as fb
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc

    return {"resize_argmax": fra.fused_resize_argmax.launches,
            "resize_ce_loss": frc.resize_ce_loss.launches,
            "resize_ce_loss_grad": frc.resize_ce_loss_grad.launches,
            "mbconv": fm.mbconv_block.launches,
            "mbconv_banded": fb.mbconv_banded.launches}


def expected_mbconv_launches(h, w, banded_min_hw=96 * 96):
    """(K3, K4) launches of one folded forward of (h, w) frames, from the
    routing rules: fused_blocks=True fuses every stride-1 block;
    "banded" fuses each block whose input area reaches banded_min_hw and
    whose geometry banded_supported accepts."""
    from ams_tpu_torch.models.mobilenetv2_deeplab import _BLOCKS
    from ams_tpu_torch.ops.fused_mbconv_banded import banded_supported

    gh, gw = -(-(h + 1) // 2), -(-(w + 1) // 2)      # +1 pad, stem stride 2
    k3 = k4 = 0
    for _, _, stride, rate in _BLOCKS:
        k3 += stride == 1
        k4 += (gh * gw >= banded_min_hw
               and banded_supported(gh, gw, stride, rate))
        gh, gw = -(-gh // stride), -(-gw // stride)
    return k3, k4


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi unavailable: %s" % e
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else \
        "nvidia-smi failed: rc %d" % r.returncode


def synthetic_frames(n, h, w, seed):
    """Seeded uint8 frames with structure (low-frequency sinusoids plus
    noise): random pixels average out in the trunk and give one class."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((n, h, w, 3), 128.0, np.float32)
    for i in range(n):
        for c in range(3):
            for _ in range(4):
                fy, fx = rng.uniform(0.5, 6, 2) / np.array([h, w])
                phase = rng.uniform(0, 2 * np.pi)
                out[i, :, :, c] += rng.uniform(20, 60) * np.sin(
                    2 * np.pi * (fy * yy + fx * xx) + phase)
    out += rng.randn(*out.shape).astype(np.float32) * 8
    return np.clip(out, 0, 255).astype(np.uint8)


def calibrate_bn(params, frames):
    """Set every moving statistic to the batch moments of ``frames`` (one
    forward with batch-statistics BN), so seeded random weights give
    activations of a trained network's scale.  Synthetic init leaves the
    statistics at (0, 1), under which the logits of 17 random blocks
    vanish and every pixel ties."""
    import torch
    from ams_tpu_torch.models import layers
    from ams_tpu_torch.models.mobilenetv2_deeplab import student_logits

    infer = layers.batch_norm_infer

    def batch_stats_bn(x, gamma, beta, mean, var, eps=layers.BN_EPS):
        mean.copy_(x.mean(dim=(0, 2, 3)))
        var.copy_(x.var(dim=(0, 2, 3)))
        return infer(x, gamma, beta, mean, var, eps)

    layers.batch_norm_infer = batch_stats_bn
    try:
        with torch.no_grad():
            student_logits(params, frames)
    finally:
        layers.batch_norm_infer = infer


def cuda_ms(fn, iters):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs
    after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device time per call of ``fn``: the CUDA kernels' durations
    summed by torch.profiler over ``iters`` calls after one warm-up,
    without the idle gaps between launches that ``cuda_ms`` counts when
    the host cannot keep up with a short kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # torch.profiler has come back empty on the card now and then: a
    # profile without device time is taken again, up to three in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total
                       for e in prof.key_averages())
        if total_us > 0:
            return total_us / 1e3 / iters
        log("  torch.profiler recorded no device time; profiling again")
    check(False, "torch.profiler recorded no device time in 3 profiles")


def device_breakdown(fn, top=8):
    """Device time of one ``fn()`` call by kernel name (torch.profiler),
    as printable lines, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()]
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    lines = ["device total %.3f ms in %d kernel names"
             % (total / 1e3, len(rows))]
    lines += ["%6.2f%% %9.3f ms x%-4d %s" % (100 * t / max(total, 1e-9),
                                             t / 1e3, n, k[:90])
              for k, t, n in rows[:top]]
    return lines


def near_ties(grid, out_hw):
    """(B, H, W) bool: top-2 margin of the full-resolution logits below
    TIE_MARGIN, where two correct argmaxes may differ."""
    import torch
    from ams_tpu_torch.models.resize import resize_nchw

    full = resize_nchw(grid, out_hw)
    if full.shape[1] < 2:             # one class: no ties
        return torch.zeros_like(full[:, 0], dtype=torch.bool)
    top2 = torch.topk(full, 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < TIE_MARGIN


def resize_argmax_bound_ms(b, c, gh, gw, h, w, elem_bytes=4):
    """Least time for the function on an H100 SXM: each input read once
    (the ``c`` class planes the argmax reads, of ``elem_bytes`` each, and
    the lerp tables) and each output written once, over 3.35 TB/s; or the
    operations of the separable lerp (a horizontal lerp per grid row and
    class, a vertical lerp per pixel and class, 3 ops each) plus one
    compare per pixel and class, over 67 TFLOP/s f32.  The larger one
    bounds."""
    nbytes = b * c * gh * gw * elem_bytes + b * h * w * 4 \
        + (3 * h + 3 * w) * 4
    ops = 3 * b * c * (gh * w + h * w) + b * c * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def resize_argmax_plan_line(plan, b):
    """One line on how K1's plan cuts a shape: blocks, threads, tiles and
    the rows of its band runs (runs of equal counts written once with
    their length)."""
    import itertools

    rows = [int(r) for r in plan.bands[:, 3] - plan.bands[:, 2]]
    counted = [(k, len(list(g))) for k, g in itertools.groupby(rows)]
    return ("%d blocks (%d tiles x %d band runs x %d images) of %d threads;"
            " rows per run %s" % (
                plan.blocks(b), plan.n_tiles, len(plan.bands), b,
                plan.threads, ", ".join("%d x%d" % (k, n) if n > 1
                                        else str(k) for k, n in counted)))


def phase_kernel_checks(dev):
    """Phase 2, K1: the resize+argmax kernel against its plain version at
    the client's shapes (f32 NCHW as the f32 forward leaves it; bf16
    channels-last with the exp-25 class table, as the bf16 folded forward
    hands it over) and at the edges of its plan (96 classes, past the 32
    held in registers; one class; an output below the grid; W=1); each
    case run twice for the same bits, and timed per call by CUDA events
    (``ms``) and on the device by torch.profiler (``device_ms``) beside
    the plain version, the library call and the bound."""
    import torch
    import torch.nn.functional as F
    from ams_tpu_torch import configs
    from ams_tpu_torch.ops import fused_resize_argmax as fra

    f32, bf16 = torch.float32, torch.bfloat16
    exp_ci = tuple(int(k) for k in configs.class_indices(SUBSET_EXP))
    # (label, (b, c, gh, gw, h, w), dtype, channels-last, class index)
    cases = [("client, 19 classes", (B, 19, 33, 65, H, W), f32, False,
              None),
             ("client, exp %d subset" % SUBSET_EXP, (B, 6, 33, 65, H, W),
              f32, False, None),
             ("ragged", (3, 7, 17, 33, 257, 513), f32, False, None),
             ("bf16 channels-last, exp %d class table" % SUBSET_EXP,
              (B, 19, 33, 65, H, W), bf16, True, exp_ci),
             ("96 classes, above the register bound",
              (2, 96, 33, 65, H, W), f32, False, None),
             ("one class", (2, 1, 33, 65, H, W), f32, False, None),
             ("output below the grid", (2, 19, 33, 65, 16, 32), f32, False,
              None),
             ("W=1", (2, 7, 17, 33, 257, 1), f32, False, None)]
    gen = torch.Generator().manual_seed(SEED)
    out = []
    for label, (b, c, gh, gw, h, w), dtype, cl, ci in cases:
        grid = (torch.randn(b, c, gh, gw, generator=gen) * 3).to(dev) \
            .to(dtype)
        if cl:
            grid = grid.contiguous(memory_format=torch.channels_last)
        plan = fra.resize_argmax_plan(gh, gw, h, w)
        log("  resize_argmax %s plan: %s"
            % (label, resize_argmax_plan_line(plan, b)))
        ci_t = None if ci is None else torch.tensor(ci, device=dev)
        sel = grid.float()
        if ci is not None:
            sel = sel.index_select(1, ci_t)
        n_sel = sel.shape[1]

        def kernel():
            return fra.fused_resize_argmax(grid, (h, w), ci)

        def plain():
            return fra.resize_argmax_plain(grid, (h, w), ci)

        def library():
            g = grid.float()
            if ci is not None:
                g = g.index_select(1, ci_t)
            return F.interpolate(g, size=(h, w), mode="bilinear",
                                 align_corners=True).argmax(1)

        n0 = fra.fused_resize_argmax.launches
        got, got2 = kernel(), kernel()
        want = plain()
        torch.cuda.synchronize()
        check(fra.fused_resize_argmax.launches == n0 + 2,
              "resize_argmax: two calls launched %d kernels in case %s"
              % (fra.fused_resize_argmax.launches - n0, label))
        check(got.shape == (b, h, w) and got.dtype == torch.int32,
              "resize_argmax %s: ids %s %s" % (label, tuple(got.shape),
                                               got.dtype))
        ties = near_ties(sel, (h, w))
        diff = got != want
        mism, off = int(diff.sum()), int((diff & ~ties).sum())
        max_err = int((got.long() - want.long()).abs().max())
        same_bits = bool(torch.equal(got, got2))
        times = {}
        for name, fn, n in (("kernel", kernel, 100), ("plain", plain, 10),
                            ("library", library, 10)):
            times[name] = (cuda_ms(fn, n), device_ms(fn, n))
        bound, bound_by = resize_argmax_bound_ms(
            b, n_sel, gh, gw, h, w, grid.element_size())
        row = {"case": label, "shape": [b, c, gh, gw, h, w],
               "dtype": str(dtype).replace("torch.", ""),
               "channels_last": cl, "classes": n_sel,
               "plan": {"blocks": plan.blocks(b), "threads": plan.threads,
                        "tiles": plan.n_tiles, "band_runs": len(plan.bands)},
               "mismatches": mism, "mismatches_off_ties": off,
               "near_tie_pixels": int(ties.sum()), "max_abs_err": max_err,
               "same_bits": same_bits,
               "kernel_ms": times["kernel"][0],
               "device_ms": times["kernel"][1],
               "plain_ms": times["plain"][0],
               "plain_device_ms": times["plain"][1],
               "library_ms": times["library"][0],
               "library_device_ms": times["library"][1],
               "bound_ms": bound, "bound_by": bound_by}
        log("  resize_argmax %s %s %s%s: mismatches %d (off ties %d, "
            "near-tie pixels %d); same bits on rerun %s"
            % (label, row["shape"], row["dtype"],
               " channels-last" if cl else "", mism, off,
               row["near_tie_pixels"], same_bits))
        log("    ms per call by events / on the device: kernel %.4f / %.4f, "
            "plain %.4f / %.4f, library %.4f / %.4f, bound %.4f (%s)"
            % (times["kernel"] + times["plain"] + times["library"]
               + (bound, bound_by)))
        check(off == 0, "resize_argmax disagrees with its plain version off "
              "ties in case %s: %d pixels" % (label, off))
        check(same_bits, "resize_argmax: two runs differ in case %s" % label)
        out.append(row)
    return out


def kernels_in_order(fn):
    """The device kernels of one ``fn()`` call in launch order
    (torch.profiler), after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(events, "torch.profiler recorded no device kernels")
    events.sort(key=lambda e: e.time_range.start)
    return [e.name for e in events]


def phase_main_path(dev):
    """Phase 3: the edge client's serving path at full width."""
    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
    from ams_tpu_torch.models.mobilenetv2_deeplab import (
        grid_logits_nchw,
        init_student_params,
        student_logits,
        trainable_names,
    )
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.stream.codec import (
        apply_delta,
        decode_delta,
        encode_delta,
        payload_bits,
    )

    def plain_ids(net, staged):
        """Card forward + the plain resize-argmax, and its near ties."""
        with torch.inference_mode():
            grid = grid_logits_nchw(net.params, staged)
            ci = torch.as_tensor(net._class_indices, device=dev)
            grid = grid.index_select(1, ci).contiguous()
            return (fra.resize_argmax_plain(grid, (H, W)).cpu().numpy(),
                    near_ties(grid, (H, W)).cpu().numpy())

    def check_ids(label, ids, net, staged):
        want, ties = plain_ids(net, staged)
        check(ids.shape == (B, H, W) and ids.dtype == np.int32,
              "%s: ids %s %s" % (label, ids.shape, ids.dtype))
        off = int(((ids != want) & ~ties).sum())
        log("  %s: ids vs card forward + plain resize-argmax: %d differ "
            "(%d off ties, %d near-tie pixels); classes present %s"
            % (label, int((ids != want).sum()), off, int(ties.sum()),
               np.unique(ids).tolist()))
        check(off == 0, "%s: %d ids differ off ties" % (label, off))

    frames = synthetic_frames(B, H, W, SEED)
    staged = torch.from_numpy(frames).to(dev)
    params = init_student_params(SEED, device=dev)
    calibrate_bn(params, torch.from_numpy(
        synthetic_frames(B, H, W, SEED + 1)).to(dev))
    host = params_to_numpy(params)
    n_train = sum(host[k].size for k in trainable_names(host))
    log("  student: %d tensors, %d trainable coordinates" % (len(host),
                                                             n_train))

    # a small input against the port's own CPU forward: the card's f32
    # convolutions (TF32 off) agree with the CPU's to f32 summation noise
    small = torch.from_numpy(synthetic_frames(2, 64, 128, SEED + 2))
    with torch.inference_mode():
        ref = student_logits(params_from_numpy(host, "cpu"), small)
        got = student_logits(params, small.to(dev)).cpu()
    err = float((got - ref).abs().max())
    log("  small input (2x64x128) card vs CPU logits: max abs err %.3g "
        "(|logits| up to %.3g)" % (err, float(ref.abs().max())))
    check(err < 1e-3, "card logits differ from CPU logits by %g" % err)

    kw = dict(height=H, frozen=True, device=dev)
    full = SemanticNetwork(host, configs.class_weights(0), **kw)
    sub = SemanticNetwork(host, configs.class_weights(SUBSET_EXP), **kw)
    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_")
    try:
        reset_counters()
        t0 = time.perf_counter()
        ids_full = full.predict_input(frames)
        ids_sub = sub.predict_input(frames)
        log("  first predict_input x2: %.3f s" % (time.perf_counter() - t0))
        check(fra.fused_resize_argmax.launches == 2,
              "predict_input did not launch the kernel")
        check_ids("full-class client", ids_full, full, staged)
        check_ids("exp %d client" % SUBSET_EXP, ids_sub, sub, staged)
        ids_first = ids_sub

        n_rep = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_rep):
            sub.predict_input(frames)
        host_fps = n_rep * B / (time.perf_counter() - t0)
        dev_ms = cuda_ms(lambda: sub._fast(sub.params, staged,
                                           sub._class_indices), n_rep)
        log("  predict_input: %.1f frames/s end to end (uint8 frames in, "
            "ids out); device forward+kernel %.2f ms per batch of %d = "
            "%.1f frames/s" % (host_fps, dev_ms, B, B * 1e3 / dev_ms))
        log("  where the device time of one unfolded predict goes "
            "(torch.profiler):")
        try:
            lines = device_breakdown(lambda: sub._fast(
                sub.params, staged, sub._class_indices))
        except (RuntimeError, AssertionError) as e:  # informational only
            lines = ["profiler unavailable: %s" % e]
        for line in lines:
            log("    " + line)

        # a coord_desc_auto-style delta: 10% of the trainables moved
        rng = np.random.RandomState(SEED + 3)
        masks = {k: rng.rand(*host[k].shape) < 0.1
                 for k in trainable_names(host)}
        moved = dict(host)
        for k, m in masks.items():
            step = rng.randn(*host[k].shape).astype(np.float32) * 0.01
            moved[k] = np.where(m, host[k] + step, host[k])
        stats = {k: v * np.float32(1.01) for k, v in host.items()
                 if "moving_" in k}
        shapes = {k: v.shape for k, v in host.items()}
        for wire, base_initial in (("float16", False), ("int8d", True)):
            blob = encode_delta(moved, masks, strategy="coord_desc_auto",
                                wire_dtype=wire, stats=stats,
                                base=host if wire == "int8d" else None)
            before = sub.get_vars()
            target = host if base_initial else before
            dm, dv = decode_delta(blob, shapes, strategy="coord_desc_auto",
                                  wire_dtype=wire,
                                  base=host if wire == "int8d" else None)
            want = apply_delta(target, dm, dv)
            sub.apply_downlink(blob, strategy="coord_desc_auto",
                               wire_dtype=wire, base_initial=base_initial)
            after = sub.get_vars()
            bad = [k for k in want if not np.array_equal(after[k], want[k])]
            changed = sum(int((after[k] != host[k]).sum()) for k in after)
            log("  apply_downlink %s (%d B, %d bits): %d coordinates "
                "differ from the initial weights; %d tensors differ from the "
                "host apply_delta" % (wire, len(blob), payload_bits(blob),
                                      changed, len(bad)))
            check(not bad, "apply_downlink %s differs from the host "
                  "apply_delta in %s" % (wire, bad[:3]))
            check(changed > 0, "apply_downlink %s changed nothing" % wire)
            ids_sub = sub.predict_input(frames)
            check_ids("exp %d client after %s delta" % (SUBSET_EXP, wire),
                      ids_sub, sub, staged)

        path = os.path.join(tmp, "client")
        sub.save_to_frozen_graph(path, fold=True)
        folded = SemanticNetwork(path + ".npz",
                                 configs.class_weights(SUBSET_EXP), **kw)
        check(folded._folded, "the reloaded artifact is not folded")
        ids_fold = folded.predict_input(frames)
        agree = float((ids_fold == ids_sub).mean())
        log("  folded client: ids agree with the unfolded client on %.6f "
            "of pixels (folding reassociates f32)" % agree)
        check(agree > 0.99, "folded client agrees on only %.4f" % agree)

        # teacher labels: the exp-25 client's first ids in the full id
        # space, so the scores measure how far the deltas moved it
        teacher = configs.class_indices(SUBSET_EXP)[ids_first]
        f_ids, f_cms, f_mious, f_losses = folded.predict_with_metric_seq(
            frames, teacher)
        u_ids, u_cms, u_mious, u_losses = sub.predict_with_metric_seq(
            frames, teacher)
        n_sel = len(configs.class_indices(SUBSET_EXP))
        check(f_cms.shape == (B, n_sel, n_sel) and f_losses.shape == (B,),
              "scoring shapes %s %s" % (f_cms.shape, f_losses.shape))
        check(np.isfinite(f_losses).all() and np.isfinite(u_losses).all(),
              "non-finite scoring losses")
        check(f_cms.sum() == u_cms.sum(), "confusion-matrix mass differs")
        rel = float(np.max(np.abs(f_losses - u_losses) /
                           np.maximum(np.abs(u_losses), 1e-6)))
        log("  predict_with_metric_seq: folded mIoU %s, losses %s; max "
            "relative loss gap to the unfolded client %.3g"
            % (np.round(f_mious, 4).tolist(), np.round(f_losses, 4).tolist(),
               rel))
        check(rel < 1e-3, "folded vs unfolded losses differ by %g" % rel)
        launches = fra.fused_resize_argmax.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  kernel launches on the main path: resize_argmax %d" % launches)
    check(launches > 0, "resize_argmax was not launched on the main path")
    return {"resize_argmax": launches}, host_fps, B * 1e3 / dev_ms, host


def resize_ce_bound_ms(b, c, gh, gw, h, w, backward=False):
    """Least time for the fused resize+CE on an H100 SXM: each input read
    once and each output written once (the grid, int32 labels, f32
    weights; the scalar loss, or with ``backward`` also the grid gradient)
    over 3.35 TB/s; or the operations over 67 TFLOP/s f32: the separable
    lerp (3 ops per grid-row sample and per pixel, each class) and
    max/subtract/exp/add per pixel and class, plus log and the masked sums
    per pixel; with ``backward`` (loss and gradient) also the softmax
    gradient (3 per pixel and class) and the transposed separable lerp (4
    per pixel and class, 4 per output row, grid column and class).  The
    larger one bounds."""
    grid = b * c * gh * gw * 4
    nbytes = grid + 2 * b * h * w * 4 + (grid if backward else 8)
    ops = 3 * b * c * (gh * w + h * w) + 4 * b * c * h * w + 5 * b * h * w
    if backward:
        ops += 3 * b * c * h * w + 4 * b * c * h * w + 4 * b * c * h * gw
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def resize_ce_plan_line(plan, b, smem):
    """One line on how K2's plan cuts a shape: blocks, threads, shared
    memory (``smem``: the kernel's bytes per block, loss and loss+grad),
    rows per band and columns per tile (runs of equal counts written once
    with their length)."""
    import itertools

    import numpy as np

    def runs(a):
        counted = [(k, len(list(g))) for k, g in itertools.groupby(a)]
        return ", ".join("%d x%d" % (k, n) if n > 1 else str(k)
                         for k, n in counted)

    return ("%d blocks (%d images x %d bands x %d tiles) of %d threads; "
            "shared memory %d B (loss) / %d B (loss+grad); rows per band "
            "%s; columns per tile %s"
            % (plan.blocks(b), b, len(plan.bands), len(plan.tiles),
               plan.threads, smem[0], smem[1],
               runs(np.diff(plan.bands, axis=1)[:, 0]),
               runs(np.diff(plan.tiles[:, 2:4], axis=1)[:, 0])))


def phase_resize_ce_checks(dev):
    """Phase 2, K2: the fused resize+CE kernel, loss only and loss with
    gradient, against the plain version, and their times beside the plain
    version's, the library's and the bounds."""
    import torch
    import torch.nn.functional as F
    from ams_tpu_torch.ops import fused_resize_ce as frc

    smem_fn = frc.library().resize_ce_smem_bytes
    cases = [("server round, 19 classes", (10, 19, 17, 33, SH, SW), 0.8),
             ("server round, exp %d subset" % SUBSET_EXP,
              (10, 6, 17, 33, SH, SW), 0.8),
             ("ragged, odd height", (3, 7, 5, 9, 65, 128), 0.8),
             ("all pixels invalid", (10, 19, 17, 33, SH, SW), 0.0),
             ("output below the grid", (2, 19, 33, 65, 16, 32), 0.8),
             ("wide", (2, 21, 65, 129, 512, 2048), 0.8),
             ("96 classes, above the register bound",
              (2, 96, 17, 33, SH, SW), 0.8),
             ("256 classes, a smaller plan", (1, 256, 17, 33, SH, SW), 0.8)]
    gen = torch.Generator().manual_seed(SEED + 7)
    out = []
    for label, (b, c, gh, gw, h, w), p_valid in cases:
        grid = (torch.randn(b, c, gh, gw, generator=gen) * 3).to(dev)
        labels = torch.randint(0, c, (b, h, w), generator=gen,
                               dtype=torch.int32).to(dev)
        weights = (torch.rand(b, h, w, generator=gen) < p_valid).float() \
            .to(dev)
        plan = frc.card_plan(c, gh, gw, h, w, grid.device.index)
        smem = [smem_fn(c, plan.threads, plan.ncol_max, want_grad)
                for want_grad in (0, 1)]
        log("  resize_ce %s plan: %s" % (label,
                                         resize_ce_plan_line(plan, b, smem)))

        def kernel_pair():
            g = grid.clone().requires_grad_(True)
            loss = frc.fused_resize_ce(g, labels, weights, (h, w))
            return loss.detach(), torch.autograd.grad(loss, g)[0]

        def plain_pair():
            g = grid.clone().requires_grad_(True)
            loss = frc.resize_ce_plain(g, labels, weights, (h, w))
            return loss.detach(), torch.autograd.grad(loss, g)[0]

        def library_loss(g):
            full = F.interpolate(g, size=(h, w), mode="bilinear",
                                 align_corners=True)
            ce = F.cross_entropy(full, labels.long(), reduction="none")
            return torch.sum(ce * weights) / torch.clamp(torch.sum(weights),
                                                         min=1.0)

        def library_pair():
            g = grid.clone().requires_grad_(True)
            return torch.autograd.grad(library_loss(g), g)[0]

        n0 = (frc.resize_ce_loss.launches, frc.resize_ce_loss_grad.launches)
        k_loss, k_grad = kernel_pair()
        k_loss2, k_grad2 = kernel_pair()
        with torch.no_grad():
            only = frc.fused_resize_ce(grid, labels, weights, (h, w))
            only2 = frc.fused_resize_ce(grid, labels, weights, (h, w))
        n1 = (frc.resize_ce_loss.launches, frc.resize_ce_loss_grad.launches)
        p_loss, p_grad = plain_pair()
        torch.cuda.synchronize()
        check(n1 == (n0[0] + 2, n0[1] + 2),
              "resize_ce: two calls under grad and two under no_grad "
              "launched %d loss and %d loss+grad kernels in case %s"
              % (n1[0] - n0[0], n1[1] - n0[1], label))
        same_bits = bool(torch.equal(k_loss, k_loss2)
                         and torch.equal(k_grad, k_grad2)
                         and torch.equal(only, only2)
                         and torch.equal(only, k_loss))
        loss_err = float((k_loss - p_loss).abs())
        grad_err = float((k_grad - p_grad).abs().max())
        grad_ok = bool(torch.allclose(k_grad, p_grad, rtol=1e-4, atol=1e-6))
        check(same_bits, "resize_ce: two runs differ in case %s" % label)
        if p_valid == 0.0:
            check(float(k_loss) == 0.0 and float(k_grad.abs().max()) == 0.0,
                  "resize_ce: all-invalid case gives loss %r, grad max %r"
                  % (float(k_loss), float(k_grad.abs().max())))
        check(loss_err <= 1e-5 * abs(float(p_loss)),
              "resize_ce loss %r vs plain %r in case %s"
              % (float(k_loss), float(p_loss), label))
        check(grad_ok, "resize_ce gradient differs from the plain version's "
              "in case %s: max abs err %g" % (label, grad_err))

        def loss_only():
            return frc.resize_ce_loss(grid, labels, weights, (h, w))

        def loss_grad():
            return frc.resize_ce_loss_grad(grid, labels, weights, (h, w))

        def plain_loss():
            return frc.resize_ce_plain(grid, labels, weights, (h, w))

        # per call by CUDA events over back-to-back calls, as every kernel
        # of the kernels line is timed (host-bound for a short kernel); and
        # the kernels' own time on the device by the profiler
        times = {}
        with torch.no_grad():
            lib_err = float((library_loss(grid) - p_loss).abs())
            for name, fn, n in (("loss", loss_only, 50),
                                ("loss_plain", plain_loss, 10),
                                ("loss_library", lambda: library_loss(grid),
                                 10),
                                ("loss_grad", loss_grad, 50)):
                times[name] = (cuda_ms(fn, n), device_ms(fn, n))
        for name, fn, n in (("loss_grad_plain", plain_pair, 10),
                            ("loss_grad_library", library_pair, 10),
                            ("loss_grad_autograd", kernel_pair, 50)):
            times[name] = (cuda_ms(fn, n), device_ms(fn, n))
        lb, lby = resize_ce_bound_ms(b, c, gh, gw, h, w)
        gb, gby = resize_ce_bound_ms(b, c, gh, gw, h, w, backward=True)
        row = {"case": label, "shape": [b, c, gh, gw, h, w],
               "plan": {"blocks": plan.blocks(b), "threads": plan.threads,
                        "tiles": len(plan.tiles),
                        "smem_bytes": smem[1]},
               "loss": float(k_loss), "loss_abs_err": loss_err,
               "grad_max_abs_err": grad_err, "same_bits": same_bits,
               "library_loss_abs_err": lib_err,
               "loss_bound_ms": lb, "loss_bound_by": lby,
               "loss_grad_bound_ms": gb, "loss_grad_bound_by": gby}
        for name, (call_t, dev_t) in times.items():
            row[name + "_ms"] = call_t
            row[name + "_device_ms"] = dev_t
        log("  resize_ce %s %s: loss %.6f (err %.3g), grad max err %.3g, "
            "same bits on rerun %s; library loss err %.3g"
            % (label, row["shape"], float(k_loss), loss_err, grad_err,
               same_bits, lib_err))
        log("    ms per call by events / on the device: loss kernel %.4f / "
            "%.4f, plain %.4f / %.4f, library %.4f / %.4f, bound %.4f (%s); "
            "loss+grad kernel %.4f / %.4f (through autograd %.4f / %.4f), "
            "plain %.4f / %.4f, library %.4f / %.4f, bound %.4f (%s)"
            % (times["loss"] + times["loss_plain"] + times["loss_library"]
               + (lb, lby) + times["loss_grad"] + times["loss_grad_autograd"]
               + times["loss_grad_plain"] + times["loss_grad_library"]
               + (gb, gby)))
        out.append(row)
    return out


def mbconv_bound_ms(b, cin, cmid, cout, h, w, ho, wo, has_expand,
                    residual):
    """Least time for one fused MBConv block in bf16 on an H100 SXM: the
    input and output (bf16) and the weights (bf16 1x1, f32 depthwise and
    biases) each moved once over 3.35 TB/s; or the two 1x1 products over
    989 TFLOP/s (bf16 tensor cores) plus the depthwise taps and the
    elementwise work (bias and relu6 on the mid tensor twice, bias and
    residual on the output) over 67 TFLOP/s f32.  The larger one
    bounds."""
    nbytes = 2 * (b * cin * h * w + b * cout * ho * wo) \
        + 2 * (cin * cmid * has_expand + cmid * cout) \
        + 4 * (9 * cmid + cmid * (1 + has_expand) + cout)
    mma = 2 * b * h * w * cin * cmid * has_expand \
        + 2 * b * ho * wo * cmid * cout
    other = 3 * b * h * w * cmid * has_expand + 2 * 9 * b * ho * wo * cmid \
        + 3 * b * ho * wo * cmid + b * ho * wo * cout * (1 + residual)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = mma / BF16_MMA_OPS_PER_S + other / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# every block of the student at the 512x1024 forward: (name, cin, cmid,
# cout, stride, rate, input grid)
STUDENT_BLOCKS = (
    ("expanded_conv", 32, 32, 16, 1, 1, (257, 513)),
    ("expanded_conv_1", 16, 96, 24, 2, 1, (257, 513)),
    ("expanded_conv_2", 24, 144, 24, 1, 1, (129, 257)),
    ("expanded_conv_3", 24, 144, 32, 2, 1, (129, 257)),
    ("expanded_conv_4", 32, 192, 32, 1, 1, (65, 129)),
    ("expanded_conv_6", 32, 192, 64, 2, 1, (65, 129)),
    ("expanded_conv_7", 64, 384, 64, 1, 1, (33, 65)),
    ("expanded_conv_10", 64, 384, 96, 1, 1, (33, 65)),
    ("expanded_conv_11", 96, 576, 96, 1, 1, (33, 65)),
    ("expanded_conv_13", 96, 576, 160, 1, 1, (33, 65)),
    ("expanded_conv_14", 160, 960, 160, 1, 2, (33, 65)),
    ("expanded_conv_16", 160, 960, 320, 1, 2, (33, 65)),
)


def mbconv_inputs(dev, gen, b, cin, cmid, cout, h, w):
    """Seeded bf16 channels-last input and weights of one block, as
    ``FusedBlock`` holds them: (x, (w_expand, b_expand, w_dw, b_dw,
    w_proj, b_proj)).  The launcher packs the weights at the first call
    and reuses them after (``fused_mbconv.packed_weights``)."""
    import torch

    bf16 = torch.bfloat16
    he = cin != cmid
    x = torch.randn(b, cin, h, w, generator=gen).to(dev, bf16) \
        .contiguous(memory_format=torch.channels_last)
    we = (torch.randn(cin, cmid, generator=gen) / cin ** 0.5) \
        .to(dev, bf16) if he else None
    be = (torch.randn(cmid, generator=gen) * 0.1).to(dev) if he else None
    wd = (torch.randn(9, cmid, generator=gen) / 3).to(dev)
    bd = (torch.randn(cmid, generator=gen) * 0.1).to(dev)
    wp = (torch.randn(cmid, cout, generator=gen) / cmid ** 0.5).to(dev, bf16)
    bp = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    return x, (we, be, wd, bd, wp, bp)


def within_two_ulps(got, want):
    """(ok, max abs err, outputs differing): |got - want| <= 2^-6 |want| +
    2^-8 max|want|, two bf16 ulps, and got finite."""
    import torch

    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    ok = bool((d <= 2 ** -6 * want.float().abs() + 2 ** -8 * scale).all()) \
        and bool(torch.isfinite(got.float()).all())
    return ok, float(d.max()), int((d > 0).sum()), scale


def phase_mbconv_checks(dev):
    """Phase 2, K3/K4: the fused MBConv kernel against ``mbconv_plain`` in
    bf16 at the client's block shapes, through K3's wrapper (stride 1)
    and K4's (stride 2), with the kernel's, the plain version's and the
    library's times: the port's own unfused block (cuDNN bf16,
    channels-last), and beside it the same block in f32 (TF32 off).
    Every stride-1 block shape of the 512x1024 forward is timed at B=8,
    and every one of the 12 block shapes is launched once at B=1 on its
    grid, so that no plan ``stage_tile`` returns is refused; so are the
    cases of the JAX kernels' own parity tests (mid widths of 8
    included), at B=2.
    Tolerance: |kernel - plain| <= 2^-6 |plain| + 2^-8 max|plain|, two
    bf16 ulps (the two differ only in the order of the 1x1 sums, which
    moves a bf16 rounding by one ulp now and then)."""
    import torch
    from ams_tpu_torch.models import layers
    from ams_tpu_torch.ops import fused_mbconv as fm
    from ams_tpu_torch.ops import fused_mbconv_banded as fb

    bf16 = torch.bfloat16
    lib = fm._library()
    occ = fm.kernel_occupancy()
    for (mt, nt), (regs, spill) in occ.registers.items():
        log("  warp tiling (%d, %d): %d registers per thread, %d bytes "
            "spilled" % (mt, nt, regs, spill))
    gen = torch.Generator().manual_seed(SEED + 9)
    # every block of the student: the C and Python shared-memory sums
    # agree, a tile fits, and the launcher takes the plan on the block's
    # grid (one image, held against the plain version)
    for name, cin, cmid, cout, s, r, (h, w) in STUDENT_BLOCKS:
        he = cin != cmid
        for grid in ((h, w), ()):
            plan = fm.stage_tile(cin, cmid, cout, s, r, he, *grid,
                                 occupancy=occ)
            c_bytes = lib.mbconv_smem_bytes(cin, cout, s, r, int(he), *plan)
            check(c_bytes == fm.smem_bytes(cin, cout, s, r, he, *plan)
                  <= fm.SMEM_LIMIT, "shared memory plan %s: C %d bytes vs "
                  "Python %d" % (plan, c_bytes, fm.smem_bytes(
                      cin, cout, s, r, he, *plan)))
        x, ws = mbconv_inputs(dev, gen, 1, cin, cmid, cout, h, w)
        residual = s == 1 and cin == cout
        with torch.no_grad():
            if s == 1:
                got = fm.mbconv_block(x, *ws, rate=r, residual=residual)
            else:
                got = fb.mbconv_banded(x, *ws, stride=s, residual=residual)
            want = fm.mbconv_plain(x, *ws, stride=s, rate=r,
                                   residual=residual)
            torch.cuda.synchronize()
        ok, err, _, _ = within_two_ulps(got, want)
        check(ok, "%s at 1x%dx%d: plan %s differs from mbconv_plain by %g"
              % (name, h, w, plan, err))
    log("  shared-memory plans of the 12 block shapes agree between "
        "csrc/mbconv.cu and ops/fused_mbconv.py, all under %d bytes; the "
        "launcher takes each plan and matches mbconv_plain at B=1"
        % fm.SMEM_LIMIT)
    # the cases of tests/test_fused_mbconv.py and
    # tests/test_fused_mbconv_banded.py (h, w, cin, cmid, cout, stride,
    # rate, residual), which the port's cuda-marked test also runs
    jax_cases = [
        (13, 11, 8, 32, 8, 1, 1, True), (13, 11, 8, 32, 16, 1, 1, False),
        (9, 9, 8, 8, 8, 1, 1, False), (17, 15, 16, 96, 16, 1, 2, True),
        (32, 48, 8, 32, 8, 1, 1, True), (32, 48, 8, 32, 16, 1, 1, False),
        (24, 32, 8, 8, 16, 1, 1, False), (32, 48, 8, 32, 16, 2, 1, False),
        (64, 32, 8, 32, 16, 2, 1, False), (40, 48, 8, 16, 8, 1, 1, False),
        (33, 65, 8, 32, 8, 1, 1, True), (17, 33, 8, 8, 16, 1, 1, False),
        (33, 65, 8, 32, 16, 1, 1, False)]
    for h, w, cin, cmid, cout, s, r, residual in jax_cases:
        x, ws = mbconv_inputs(dev, gen, 2, cin, cmid, cout, h, w)
        plan = fm.stage_tile(cin, cmid, cout, s, r, cin != cmid, h, w,
                             occupancy=occ)
        with torch.no_grad():
            if s == 1:
                got = fm.mbconv_block(x, *ws, rate=r, residual=residual)
            else:
                got = fb.mbconv_banded(x, *ws, stride=s, residual=residual)
            want = fm.mbconv_plain(x, *ws, stride=s, rate=r,
                                   residual=residual)
            torch.cuda.synchronize()
        ok, err, _, _ = within_two_ulps(got, want)
        check(ok, "JAX test case %s: plan %s differs from mbconv_plain by "
              "%g" % ((h, w, cin, cmid, cout, s, r, residual), plan, err))
    log("  the %d cases of the JAX kernels' parity tests (chunks of 8 "
        "included) match mbconv_plain at B=2" % len(jax_cases))

    # (label, wrapper, b, cin, cmid, cout, h, w, stride, rate); the first
    # K3 and the first K4 case give the kernels line its numbers
    cases = [
        ("expanded_conv_2 (stride 1, residual)", "K3",
         B, 24, 144, 24, 129, 257, 1, 1),
        ("expanded_conv_16 (rate 2, 160->960->320)", "K3",
         B, 160, 960, 320, 33, 65, 1, 2),
        ("expanded_conv_14 (rate 2, residual)", "K3",
         B, 160, 960, 160, 33, 65, 1, 2),
        ("expanded_conv (no expand)", "K3",
         B, 32, 32, 16, 257, 513, 1, 1),
        ("expanded_conv_4 (32->192->32, residual)", "K3",
         B, 32, 192, 32, 65, 129, 1, 1),
        ("expanded_conv_7 (64->384->64, residual)", "K3",
         B, 64, 384, 64, 33, 65, 1, 1),
        ("expanded_conv_10 (64->384->96)", "K3",
         B, 64, 384, 96, 33, 65, 1, 1),
        ("expanded_conv_11 (96->576->96, residual)", "K3",
         B, 96, 576, 96, 33, 65, 1, 1),
        ("expanded_conv_13 (96->576->160)", "K3",
         B, 96, 576, 160, 33, 65, 1, 1),
        ("stride 2 at a banded shape", "K4",
         B, 16, 96, 24, 256, 512, 2, 1),
        ("expanded_conv_1 (stride 2, odd 257x513)", "K4",
         B, 16, 96, 24, 257, 513, 2, 1),
    ]
    rows = []
    for label, which, b, cin, cmid, cout, h, w, s, r in cases:
        he = cin != cmid
        residual = s == 1 and cin == cout
        x, ws = mbconv_inputs(dev, gen, b, cin, cmid, cout, h, w)
        we, be, wd, bd, wp, bp = ws
        if which == "K3":
            def kernel():
                return fm.mbconv_block(x, *ws, rate=r, residual=residual)
        else:
            def kernel():
                return fb.mbconv_banded(x, *ws, stride=s, residual=residual)

        def plain():
            return fm.mbconv_plain(x, *ws, stride=s, rate=r,
                                   residual=residual)

        hwio = (we.reshape(1, 1, cin, cmid) if he else None,
                wd.reshape(3, 3, cmid, 1), wp.reshape(1, 1, cmid, cout))

        def library(dtype):
            xx = x.to(dtype)
            y = xx
            if he:
                y = layers.conv2d(y, hwio[0], compute_dtype=dtype)
                y = layers.relu6(y + be.to(y.dtype)[:, None, None])
            y = layers.depthwise_conv2d(y, hwio[1], stride=s, rate=r,
                                        compute_dtype=dtype)
            y = layers.relu6(y + bd.to(y.dtype)[:, None, None])
            y = layers.conv2d(y, hwio[2], compute_dtype=dtype)
            y = y + bp.to(y.dtype)[:, None, None]
            return y + xx if residual else y

        with torch.no_grad():
            got, want = kernel(), plain()
            lib_out = library(bf16)
            torch.cuda.synchronize()
            ok, max_err, differing, scale = within_two_ulps(got, want)
            lib_err = float((lib_out.float() - want.float()).abs().max())
            k_ms = cuda_ms(kernel, 20)
            p_ms = cuda_ms(plain, 3)
            l_ms = cuda_ms(lambda: library(bf16), 10)
            l32_ms = cuda_ms(lambda: library(torch.float32), 10)
        ho, wo = got.shape[2], got.shape[3]
        bound, bound_by = mbconv_bound_ms(b, cin, cmid, cout, h, w, ho, wo,
                                          int(he), int(residual))
        plan = fm.stage_tile(cin, cmid, cout, s, r, he, h, w, occupancy=occ)
        cost = fm.plan_cost(cin, cout, s, r, he, *plan, h, w, occupancy=occ)
        row = {"case": label, "wrapper": which,
               "shape": [b, cin, cmid, cout, h, w, s, r],
               "plan": {"tile": [plan[0], plan[1]], "chunk": plan[2],
                        "threads": fm.THREADS,
                        "warp_tiles": list(cost["warp_tiles"]),
                        "registers": occ.registers[cost["warp_tiles"]][0],
                        "resident_per_sm": cost["resident"],
                        "window_per_px": cost["window_per_px"],
                        "projected_per_px": cost["projected_per_px"],
                        "smem": cost["smem"]},
               "max_abs_err": max_err, "scale": scale,
               "differing": differing, "elements": got.numel(),
               "library_bf16_max_abs_err": lib_err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "library_f32_ms": l32_ms, "bound_ms": bound,
               "bound_by": bound_by, "beats_unfused_bf16": k_ms < l_ms}
        log("  MBConv %s [%s] %s, tile %dx%d chunk %d threads %d, %d "
            "resident per SM (window "
            "%.3f, projected %.3f per output pixel): max abs err %.4g (|out| "
            "up to %.4g; %d of %d differ), unfused bf16 vs plain %.4g; "
            "kernel %.4f ms, plain %.4f ms, library bf16 %.4f ms (f32 %.4f "
            "ms), bound %.4f ms (%s); beats the unfused bf16 block: %s"
            % (label, which, row["shape"], plan[0], plan[1], plan[2],
               fm.THREADS, cost["resident"], cost["window_per_px"],
               cost["projected_per_px"],
               max_err, scale, differing, row["elements"], lib_err, k_ms,
               p_ms, l_ms, l32_ms, bound, bound_by, k_ms < l_ms))
        check(ok, "mbconv kernel differs from mbconv_plain beyond two bf16 "
              "ulps in case %s: max abs err %g" % (label, max_err))
        rows.append(row)
    return rows


def grad_rel_error(got, want):
    """Worst per-tensor error norm relative to max(the tensor's norm, the
    norm it would have at the gradient's RMS scale): a tensor whose gradient
    is 0 in exact arithmetic (each project BN's beta, which feeds another
    train-mode BN through a 1x1 conv) is held at the gradient's scale, not
    at its own rounding noise."""
    import math

    n_all = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in want.values()))
    rms = n_all / math.sqrt(sum(g.numel() for g in want.values()))
    worst, worst_key = 0.0, None
    for k, g in want.items():
        err = float((got[k].double() - g.double()).norm()) / max(
            float(g.double().norm()), rms * math.sqrt(g.numel()))
        if err > worst:
            worst, worst_key = err, k
    return worst, worst_key


def phase_server(dev):
    """Phase 4: two distillation events of the server at full width."""
    import collections

    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.convert import (
        adam_state_from_numpy,
        params_from_numpy,
        params_to_numpy,
    )
    from ams_tpu_torch.distill import train_step as ts
    from ams_tpu_torch.distill.loss import distill_loss
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.stream.codec import (
        apply_delta,
        decode_delta,
        delta_order,
        encode_delta,
    )
    from ams_tpu_torch.utils.metrics import calculate_miou

    exp = 0                       # all 19 classes: K2 runs at C=19
    ci = tuple(int(c) for c in configs.class_indices(exp))
    frames = synthetic_frames(MEMORY, SH, SW, SEED + 10)
    staged = torch.from_numpy(frames).to(dev)
    params = init_student_params(SEED, device=dev)
    calibrate_bn(params, staged[:16])
    teacher = init_student_params(SEED + 5, device=dev)
    calibrate_bn(teacher, staged[16:32])
    host = params_to_numpy(params)
    tnet = SemanticNetwork(params_to_numpy(teacher), configs.class_weights(exp),
                           height=SH, frozen=True, device=dev)
    labels = np.concatenate([tnet.predict_input(frames[i:i + 16])
                             for i in range(0, MEMORY, 16)])
    check(labels.shape == (MEMORY, SH, SW), "teacher labels %s"
          % (labels.shape,))
    log("  teacher labels: %d classes present; student: %d trainable "
        "coordinates" % (len(np.unique(labels)),
                         sum(v.size for k, v in host.items()
                             if "moving_" not in k)))

    def client_miou(client):
        cm = 0
        for i in range(0, MEMORY, 16):
            cm = cm + client.predict_with_metric(frames[i:i + 16],
                                                 labels[i:i + 16])[1]
        return float(np.nanmean(calculate_miou(cm, nan=True)))

    server = SemanticNetwork(host, configs.class_weights(exp), height=SH,
                             frozen=False, scale=[1],
                             mini_batch_size=MINI_BATCH, lr=LR,
                             coord_frac=COORD_FRAC, fused_loss=True,
                             device=dev)
    client = SemanticNetwork(host, configs.class_weights(exp), height=SH,
                             frozen=True, device=dev)
    miou_before = client_miou(client)
    initial = server.initial_vars()
    names = delta_order("coord_desc_auto", present=initial)
    shapes = {k: v.shape for k, v in initial.items()}
    memory = (collections.deque(frames), collections.deque(labels))

    reset_counters()
    events, iters_run, prev_mask = [], 0, None
    iters = ROUND_ITERS
    for event, wire in ((1, "float16"), (2, "int8d")):
        server.restore_initial()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = server.train_with_deque(*memory, iters, "coord_desc_auto")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        iters_run += iters
        check(frc.resize_ce_loss_grad.launches == iters_run
              and frc.resize_ce_loss.launches == 0,
              "event %d: resize_ce launched %d loss+grad and %d loss-only "
              "kernels for %d iterations (want one loss+grad each)"
              % (event, frc.resize_ce_loss_grad.launches,
                 frc.resize_ce_loss.launches, iters_run))
        check(losses.shape == (iters,) and np.isfinite(losses).all(),
              "event %d: losses %s" % (event, losses[:5]))
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        check(last < first, "event %d: loss did not fall (%.4f -> %.4f)"
              % (event, first, last))
        after = server.get_vars()
        masks = dict(zip(names, server.curr_mask))
        for k, m in masks.items():
            check(np.array_equal(after[k][~m], initial[k][~m]),
                  "event %d: masked-out coordinates of %s moved" % (event, k))
        total = sum(m.size for m in masks.values())
        sel = sum(int(m.sum()) for m in masks.values())
        round_fn = server._round_fn(iters, "coord_desc_auto")
        ties = int(round_fn.last_selection["ties"])
        pos = (1 - COORD_FRAC) * (total - 1)
        check(total - int(np.floor(pos)) - ties - 1 <= sel
              <= total - int(np.floor(pos)),
              "event %d: %d of %d coordinates selected (%d at the "
              "threshold)" % (event, sel, total, ties))
        stats = server.stats_vars()
        moved = sum(int((stats[k] != initial[k]).sum()) for k in stats)
        check(moved > 0, "event %d: the BN statistics did not move" % event)
        step = int(server.opt_state.step)
        check(step == iters_run, "event %d: Adam step %d after %d iterations"
              % (event, step, iters_run))
        if prev_mask is not None:
            flips = sum(int((masks[k] != prev_mask[k]).sum()) for k in masks)
            check(flips > 0, "event 2 did not reselect")
        prev_mask = masks

        blob = encode_delta(dict(zip(names, server.train_params)), masks,
                            strategy="coord_desc_auto", stats=stats,
                            wire_dtype=wire,
                            base=initial if wire == "int8d" else None)
        dm, dv = decode_delta(blob, shapes, strategy="coord_desc_auto",
                              wire_dtype=wire,
                              base=initial if wire == "int8d" else None)
        want = apply_delta(initial, dm, dv)
        client.apply_downlink(blob, strategy="coord_desc_auto",
                              wire_dtype=wire, base_initial=True)
        got = client.get_vars()
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        check(not bad, "event %d: apply_downlink differs from the host "
              "apply_delta in %s" % (event, bad[:3]))
        ids = client.predict_input(frames[:B])
        check(ids.shape == (B, SH, SW), "client ids %s" % (ids.shape,))
        miou = client_miou(client)
        check(miou > miou_before, "event %d: client mIoU %.4f not above "
              "%.4f before the delta" % (event, miou, miou_before))
        ev = {"event": event, "wire": wire, "iterations": iters,
              "round_s": seconds, "ms_per_iteration": 1e3 * seconds / iters,
              "loss_first10": first, "loss_last10": last,
              "selected": sel, "trainable": total, "ties_at_threshold": ties,
              "delta_bytes": len(blob), "client_miou_before": miou_before,
              "client_miou_after": miou}
        log("  event %d: %d iterations in %.2f s (%.2f ms per iteration, "
            "host clock); loss %.4f -> %.4f (means of the first and last "
            "10); selected %d of %d (%.4f, %d at the threshold); %s delta "
            "%d B; client mIoU vs teacher %.4f -> %.4f"
            % (event, iters, seconds, ev["ms_per_iteration"], first, last,
               sel, total, sel / total, ties, wire, len(blob), miou_before,
               miou))
        events.append(ev)
        if event == 1 and seconds > 120:
            iters = 50
            log("  event 1 took over 120 s: event 2 runs %d iterations"
                % iters)
    # the trained student's loss on the memory, without a gradient: the
    # fused loss (the loss-only kernel) against the gather loss
    trained = params_from_numpy(server.get_vars(), dev)
    with torch.no_grad():
        held = []
        for i in range(0, MEMORY, 32):
            f = staged[i:i + MINI_BATCH].float()
            lab = torch.from_numpy(labels[i:i + MINI_BATCH]).to(dev)
            held.append([float(distill_loss(trained, f, lab, ci, 19,
                                            train=True, fused=fused)[0])
                         for fused in (True, False)])
    held_rel = max(abs(fu - ga) / abs(ga) for fu, ga in held)
    log("  trained student's loss on %d memory minibatches, no gradient: "
        "fused %s, gather %s (max rel %.3g)"
        % (len(held), [fu for fu, _ in held], [ga for _, ga in held],
           held_rel))
    check(held_rel <= 1e-5, "no-grad fused vs gather loss differ by %g"
          % held_rel)
    launches = {"resize_ce_loss": frc.resize_ce_loss.launches,
                "resize_ce_loss_grad": frc.resize_ce_loss_grad.launches,
                "resize_argmax": fra.fused_resize_argmax.launches}
    log("  kernel launches on the server path: %s" % launches)
    check(launches["resize_argmax"] > 0, "the client's predict_input did "
          "not launch resize_argmax on the server path")
    check(launches["resize_ce_loss"] == len(held),
          "the no-grad loss launched resize_ce_loss %d times for %d "
          "minibatches" % (launches["resize_ce_loss"], len(held)))

    # one iteration, same params and minibatch, fused vs gather loss
    idx = torch.arange(MINI_BATCH, device=dev)
    fbuf = staged
    lbuf = torch.from_numpy(labels).to(dev)

    def loss_and_grads(fused):
        pt, bn = ts.split_params(params_from_numpy(host, dev))
        leaves = {k: v.requires_grad_(True) for k, v in pt.items()}
        merged = dict(leaves)
        merged.update(bn)
        loss, _ = distill_loss(merged, fbuf[idx].float(), lbuf[idx], ci, 19,
                               train=True, stats_out={}, fused=fused)
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))

    f_loss, f_grads = loss_and_grads(True)
    g_loss, g_grads = loss_and_grads(False)
    loss_rel = float((f_loss - g_loss).abs() / g_loss.abs())
    grad_rel, grad_key = grad_rel_error(f_grads, g_grads)
    log("  one iteration, fused vs gather loss: loss %.6f vs %.6f (rel "
        "%.3g); worst per-tensor gradient error %.3g (%s)"
        % (float(f_loss), float(g_loss), loss_rel, grad_rel, grad_key))
    check(loss_rel <= 1e-5, "fused vs gather loss differ by %g" % loss_rel)
    check(grad_rel <= 1e-4, "fused vs gather gradients differ by %g in %s"
          % (grad_rel, grad_key))

    # device time per iteration of the round, fused and gather losses
    idx_seq = torch.randint(0, MEMORY, (10, MINI_BATCH),
                            generator=torch.Generator().manual_seed(SEED))
    per_iter = {}
    for fused in (True, False):
        spec = ts.DistillSpec(iters=10, batch_size=MINI_BATCH,
                              class_indices=ci, fused_loss=fused)
        round_fn = ts.make_distill_round(spec)
        p = params_from_numpy(host, dev)
        train, _ = ts.split_params(p)
        mask = ts.all_true_mask(p)

        def run():
            return round_fn(p, ts.adam_init(train), fbuf, lbuf, MEMORY, None,
                            LR, mask, idx_seq=idx_seq)

        per_iter[fused] = cuda_ms(run, 2) / 10
    log("  device ms per training iteration (minibatch %d at %dx%d): fused "
        "loss %.3f, gather loss %.3f" % (MINI_BATCH, SH, SW, per_iter[True],
                                         per_iter[False]))

    # where one fused-loss iteration's device time goes
    spec1 = ts.DistillSpec(iters=1, batch_size=MINI_BATCH, class_indices=ci,
                           fused_loss=True)
    round1 = ts.make_distill_round(spec1)
    p = params_from_numpy(host, dev)
    train, _ = ts.split_params(p)
    mask = ts.all_true_mask(p)
    log("  where the device time of one training iteration goes "
        "(torch.profiler):")
    try:
        lines = device_breakdown(lambda: round1(
            p, ts.adam_init(train), fbuf, lbuf, MEMORY, None, LR, mask,
            idx_seq=idx_seq[:1]), top=12)
    except (RuntimeError, AssertionError) as e:  # informational only
        lines = ["profiler unavailable: %s" % e]
    for line in lines:
        log("    " + line)

    # a small coord_desc_auto round on the card and on the port's CPU
    # path, the same state and idx_seq: warm seeded slots, so that the
    # selection does not sit on the first step's tie cluster
    small = synthetic_frames(4, 64, 128, SEED + 11)
    rows = np.linspace(0, SH - 1, 64).round().astype(int)
    cols = np.linspace(0, SW - 1, 128).round().astype(int)
    small_lab = labels[:4][:, rows][:, :, cols].copy()
    rng = np.random.RandomState(SEED + 12)
    slots_m = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
               for k, v in host.items() if "moving_" not in k}
    slots_v = {k: ((rng.rand(*v.shape) + 0.1) * 1e-3).astype(np.float32)
               for k, v in slots_m.items()}
    spec2 = ts.DistillSpec(iters=2, batch_size=2, class_indices=ci,
                           strategy="coord_desc_auto", coord_frac=COORD_FRAC,
                           fused_loss=True)
    small_idx = np.array([[0, 1], [2, 3]], np.int64)
    results = []
    for d in (dev, torch.device("cpu")):
        p = params_from_numpy(host, d)
        round2 = ts.make_distill_round(spec2)
        out, _, mask2, losses2 = round2(
            p, adam_state_from_numpy(10, slots_m, slots_v, d),
            torch.from_numpy(small).to(d), torch.from_numpy(small_lab).to(d),
            4, None, LR, ts.all_true_mask(p), idx_seq=small_idx)
        results.append((losses2.cpu().numpy(),
                        {k: v.cpu().numpy() for k, v in mask2.items()}))
    (c_loss, c_mask), (h_loss, h_mask) = results
    agree = sum(int((c_mask[k] == h_mask[k]).sum()) for k in h_mask) / \
        sum(m.size for m in h_mask.values())
    round_rel = float(np.max(np.abs(c_loss - h_loss) / np.abs(h_loss)))
    log("  2-iteration coord_desc_auto round at 2x64x128, card vs CPU: "
        "losses %s vs %s (max rel %.3g); masks agree on %.6f"
        % (c_loss.tolist(), h_loss.tolist(), round_rel, agree))
    check(round_rel <= 1e-4, "card vs CPU round losses differ by %g"
          % round_rel)
    check(agree >= 0.995, "card vs CPU round masks agree on only %.4f"
          % agree)
    return launches, events, per_iter


def phase_bf16_client(dev, host):
    """Phase 5: the bf16 folded client at full width, with every launch
    counter set to 0 just before it: through the facade
    (SemanticNetwork(frozen=True, compute_dtype="bfloat16"): predict_input,
    a float16 apply_downlink, predict again, BN-folded export, reload,
    predict_input and per-frame scoring), then the folded fast path
    ``student_predict_fast_folded`` with fused_blocks False, True (K3) and
    "banded" (K4), held against the unfused bf16 ids and the f32 client's,
    with each variant's frames/s; plus one banded forward at 511x1023,
    whose even stem grid takes K4's stride-2 blocks too."""
    import re

    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.convert import params_from_numpy
    from ams_tpu_torch.models import frozen as tf
    from ams_tpu_torch.models.mobilenetv2_deeplab import (
        student_predict_fast,
        trainable_names,
    )
    from ams_tpu_torch.models.resize import resize_nchw
    from ams_tpu_torch.ops import fused_mbconv as fm
    from ams_tpu_torch.ops import fused_mbconv_banded as fb
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.stream.codec import apply_delta, decode_delta, \
        encode_delta

    bf16 = torch.bfloat16
    frames = synthetic_frames(B, H, W, SEED)
    staged = torch.from_numpy(frames).to(dev)
    ci = tuple(range(19))
    kw = dict(height=H, frozen=True, compute_dtype="bfloat16", device=dev)
    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_bf16_")
    reset_counters()
    try:
        client = SemanticNetwork(host, configs.class_weights(0), **kw)
        ids0 = client.predict_input(frames)
        check(ids0.shape == (B, H, W) and ids0.dtype == np.int32,
              "bf16 client ids %s %s" % (ids0.shape, ids0.dtype))
        rng = np.random.RandomState(SEED + 13)
        masks = {k: rng.rand(*host[k].shape) < 0.1
                 for k in trainable_names(host)}
        moved = {k: (np.where(masks[k], host[k] + rng.randn(*host[k].shape)
                              .astype(np.float32) * 0.01, host[k])
                     if k in masks else host[k]) for k in host}
        blob = encode_delta(moved, masks, strategy="coord_desc_auto",
                            wire_dtype="float16")
        shapes = {k: v.shape for k, v in host.items()}
        dm, dv = decode_delta(blob, shapes, strategy="coord_desc_auto",
                              wire_dtype="float16")
        want = apply_delta(host, dm, dv)
        client.apply_downlink(blob, strategy="coord_desc_auto",
                              wire_dtype="float16")
        got = client.get_vars()
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        check(not bad, "bf16 client: apply_downlink differs from the host "
              "apply_delta in %s" % bad[:3])
        ids1 = client.predict_input(frames)
        log("  facade, unfolded bf16 client: predict_input %s; after a "
            "float16 delta (%d B) %.4f of ids changed"
            % (ids0.shape, len(blob), float((ids1 != ids0).mean())))
        path = os.path.join(tmp, "client_bf16")
        client.save_to_frozen_graph(path, fold=True)
        folded = SemanticNetwork(path + ".npz", configs.class_weights(0),
                                 **kw)
        check(folded._folded, "the reloaded bf16 artifact is not folded")
        ids_fold = folded.predict_input(frames)
        agree = float((ids_fold == ids1).mean())
        f_ids, f_cms, f_mious, f_losses = folded.predict_with_metric_seq(
            frames, ids1)
        check(f_cms.shape == (B, 19, 19) and np.isfinite(f_losses).all(),
              "bf16 folded scoring: %s, losses %s" % (f_cms.shape, f_losses))
        check(np.array_equal(f_ids, ids_fold),
              "bf16 folded client: scoring ids differ from predict_input's")
        log("  facade, folded bf16 client: ids agree with the unfolded "
            "bf16 client on %.6f of pixels; predict_with_metric_seq mIoU "
            "vs the unfolded ids %s, losses %s"
            % (agree, np.round(f_mious, 4).tolist(),
               np.round(f_losses, 4).tolist()))
        check(agree > 0.99, "folded bf16 client agrees on only %.4f" % agree)
        fp = folded.params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    variants = (("unfused", False), ("fused K3", True),
                ("banded K4", "banded"))
    grids, per_forward = {}, {}
    with torch.inference_mode():
        g32 = tf._grid_logits_folded_nchw(fp, staged, torch.float32)
        for name, fused in variants:
            before = (fm.mbconv_block.launches, fb.mbconv_banded.launches)
            grids[name] = tf._grid_logits_folded_nchw(
                fp, staged, bf16, fused).float()
            per_forward[name] = (fm.mbconv_block.launches - before[0],
                                 fb.mbconv_banded.launches - before[1])
        torch.cuda.synchronize()
        ids = {n: fra.fused_resize_argmax(g.contiguous(), (H, W))
               for n, g in grids.items()}
        ids32 = fra.fused_resize_argmax(g32.contiguous(), (H, W))

        def margin(grid):
            top2 = torch.topk(resize_nchw(grid, (H, W)), 2, dim=1).values
            return top2[:, 0] - top2[:, 1]

        m_unf, m32 = margin(grids["unfused"]), margin(g32)
        rows = {}
        for name, fused in variants:
            got = tf.student_predict_fast_folded(fp, staged, ci,
                                                 compute_dtype=bf16,
                                                 fused_blocks=fused)
            rerun = float((got == ids[name]).float().mean())
            check(rerun > 0.99, "%s: student_predict_fast_folded ids agree "
                  "with the same forward's grid ids on only %.4f"
                  % (name, rerun))
            err = float((grids[name] - grids["unfused"]).abs().max())
            # interpolation is a convex combination, so no id can change
            # where the top-2 margin exceeds twice the largest grid change
            decisive = m_unf > 2 * err + TIE_MARGIN
            same = ids[name] == ids["unfused"]
            rows[name] = {"rerun_agree": rerun,
                          "grid_max_abs_vs_unfused": err,
                          "agree_vs_unfused": float(same.float().mean()),
                          "differ_off_near_ties": int((~same & decisive)
                                                      .sum()),
                          "k3_per_forward": per_forward[name][0],
                          "k4_per_forward": per_forward[name][1]}
        err32 = float((grids["unfused"] - g32).abs().max())
        decisive32 = m32 > 2 * err32 + TIE_MARGIN
        same32 = ids["unfused"] == ids32
        agree32 = float(same32.float().mean())
        agree32_dec = float(same32[decisive32].float().mean()) \
            if bool(decisive32.any()) else 1.0
        log("  bf16 unfused vs f32 folded client: grid max abs diff %.4g "
            "(|logits| up to %.4g); ids agree on %.6f of pixels, on %.6f of "
            "the %.4f decisive ones (f32 top-2 margin above twice that)"
            % (err32, float(g32.abs().max()), agree32, agree32_dec,
               float(decisive32.float().mean())))
        check(agree32 > 0.99 or agree32_dec > 0.99,
              "bf16 ids agree with the f32 client's on %.4f (decisive %.4f)"
              % (agree32, agree32_dec))
        for name, _ in variants:
            r = rows[name]
            log("  %s: K3 %d and K4 %d launches per forward; grid max abs "
                "diff to unfused %.4g; ids agree %.6f, %d differ off near "
                "ties" % (name, r["k3_per_forward"], r["k4_per_forward"],
                          r["grid_max_abs_vs_unfused"],
                          r["agree_vs_unfused"], r["differ_off_near_ties"]))
            check(r["agree_vs_unfused"] > 0.99 and
                  r["differ_off_near_ties"] == 0,
                  "%s ids disagree with the unfused bf16 ids" % name)
        k3_want, k4_want = expected_mbconv_launches(H, W)
        check(per_forward == {"unfused": (0, 0), "fused K3": (k3_want, 0),
                              "banded K4": (0, k4_want)}
              and k3_want > 0 and k4_want > 0,
              "MBConv launches per forward %s; the routing gives K3 %d, "
              "K4 %d" % (per_forward, k3_want, k4_want))

    # frames/s: device (CUDA events) and end to end (host uint8 in, host
    # ids out, host clock), f32 folded beside the three bf16 variants
    n_rep = 5
    rates = {}
    for name, dtype, fused in (("f32", torch.float32, False),
                               ("bf16 unfused", bf16, False),
                               ("bf16 fused K3", bf16, True),
                               ("bf16 banded K4", bf16, "banded")):
        def forward():
            return tf.student_predict_fast_folded(
                fp, staged, ci, compute_dtype=dtype, fused_blocks=fused)

        def end_to_end():
            t = torch.from_numpy(frames).to(dev)
            return tf.student_predict_fast_folded(
                fp, t, ci, compute_dtype=dtype, fused_blocks=fused).cpu()

        with torch.inference_mode():
            dev_ms = cuda_ms(forward, n_rep)
            end_to_end()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_rep):
                end_to_end()
            host_fps = n_rep * B / (time.perf_counter() - t0)
        rates[name] = {"device_ms": dev_ms,
                       "device_frames_per_s": B * 1e3 / dev_ms,
                       "end_to_end_frames_per_s": host_fps}
        log("  %s folded client: %.2f ms per batch of %d on the device = "
            "%.1f frames/s; %.1f frames/s end to end"
            % (name, dev_ms, B, B * 1e3 / dev_ms, host_fps))
    for name, fused in (("bf16 unfused", False), ("bf16 fused K3", True)):
        log("  where the device time of one %s forward goes "
            "(torch.profiler):" % name)
        try:
            with torch.inference_mode():
                lines = device_breakdown(lambda: tf.student_predict_fast_folded(
                    fp, staged, ci, compute_dtype=bf16, fused_blocks=fused),
                    top=10)
        except (RuntimeError, AssertionError) as e:  # informational only
            lines = ["profiler unavailable: %s" % e]
        for line in lines:
            log("    " + line)

    # K1 reads the grid as the forward leaves it: between the forward's
    # last kernel (the logits' bias add) and K1 runs no cast, gather or
    # copy, on the folded and the unfolded fast paths, bf16 and f32
    unfolded = params_from_numpy(host, dev)
    sub = tuple(int(k) for k in configs.class_indices(SUBSET_EXP))
    handover = {}
    for name, fn in (
            ("folded bf16 fused K3, 19 classes",
             lambda: tf.student_predict_fast_folded(
                 fp, staged, ci, compute_dtype=bf16, fused_blocks=True)),
            ("folded bf16 unfused, exp %d" % SUBSET_EXP,
             lambda: tf.student_predict_fast_folded(fp, staged, sub,
                                                    compute_dtype=bf16)),
            ("folded f32, exp %d" % SUBSET_EXP,
             lambda: tf.student_predict_fast_folded(fp, staged, sub)),
            ("unfolded bf16, exp %d" % SUBSET_EXP,
             lambda: student_predict_fast(unfolded, staged, sub,
                                          compute_dtype=bf16)),
            ("unfolded f32, exp %d" % SUBSET_EXP,
             lambda: student_predict_fast(unfolded, staged, sub))):
        # torch.profiler drops kernels now and then (a forward's profile
        # once read half its device time): profile again, up to twice,
        # when the trace holds no K1 at all
        for tries in range(1, 4):
            with torch.inference_mode():
                names = kernels_in_order(fn)
            if any("resize_argmax" in n for n in names):
                break
        last = len(names) - 1
        prev = names[last - 1] if last > 0 else ""
        handover[name] = {"kernels": len(names),
                          "kernel_names": len(set(names)),
                          "before_k1": prev[:160], "profiles": tries}
        log("  %s: %d kernel launches of %d names (profile %d); K1 last: %s;"
            " the kernel before it: %s"
            % (name, len(names), len(set(names)), tries,
               "resize_argmax" in names[last], prev[:110]))
        check("resize_argmax" in names[last],
              "%s: the forward's last kernel is %s, not K1"
              % (name, names[last][:110]))
        check(not re.search(r"copy|index_?select|gather|memcpy", prev,
                            re.IGNORECASE),
              "%s: a cast, gather or copy runs before K1: %s"
              % (name, prev[:110]))
    log("  the fused bf16 forward runs %d kernel names (42 when the grid "
        "was cast and gathered before K1)"
        % handover["folded bf16 fused K3, 19 classes"]["kernel_names"])

    # 511x1023 frames: the stem grid is 256x512, so the banded routing
    # takes the stride-2 blocks expanded_conv_1 and _3 as well
    oh, ow = ODD_HW
    odd = torch.from_numpy(synthetic_frames(B, oh, ow, SEED + 4)).to(dev)
    with torch.inference_mode():
        before = fb.mbconv_banded.launches
        ids_b = tf.student_predict_fast_folded(fp, odd, ci,
                                               compute_dtype=bf16,
                                               fused_blocks="banded")
        k4_odd = fb.mbconv_banded.launches - before
        ids_u = tf.student_predict_fast_folded(fp, odd, ci,
                                               compute_dtype=bf16)
        torch.cuda.synchronize()
    agree_odd = float((ids_b == ids_u).float().mean())
    k4_want = expected_mbconv_launches(oh, ow)[1]
    log("  banded forward at %dx%dx%d: %d K4 launches (stride 1 and 2; the "
        "routing gives %d); ids agree with the unfused bf16 forward on %.6f"
        % (B, oh, ow, k4_odd, k4_want, agree_odd))
    check(k4_odd == k4_want and agree_odd > 0.99,
          "%dx%d banded forward: %d K4 launches (want %d), agreement %.4f"
          % (oh, ow, k4_odd, k4_want, agree_odd))

    launches = {"resize_argmax": fra.fused_resize_argmax.launches,
                "resize_ce_loss": frc.resize_ce_loss.launches,
                "resize_ce_loss_grad": frc.resize_ce_loss_grad.launches,
                "mbconv": fm.mbconv_block.launches,
                "mbconv_banded": fb.mbconv_banded.launches}
    log("  kernel launches on the bf16 client path: %s" % launches)
    check(launches["mbconv"] > 0 and launches["mbconv_banded"] > 0
          and launches["resize_argmax"] > 0,
          "a kernel of the bf16 client path was not launched: %s" % launches)
    return launches, rows, rates, handover


def png_probe_images(seed=SEED):
    """A fixed 256x512 BGR frame and label map from integer arithmetic and
    the legacy RandomState stream only, so every numpy makes the same
    pixels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:256, 0:512]
    base = np.stack([(xx * 3 + yy) // 4, (yy * 5 + xx // 3) // 6,
                     (xx + yy * 2) // 5], -1) % 256
    frame = (base + rng.randint(0, 9, base.shape)).clip(0, 255).astype(
        np.uint8)
    label = ((yy + xx // 3) // 19 % 19).astype(np.uint8)
    label[rng.randint(0, 50, label.shape) == 0] = 255
    return {"frame": frame, "label": label}


def phase_experiment(dev):
    """Phase 6: the emulated experiment through the CLI, early then
    pretrained, on a frame directory written by the port."""
    import hashlib
    import zlib

    import numpy as np
    import torch
    from ams_tpu_torch.cli import run as cli_run
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.data.image import png_encode, png_read
    from ams_tpu_torch.data.video import (
        frame_path,
        frame_to_rgb,
        write_synthetic_clip,
    )
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
    from ams_tpu_torch.runtime.analytics import plot_miou_mean
    from ams_tpu_torch.runtime.client import infer_output
    from ams_tpu_torch.runtime.config import RunConfig, get_save_dir
    from ams_tpu_torch.utils.trace import GLOBAL_TIMER

    log("  zlib %s (compiled against %s)" % (zlib.ZLIB_RUNTIME_VERSION,
                                            zlib.ZLIB_VERSION))
    for name, img in png_probe_images().items():
        blob = png_encode(img)
        size, sha = len(blob), hashlib.sha256(blob).hexdigest()
        log("  PNG probe %s: %d B, sha256 %s" % (name, size, sha))
        check((size, sha) == PNG_PROBE[name],
              "PNG probe %s: %d B %s, cv2 wrote %d B %s (zlib differs)"
              % (name, size, sha, *PNG_PROBE[name]))

    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_exp_")
    try:
        t0 = time.perf_counter()
        clip = os.path.join(tmp, EXP_CLIP)
        gt = os.path.join(tmp, "gt") + "/"
        write_synthetic_clip(clip, seconds=8, fps=EXP_FPS, size_hw=EXP_HW,
                             seed=SEED, gt_dir=gt, style="bands")
        n_frames = 8 * EXP_FPS
        log("  wrote %d %dx%d BGR frames and labels in %.2f s"
            % (n_frames, EXP_HW[0], EXP_HW[1], time.perf_counter() - t0))
        # seeded random weights, BN statistics from the clip's frames
        params = init_student_params(SEED, device=dev)
        calib = np.stack([frame_to_rgb(png_read(frame_path(clip, i)),
                                       (SH, SW)) for i in range(0, 80, 10)])
        calibrate_bn(params, torch.from_numpy(calib).to(dev))
        os.makedirs(os.path.join(tmp, "ckpt"))
        ckpt = os.path.join(tmp, "ckpt", "student.npz")
        np.savez(ckpt, **params_to_numpy(params))

        out = os.path.join(tmp, "out") + "/"
        common = ["--input_video", clip, "--gt_video", gt,
                  "--student_checkpoint", ckpt, "--output_dir", out,
                  "--height", str(SH), "--batch_size", str(MINI_BATCH),
                  "--send_period", "2", "--train_period", "2",
                  "--memory_len", "250", "--iter", str(ROUND_ITERS),
                  "--train_strategy", "coord_desc_auto",
                  "--coord_fraction", str(COORD_FRAC)]
        runs = {}
        for mode, extra, label in (
                ("early", ["--early_cutoff_time", str(EXP_CUTOFF)],
                 "early%d_f2" % EXP_CUTOFF),
                ("pretrained", [], "pretrained")):
            reset_counters()
            GLOBAL_TIMER.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli_run.main(["--mode", mode] + extra + common)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            log("  %s: %.2f s wall; launches %s" % (mode, wall, launches))
            check(not any(launches.values()),
                  "%s: a kernel launched in the loop: %s (JAX's routing "
                  "runs none: the client keeps its logits, the round uses "
                  "the gather loss)" % (mode, launches))
            log("  spans:\n" + "\n".join(
                "    " + line for line in GLOBAL_TIMER.summary().split("\n")))
            runs[mode] = dict(label=label, wall=wall,
                              totals=dict(GLOBAL_TIMER.totals),
                              counts=dict(GLOBAL_TIMER.counts))
        cfg = RunConfig(input_video=clip, gt_video=gt,
                        student_checkpoint=ckpt, output_dir=out, height=SH,
                        send_period=2)

        def results(label):
            return get_save_dir(cfg, label + "_results")

        early = results(runs["early"]["label"])
        names = ["_fps_client.npy", "_bw_uplink.npy", "_uplink_exact.npy",
                 "_bw_downlink.npy", "_model_update_times.npy",
                 "_update.txt", "_loss.npy", "_mioucats.npy", "_mious.npy",
                 "_mioumems.npy"]
        want = [early + n for n in names]
        want += [results("pretrained") + n for n in names]
        for second in (0, EXP_CUTOFF):
            want.append(get_save_dir(cfg, "early%d_f2_%d"
                                     % (EXP_CUTOFF, second)) + "_final.npz")
        want.append(get_save_dir(cfg, "early%d_f2_0" % EXP_CUTOFF)
                    + "_mask.dat.gz")
        want.append(get_save_dir(cfg, "pretrained_0") + "_final.npz")
        bundle = get_save_dir(cfg, "early%d_f2" % EXP_CUTOFF)
        want += [bundle + "_resume_state.npz", bundle + "_resume_meta.json"]
        missing = [p for p in want if not os.path.exists(p)]
        check(not missing, "missing artifacts: %s" % missing)
        with open(early + "_update.txt") as f:
            down, up, updates, interval, samples = (
                int(x) for x in f.read().split("\n"))
        log("  early _update.txt: downlink %d bits, uplink %d kbits, %d "
            "update(s), %d s, %d samples" % (down, up, updates, interval,
                                             samples))
        check(updates == 1, "%d updates, expected 1 (second 0 skips on an "
              "empty memory, second %d trains)" % (updates, EXP_CUTOFF))
        check(down > 0 and up > 0 and samples > 0 and interval == EXP_CUTOFF,
              "update.txt: %s" % [down, up, updates, interval, samples])
        means = {}
        for mode in ("early", "pretrained"):
            base = results(runs[mode]["label"])
            for n in ("_mious.npy", "_mioumems.npy", "_loss.npy"):
                a = np.load(base + n)
                check(a.shape == (n_frames,), "%s%s: %s" % (mode, n,
                                                              a.shape))
                live = a[~np.isnan(a)]
                check(live.size > 0 and np.isfinite(live).all(),
                      "%s%s: not finite where defined" % (mode, n))
            means[mode] = plot_miou_mean(
                cfg, -1, 2 if mode == "early" else -1, runs[mode]["label"])

        # the card's client against the port's CPU client on the same
        # deployed artifacts, the first two seconds
        cpu_out = os.path.join(tmp, "cpu_client") + "/"
        shutil.copytree(out, cpu_out)
        cpu_cfg = RunConfig(input_video=clip, gt_video=gt,
                            student_checkpoint=ckpt, output_dir=cpu_out,
                            height=SH, send_period=2, device="cpu")
        torch.set_num_threads(os.cpu_count() or 1)
        infer_output(cpu_cfg, 0, 2, runs["early"]["label"], gt, 90, [0])
        cpu_res = get_save_dir(cpu_cfg, runs["early"]["label"] + "_results")
        card_loss = np.load(early + "_loss.npy")[:2 * EXP_FPS]
        cpu_loss = np.load(cpu_res + "_loss.npy")
        loss_err = float(np.max(np.abs(card_loss - cpu_loss)
                                / np.abs(cpu_loss)))
        miou_err = float(np.nanmax(np.abs(
            np.load(early + "_mious.npy")[:2 * EXP_FPS]
            - np.load(cpu_res + "_mious.npy"))))
        log("  card client vs CPU client, seconds 0-1: loss max rel err "
            "%.3g (tolerance 1e-4), per-frame mIoU max abs err %.3g "
            "(tolerance 1e-3)" % (loss_err, miou_err))
        check(loss_err <= 1e-4 and miou_err <= 1e-3,
              "card client differs from the CPU client")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows = {}
    for mode, r in runs.items():
        t, c = r["totals"], r["counts"]
        server = t.get("server/loop", 0.0)
        client = t.get("client/loop", 0.0)
        event = sum(t.get(k, 0.0) for k in (
            "server/train_round", "server/delta_encode", "server/deploy",
            "server/resume_save"))
        rows[mode] = {
            "wall_s": r["wall"],
            "server_loop_s": server, "client_loop_s": client,
            "train_round_s": t.get("server/train_round"),
            "ms_per_iteration": (1000 * t["server/train_round"] / ROUND_ITERS
                                 if "server/train_round" in t else None),
            "event_s": event if c.get("server/train_round") else None,
            "client_frames_per_s": n_frames / client if client else None,
            "server_decode_share": (t.get("server/decode", 0.0) / server
                                    if server else None),
            "client_decode_share": (t.get("client/decode", 0.0) / client
                                    if client else None),
            "miou_mean": means[mode]["miou_mean"],
            "uplink_kbps": means[mode]["uplink_kbps"],
            "downlink_kbps": means[mode]["downlink_kbps"]}
    return rows


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs one")
        return 1
    smi = nvidia_smi()
    log("device: %s | nvidia-smi: %s | torch %s, CUDA %s, %d device(s)"
        % (torch.cuda.get_device_name(0), smi, torch.__version__,
           torch.version.cuda, torch.cuda.device_count()))
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ams_tpu_torch.ops import build
    from ams_tpu_torch.ops import fused_mbconv as fm
    from ams_tpu_torch.ops import fused_mbconv_banded as fb
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc
    from ams_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")

    log("phase 1: build")
    t0 = time.perf_counter()
    info = build.build(["resize_argmax", "resize_ce", "mbconv"])
    log("  built in %.2f s wall" % (time.perf_counter() - t0))
    for name, rec in info.items():
        log("  %s: %.2f s%s -> %s" % (name, rec["seconds"],
                                      " (cached)" if rec["cached"] else "",
                                      rec["path"]))
        for line in rec["ptxas"]:
            log("    " + line)

    log("phase 2: kernels against their plain versions")
    cases = phase_kernel_checks(dev)
    ce_cases = phase_resize_ce_checks(dev)
    mb_cases = phase_mbconv_checks(dev)

    log("phase 3: main path (edge client, %dx%dx%d uint8 frames)" % (B, H, W))
    launches, host_fps, dev_fps, host = phase_main_path(dev)

    log("phase 4: server path (%d-frame memory of %dx%d, minibatch %d, %d "
        "iterations of coord_desc_auto, fused resize+CE loss)"
        % (MEMORY, SH, SW, MINI_BATCH, ROUND_ITERS))
    server_launches, events, per_iter = phase_server(dev)

    log("phase 5: bf16 folded client (%dx%dx%d uint8 frames; unfused, fused "
        "K3 and banded K4 blocks)" % (B, H, W))
    bf16_launches, bf16_rows, bf16_rates, handover = phase_bf16_client(
        dev, host)

    log("phase 6: the emulated experiment (python -m ams_tpu_torch.cli.run "
        "--mode early, then --mode pretrained; %d s of %dx%d frames at %d "
        "fps, --height %d, %d iterations)"
        % (8, EXP_HW[0], EXP_HW[1], EXP_FPS, SH, ROUND_ITERS))
    experiment = phase_experiment(dev)

    main_case = cases[0]
    kernels = [{
        "name": "resize_argmax", "route": "cuda", "source": fra.SOURCE,
        "replaces": fra.REPLACES, "launches": launches["resize_argmax"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timed_by": "ms: CUDA events over back-to-back calls, as for every "
                    "kernel; *device_ms: torch.profiler's kernel durations",
        "device_ms": main_case["device_ms"],
        "plain_device_ms": main_case["plain_device_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "same_bits_on_rerun": all(c["same_bits"] for c in cases),
        "plan": main_case["plan"],
        "mismatches": main_case["mismatches"],
        "mismatches_off_ties": sum(c["mismatches_off_ties"] for c in cases),
        "server_path_launches": server_launches["resize_argmax"],
        "bf16_path_launches": bf16_launches["resize_argmax"],
        "handover": handover,
        "shape": main_case["shape"], "cases": cases}]
    ce_main = ce_cases[0]
    for part, key in (("loss", "loss_abs_err"),
                      ("loss_grad", "grad_max_abs_err")):
        kernels.append({
            "name": "resize_ce_" + part, "route": "cuda",
            "source": frc.SOURCE, "replaces": frc.REPLACES,
            "launches": server_launches["resize_ce_" + part],
            "max_abs_err": max(c[key] for c in ce_cases),
            "ms": ce_main[part + "_ms"],
            "plain_ms": ce_main[part + "_plain_ms"],
            "bound_ms": ce_main[part + "_bound_ms"],
            "bound_by": ce_main[part + "_bound_by"],
            "library_ms": ce_main[part + "_library_ms"],
            "timed_by": "ms: CUDA events over back-to-back calls, as for "
                        "every kernel; *device_ms: torch.profiler's kernel "
                        "durations",
            "device_ms": ce_main[part + "_device_ms"],
            "plain_device_ms": ce_main[part + "_plain_device_ms"],
            "library_device_ms": ce_main[part + "_library_device_ms"],
            "same_bits_on_rerun": all(c["same_bits"] for c in ce_cases),
            "shape": ce_main["shape"], "plan": ce_main["plan"],
            "cases": [{k: v for k, v in c.items()
                       if k in ("case", "shape", key)
                       or k.startswith(part + "_")
                       and (part == "loss_grad") == k.startswith("loss_grad")}
                      for c in ce_cases]})
    for name, which in (("mbconv", "K3"), ("mbconv_banded", "K4")):
        mod = fm if which == "K3" else fb
        mine = [c for c in mb_cases if c["wrapper"] == which]
        case = mine[0]        # expanded_conv_2; stride 2 at 256x512
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": bf16_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "library_f32_ms": case["library_f32_ms"],
            "shape": case["shape"], "per_forward": {
                n: r["k3_per_forward" if which == "K3" else "k4_per_forward"]
                for n, r in bf16_rows.items()},
            "cases": mine})
    for c in mb_cases:
        log("MBConv %s [%s]: tile %s chunk %d threads %d tiling %s (%d "
            "resident); kernel %.4f ms, "
            "unfused bf16 %.4f ms, f32 %.4f ms, plain %.4f ms, bound %.4f ms; "
            "max abs err %.4g; beats the unfused bf16 block: %s"
            % (c["case"], c["wrapper"], "x".join(map(str, c["plan"]["tile"])),
               c["plan"]["chunk"], c["plan"]["threads"],
               tuple(c["plan"]["warp_tiles"]), c["plan"]["resident_per_sm"],
               c["kernel_ms"],
               c["library_ms"], c["library_f32_ms"], c["plain_ms"],
               c["bound_ms"], c["max_abs_err"], c["beats_unfused_bf16"]))
    log("client throughput: %.1f frames/s end to end, %.1f frames/s on the "
        "device (batch %d, %dx%d)" % (host_fps, dev_fps, B, H, W))
    for name, r in bf16_rates.items():
        log("folded client %s: %.1f frames/s end to end, %.1f frames/s on "
            "the device" % (name, r["end_to_end_frames_per_s"],
                            r["device_frames_per_s"]))
    for ev in events:
        log("server event %d: %d iterations in %.2f s (%.2f ms per iteration "
            "end to end); %s delta %d B; client mIoU %.4f -> %.4f"
            % (ev["event"], ev["iterations"], ev["round_s"],
               ev["ms_per_iteration"], ev["wire"], ev["delta_bytes"],
               ev["client_miou_before"], ev["client_miou_after"]))
    log("server device ms per iteration: fused loss %.3f, gather loss %.3f"
        % (per_iter[True], per_iter[False]))
    for c in cases:
        log("resize_argmax %s %s: %.4f ms per call (%.4f on the device; "
            "bound %.4f); plain %.4f / %.4f, library %.4f / %.4f; plan %s"
            % (c["case"], c["shape"], c["kernel_ms"], c["device_ms"],
               c["bound_ms"], c["plain_ms"], c["plain_device_ms"],
               c["library_ms"], c["library_device_ms"], c["plan"]))
    for c in ce_cases:
        log("resize_ce %s %s: loss %.4f ms, loss+grad %.4f ms per call "
            "(%.4f, %.4f on the device; bounds %.4f, %.4f); plan %s"
            % (c["case"], c["shape"], c["loss_ms"], c["loss_grad_ms"],
               c["loss_device_ms"], c["loss_grad_device_ms"],
               c["loss_bound_ms"], c["loss_grad_bound_ms"], c["plan"]))
    for mode, r in experiment.items():
        log("experiment %s: %.2f s wall; server loop %.2f s (decode %.1f%%), "
            "client loop %.2f s (decode %.1f%%), client %.1f frames/s in "
            "the loop; round %s s (%s ms per iteration), event %s s; mIoU "
            "mean %.4f, uplink %.3f kbps, downlink %.3f kbps"
            % (mode, r["wall_s"], r["server_loop_s"],
               100 * (r["server_decode_share"] or 0), r["client_loop_s"],
               100 * (r["client_decode_share"] or 0),
               r["client_frames_per_s"], r["train_round_s"],
               r["ms_per_iteration"], r["event_s"], r["miou_mean"],
               r["uplink_kbps"], r["downlink_kbps"]))
    log("experiment trained against pretrained mIoU: %.4f vs %.4f"
        % (experiment["early"]["miou_mean"],
           experiment["pretrained"]["miou_mean"]))
    log("wall-clock: %.1f s" % (time.perf_counter() - t_start))
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
