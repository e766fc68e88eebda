#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ams_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at the full width of both models, from seeded
random weights: the real student (MobileNetV2-DeepLabV3, 19 logits) in the
deployed edge client's serving path (512x1024 frames, batch 8), the
server's distillation events (256x512 frames, minibatch 10, 200
iterations of coord_desc_auto), the emulated experiment, the live
runtime, the multi-video server and the minibatch-parallel round, the
Xception-65 teacher in the batched labeler (257x513 frames at batch 32,
513x1025 at batch 16), the TF1 reader, the converter, the native codec,
the TF32 round, the legacy builders, Orbax checkpoints without orbax and
the validation gate; and checks each kernel of the paths on the card:

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
   512x1024 frames at 10 fps, exp 90; phase 7 reads it too), then `python -m
   ams_tpu_torch.cli.run` with run.py's defaults and --mode early
   (cutoff 6 s: one training event of 200 iterations) and --mode
   pretrained, on the card; every artifact checked, one update, the uplink
   and downlink bits above 0, finite per-frame scores, no kernel launched
   (the JAX package's routing: the client keeps its logits, the round uses
   the gather loss), the card's client against the CPU client on the same
   artifacts, and the PNG bytes of two probe images against OpenCV's (the
   card's zlib); with the spans of both runs, decode's share of each loop,
   the client's frames/s and both runs' mIoU;
7. the Xception-65 teacher and the batched labeler on the same clip:
   seeded weights with BN statistics from the clip's frames; K1 against
   its plain version on the teacher's own bf16 grid at the labeler's two
   shapes (257x513 at batch 32, 513x1025 at batch 16); `python -m
   ams_tpu_torch.cli.extract_labels` at --height 256 and at full frame
   size, each with every launch counter set to 0 just before it (K1 once
   per chunk, nothing else; every gt_ PNG equal to the labeler's ids;
   annot_ and vis_ written), frames/s end to end and of the labeler
   alone, with the device's busy share; the f32 labeler on the card (no
   K1) against the CPU's; the bf16 labels' agreement with the f32 labels;
8. the live runtime on the same clip: `python -m ams_tpu_torch.cli.serve
   --port 0 --max_clients 2` (seeded teacher and student with BN
   statistics from the clip, by --teacher_checkpoint and a
   --checkpoint_dir name) and two concurrent `python -m
   ams_tpu_torch.cli.edge` at --height 256 (float16 and int8d wires, send
   and train periods of 2 and 4 s, 200 iterations, sessions in bf16 by
   the hello's default), each applying 2 deltas with its artifacts
   cross-summed, then SIGTERM and "served 4 rounds across 2 sessions";
   then, with every launch counter set to 0 just before it, one session
   in this process (a LiveServer with the bf16 teacher labeler, a
   LiveClient on the card): K1 once per labeler chunk and once per frame
   predicted and no other kernel, the client equal to the server's values
   at float16 after every delta and to final_vars at the end, its ids
   equal to a CPU client's off near ties, and the bf16 round's times;
9. multi-device: (a) a MultiVideoServer with exps 25, 22, 12 and 17 on
   the card (bf16, 256x512, minibatch 10), each memory 20 clip frames
   labelled by make_sharded_labeler over a one-card mesh with phase 7's
   teacher (ids equal to teacher_predictions, no kernel); video 0 of a
   6-iteration multi-video round against a single-video round from the
   same state, generator and class mask, equal to the bit; 200
   iterations, then 20 with keep_mask (finite losses, distinct videos,
   delta shares within 5-15%, masks kept), one video's 200-iteration round alone, the device's busy share
   over the keep_mask round, a bitwise save_state/load_state, and video
   0's deployed artifact on the f32 client with every counter set to 0
   just before it (K1 once per frame, nothing else); (b) the minibatch-
   parallel round on two gloo ranks sharing the card (this script with
   --dp-rank) and on one NCCL rank, against the single-device round:
   coord_desc_auto for 6 iterations with and without the fused loss, and
   full_model for one; the ranks equal to the bit, the tolerances of
   tests/test_sharded_round.py (loss, selection masks; for full_model the
   BN moving statistics and the weights), every counter set to 0 just
   before each round in each rank (K2 once per iteration per rank with
   the fused loss, no other launch), the one rank equal to the bit; no
   phase turns deterministic algorithms on;
10. the rest of the port, every launch counter set to 0 just before each
   part: (a) the committed TF1 student checkpoint read without TensorFlow
   (equal to its tool's seeded arrays, the Adam slot and global_step
   dropped; the read's ms); (b) `python -m ams_tpu_torch.cli.convert
   <prefix> out.npz --fold --device cuda`, bitwise fold_student of (a) on
   the card; (c) the native delta codec (its g++ build time from phase
   1): encode_delta of a full-width delta (float16 full_model, and
   coord_desc_auto at 10% with the stats annex) through the native
   library with no fallback, equal to the Python path after decompression
   and decode_delta, and byte-equal to the Python payload deflated with
   the native settings (zlib's gzip wrapper, level 9, memLevel 9); the ms
   of the three; (d) the facade's coord_desc_auto round (phase 4's setup, fused
   loss) with conv_precision "highest", "default" (TF32) and "highest"
   again (the f32 round's own spread on the card), in turns, from the
   same state, seed and Adam slots (warmed under an all-False mask), for
   3 and for 200 iterations: K2 loss+grad once per iteration and nothing
   else, the TF32 flags off after each round, and over 3 iterations on
   for every convolution and product of the TF32 round and off for the
   f32 rounds' (read by a torch function mode); over 3 iterations TF32's losses
   within 5% of f32's and the parameter deltas at cosine above 0.9; over
   200 the losses within 5% over the first 10 iterations and on the
   plateau (the mean of the last 20); masks agreeing on 98% (the
   selection runs in TF32 too), and less than the f32 rerun's; ms per
   iteration of each; (e) the
   legacy builders on the card: create_student_v3 from the TF prefix
   (predictions, loss, update_op, 3 train steps that move the BN
   statistics, a train_coord that keeps unmasked weights), create_client
   at 8x512x1024 with a confidence threshold against the ungated ids,
   create_teacher's predictions against teacher_predictions at 2x257x513,
   frames/s of each; (f) the space-to-depth stem against the stride-2
   SAME convolution at 8x513x1025x3 in f32, both times;
11. width partitioning (the mesh's model axis), every shard on the card:
   (a) in phase 9 part B's call, two more gloo ranks (this script with
   --dp-rank and --dp-model 2), each splitting its width over a 2-shard
   row of the card (mesh data 2 x model 2), through every case of
   DP_CASES against the same single-device round and at the same gates,
   the ranks equal to the bit, K2 loss+grad counted once per iteration
   per rank with the fused loss (the gathered grid) and nothing else;
   then on one rank, 20 iterations of phase 4's round partitioned against
   unpartitioned, in turns, and the largest shard of a rank's train-mode
   forward; (b) make_sharded_labeler over Mesh([[cuda:0, cuda:0]]) on
   phase 7's teacher at 4x257x513, its f32 ids against
   teacher_predictions (0.999, equal off near ties: margins within twice
   the partitioned logits' largest gap), and its bf16 ids' agreement;
   (c) the repaired faults: the round in bf16,
   f32 and f32 with the fused loss, each run twice with deterministic
   algorithms off and equal to the bit, and png_decode of a 512x1024
   frame with every row Average and every row Paeth, equal to the
   pixels cv2 decoded from the same construction (DECODE_PROBE), timed;
12. Orbax checkpoints without orbax, every launch counter set to 0 just
   before each part: (a) libzstd's version on the machine (without it the
   run fails, naming libzstd.so.1); (b) the committed OCDBT fixture
   (tests/fixtures/student_orbax, written by orbax) through load_any,
   equal name for name and bit for bit to the TF1 fixture, both reads
   timed 5 times; (c) save_orbax of that full-width student and
   load_orbax back, bitwise, timed; (d) a frozen f32 client built from
   the Orbax fixture and one from the TF1 prefix on the card, predict_input
   of 8 frames of 512x1024: ids equal bit for bit, K1 launches equal,
   above 0, and nothing else; (e) `python tools/torch_validate_reference.py
   --stages inventory,convert,simple` on the TF1 fixture and a fresh bands
   clip at --height 256 on the card: exit 0, inventory and convert OK, both
   mIoUs finite, its wall time;
13. one JSON line of kernel numbers, the wall-clock, and as the last line
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.  It imports nothing
of JAX or of ams_tpu.
"""

from __future__ import annotations

import contextlib
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


def calibrate_bn(params, frames, forward=None):
    """Set every moving statistic to the batch moments of ``frames`` (one
    float32 ``forward``, the student's by default, with batch-statistics
    BN), so seeded random weights give activations of a trained network's
    scale.  Synthetic init leaves the statistics at (0, 1), under which the
    logits of 17 random blocks vanish and every pixel ties."""
    import torch
    from ams_tpu_torch.models import layers
    from ams_tpu_torch.models.mobilenetv2_deeplab import student_logits

    forward = forward or student_logits

    infer = layers.batch_norm_infer

    def batch_stats_bn(x, gamma, beta, mean, var, eps=layers.BN_EPS):
        mean.copy_(x.mean(dim=(0, 2, 3)))
        var.copy_(x.var(dim=(0, 2, 3)))
        return infer(x, gamma, beta, mean, var, eps)

    layers.batch_norm_infer = batch_stats_bn
    try:
        with torch.no_grad():
            forward(params, frames)
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


def k1_case(label, grid, h, w, ci=None):
    """K1 against its plain version on one (B, C, gh, gw) grid, as the
    caller's forward left it: two runs for the same bits, ids equal to the
    plain version's off near ties, and the time per call by CUDA events
    (``ms``) and on the device by torch.profiler (``device_ms``) beside
    the plain version, the library call and the bound.  Returns the
    kernel's ids and the case's row; a failed check raises."""
    import torch
    import torch.nn.functional as F
    from ams_tpu_torch.ops import fused_resize_argmax as fra

    b, c, gh, gw = grid.shape
    cl = (not grid.is_contiguous()
          and grid.is_contiguous(memory_format=torch.channels_last))
    plan = fra.resize_argmax_plan(gh, gw, h, w)
    log("  resize_argmax %s plan: %s"
        % (label, resize_argmax_plan_line(plan, b)))
    ci_t = None if ci is None else torch.tensor(ci, device=grid.device)
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
    n_ties = int(ties.sum())
    max_err = int((got.long() - want.long()).abs().max())
    same_bits = bool(torch.equal(got, got2))
    del sel, ties, diff, got2, want
    times = {}
    for name, fn, n in (("kernel", kernel, 100), ("plain", plain, 10),
                        ("library", library, 10)):
        times[name] = (cuda_ms(fn, n), device_ms(fn, n))
    bound, bound_by = resize_argmax_bound_ms(
        b, n_sel, gh, gw, h, w, grid.element_size())
    row = {"case": label, "shape": [b, c, gh, gw, h, w],
           "dtype": str(grid.dtype).replace("torch.", ""),
           "channels_last": cl, "classes": n_sel,
           "plan": {"blocks": plan.blocks(b), "threads": plan.threads,
                    "tiles": plan.n_tiles, "band_runs": len(plan.bands)},
           "mismatches": mism, "mismatches_off_ties": off,
           "near_tie_pixels": n_ties, "max_abs_err": max_err,
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
           " channels-last" if cl else "", mism, off, n_ties, same_bits))
    log("    ms per call by events / on the device: kernel %.4f / %.4f, "
        "plain %.4f / %.4f, library %.4f / %.4f, bound %.4f (%s)"
        % (times["kernel"] + times["plain"] + times["library"]
           + (bound, bound_by)))
    check(off == 0, "resize_argmax disagrees with its plain version off "
          "ties in case %s: %d pixels" % (label, off))
    check(same_bits, "resize_argmax: two runs differ in case %s" % label)
    return got, row


def phase_kernel_checks(dev):
    """Phase 2, K1: the resize+argmax kernel against its plain version at
    the client's shapes (f32 NCHW as the f32 forward leaves it; bf16
    channels-last with the exp-25 class table, as the bf16 folded forward
    hands it over) and at the edges of its plan (96 classes, past the 32
    held in registers; one class; an output below the grid; W=1), each
    by ``k1_case``."""
    import torch
    from ams_tpu_torch import configs

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
        out.append(k1_case(label, grid, h, w, ci)[1])
        out[-1]["channels_last"] = cl
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


def write_bands_clip(root):
    """The bands clip of phases 6 and 7 as a frame directory under
    ``root`` (8 s of EXP_HW BGR frames at EXP_FPS, exp 90, with its
    labels): -> (clip directory, label directory with a slash)."""
    from ams_tpu_torch.data.video import write_synthetic_clip

    t0 = time.perf_counter()
    clip = os.path.join(root, EXP_CLIP)
    gt = os.path.join(root, "gt") + "/"
    write_synthetic_clip(clip, seconds=8, fps=EXP_FPS, size_hw=EXP_HW,
                         seed=SEED, gt_dir=gt, style="bands")
    log("  wrote %d %dx%d BGR frames and labels in %.2f s"
        % (8 * EXP_FPS, EXP_HW[0], EXP_HW[1], time.perf_counter() - t0))
    return clip, gt


def phase_experiment(dev, clip, gt):
    """Phase 6: the emulated experiment through the CLI, early then
    pretrained, on the bands clip (``write_bands_clip``)."""
    import hashlib
    import zlib

    import numpy as np
    import torch
    from ams_tpu_torch.cli import run as cli_run
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.data.image import png_encode, png_read
    from ams_tpu_torch.data.video import frame_path, frame_to_rgb
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
        n_frames = 8 * EXP_FPS
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


def device_busy(fn):
    """(wall s, device busy s, K1 device s) of one ``fn()`` call under
    torch.profiler (host and card): the device's busy time is the sum of
    its kernels' and copies' durations, K1's the resize_argmax kernel's.
    The profiler's own cost lengthens the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
        if busy > 0:
            k1 = sum(e.time_range.elapsed_us() for e in events
                     if "resize_argmax" in e.name) / 1e6
            return wall, busy, k1
        log("  torch.profiler recorded no device time; profiling again")
    check(False, "torch.profiler recorded no device time in 3 profiles")


def phase_teacher(dev, clip):
    """Phase 7: the Xception-65 teacher and the batched labeler on the
    bands clip.  Seeded weights (``init_teacher_params(SEED)``) with BN
    statistics calibrated on 8 of the clip's frames; K1 against its plain
    version on the teacher's own bf16 grid at both labeler shapes (257x513
    at batch 32, 513x1025 at batch 16); ``python -m
    ams_tpu_torch.cli.extract_labels`` at --height 256 and at full frame
    size, each with the launch counters set to 0 just before it (K1 once
    per chunk, every gt_ PNG equal to the labeler's ids); the labeler
    alone and its device busy share; the f32 labeler on the card (no K1)
    against the same labeler on the CPU; the bf16 labels against the
    f32 labels."""
    import glob

    import numpy as np
    import torch
    from ams_tpu_torch.cli import extract_labels as cli_extract
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.data.image import bgr_to_rgb, png_read
    from ams_tpu_torch.data.video import frame_path, frame_to_rgb, \
        load_gt_label
    from ams_tpu_torch.models import xception_deeplab as xd
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.runtime.labeler import auto_batch, \
        make_teacher_labeler
    from ams_tpu_torch.utils.trace import GLOBAL_TIMER

    bf16 = torch.bfloat16
    n_frames = 8 * EXP_FPS
    th = SH                                   # extract_labels --height 256
    t0 = time.perf_counter()
    bgr = [png_read(frame_path(clip, i)) for i in range(n_frames)]
    small = np.stack([frame_to_rgb(f, (th, 2 * th)) for f in bgr])
    full = np.stack([bgr_to_rgb(f) for f in bgr])
    del bgr
    log("  read the clip's %d frames in %.2f s" % (n_frames,
                                                   time.perf_counter() - t0))

    def pad(frames):
        return np.pad(frames, ((0, 0), (1, 0), (1, 0), (0, 0)),
                      mode="symmetric")

    params = xd.init_teacher_params(SEED, device=dev)
    calibrate_bn(params, torch.from_numpy(pad(small[::10])).to(dev),
                 xd.teacher_logits_nchw)
    n_params = sum(v.numel() for v in params.values())
    log("  teacher: Xception-65 OS16, %d tensors, %d parameters; BN "
        "statistics from 8 frames" % (len(params), n_params))
    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_teacher_")
    try:
        ckpt = os.path.join(tmp, "teacher.npz")
        np.savez(ckpt, **params_to_numpy(params))

        # K1 on the teacher's own bf16 grid, as the forward leaves it
        cases, forward = [], {}
        for frames in (small[:32], full[:16]):
            staged = torch.from_numpy(pad(frames)).to(dev)
            b, h, w = staged.shape[:3]
            label = "teacher %dx%d, B=%d" % (h, w, b)
            with torch.inference_mode():
                grid = xd.teacher_logits_nchw(params, staged,
                                              compute_dtype=bf16, out_hw=None)
                check(grid.dtype == bf16 and grid.shape[1] == 19,
                      "teacher grid %s %s" % (tuple(grid.shape), grid.dtype))
                log("  %s: grid %s %s, channels-last %s"
                    % (label, tuple(grid.shape), grid.dtype,
                       grid.is_contiguous(memory_format=torch.channels_last)))
                _, row = k1_case(label, grid, h, w)
                del grid

                def fast():
                    return xd.teacher_predict_fast(params, staged)

                fwd_ms = cuda_ms(fast, 5)
                log("  bf16 teacher forward + K1 on the device, %s: %.2f ms "
                    "per batch = %.1f frames/s" % (label, fwd_ms,
                                                   b * 1e3 / fwd_ms))
                forward[label] = {"device_ms": fwd_ms,
                                  "device_frames_per_s": b * 1e3 / fwd_ms}
                if not cases:
                    log("  where the device time of one %s forward goes "
                        "(torch.profiler):" % label)
                    try:
                        lines = device_breakdown(fast, top=10)
                    except (RuntimeError, AssertionError) as e:
                        lines = ["profiler unavailable: %s" % e]
                    for line in lines:
                        log("    " + line)
            cases.append(row)

        # the CLI, at --height 256 and at full frame size
        runs, labelers = {}, {}
        for name, extra, frames in (("height %d" % th, ["--height", str(th)],
                                     small),
                                    ("full size", [], full)):
            dump = os.path.join(tmp, "labels_%d" % len(runs)) + "/"
            batch = auto_batch(frames.shape[1])
            chunks = -(-n_frames // batch)
            reset_counters()
            GLOBAL_TIMER.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli_extract.main(["--input_video", clip, "--dump_path", dump,
                              "--teacher_checkpoint", ckpt] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            spans = dict(GLOBAL_TIMER.totals)
            # end to end: uint8 frames in, PNGs out, after the weights load
            loop = wall - spans.get("labeler/load", 0.0)
            log("  extract_labels, %s: %.2f s wall, %.2f s of it loading the "
                "weights; %d frames in %.2f s = %.2f frames/s end to end; "
                "auto batch %d, %d chunks; launches %s"
                % (name, wall, wall - loop, n_frames, loop, n_frames / loop,
                   batch, chunks, launches))
            log("  spans:\n" + "\n".join(
                "    " + line for line in GLOBAL_TIMER.summary().split("\n")))
            check(launches["resize_argmax"] == chunks
                  and sum(launches.values()) == chunks,
                  "%s: launches %s, want K1 once per chunk (%d) and no other"
                  % (name, launches, chunks))
            for kind in ("gt", "annot", "vis"):
                n = len(glob.glob(os.path.join(dump, kind + "_*.png")))
                check(n == n_frames, "%s: %d %s_ files, want %d"
                      % (name, n, kind, n_frames))
            if batch not in labelers:
                labelers[batch] = make_teacher_labeler(ckpt, batch=batch,
                                                       device=dev)
            label_fn = labelers[batch]
            ids = label_fn(frames)
            bad = [i for i in range(n_frames) if not np.array_equal(
                load_gt_label(dump, i), ids[i])]
            log("  %s: every gt_ PNG read back equals the labeler's ids: %s"
                " (classes present %s)" % (name, not bad,
                                           np.unique(ids).tolist()))
            check(not bad, "%s: gt_ PNGs %s differ from the labeler's ids"
                  % (name, bad[:5]))

            # the labeler alone: uint8 frames in, ids out
            part = frames[:2 * batch]
            label_fn(part)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            label_fn(part)
            alone = time.perf_counter() - t0
            p_wall, busy, k1_s = device_busy(lambda: label_fn(part))
            log("  labeler alone, %s: %d frames in %.3f s = %.1f frames/s; "
                "under torch.profiler %.3f s, the device busy %.3f s (%.1f%%),"
                " K1 %.5f s (%.2f%% of the device time)"
                % (name, len(part), alone, len(part) / alone, p_wall, busy,
                   100 * busy / p_wall, k1_s, 100 * k1_s / busy))
            runs[name] = {
                "frames": n_frames, "batch": batch, "chunks": chunks,
                "k1_launches": launches["resize_argmax"], "wall_s": wall,
                "load_s": wall - loop, "loop_s": loop,
                "end_to_end_frames_per_s": n_frames / loop,
                "read_s": spans.get("labeler/read"),
                "predict_s": spans.get("labeler/predict"),
                "write_s": spans.get("labeler/write"),
                "labeler_frames_per_s": len(part) / alone,
                "profiled_wall_s": p_wall, "device_busy_s": busy,
                "device_busy_share": busy / p_wall, "k1_device_s": k1_s}
            shutil.rmtree(dump, ignore_errors=True)

        # the f32 labeler: no K1 on the card, and the card against the CPU
        two = small[:2]
        reset_counters()
        f32_card = make_teacher_labeler(ckpt, compute_dtype="float32",
                                        batch=2, device=dev)
        ids_card = f32_card(two)
        check(fra.fused_resize_argmax.launches == 0,
              "the f32 labeler launched K1 %d times"
              % fra.fused_resize_argmax.launches)
        torch.set_num_threads(os.cpu_count() or 1)
        cpu = torch.device("cpu")
        f32_cpu = make_teacher_labeler(ckpt, compute_dtype="float32",
                                       batch=2, device=cpu)
        ids_cpu = f32_cpu(two)
        with torch.inference_mode():
            padded = torch.from_numpy(pad(two))
            ref = xd.teacher_logits_nchw(
                {k: v.cpu() for k, v in params.items()}, padded)
            got = xd.teacher_logits_nchw(params, padded.to(dev)).cpu()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        top2 = torch.topk(ref, 2, dim=1).values
        decisive = ((top2[:, 0] - top2[:, 1]) > 2 * err + TIE_MARGIN) \
            .numpy()[:, 1:, 1:]
        differ = int(((ids_card != ids_cpu) & decisive).sum())
        f32_tol = 1e-3 * max(1.0, scale)
        log("  f32 labeler, card vs CPU on 2 frames of %dx%d: logits max "
            "abs err %.3g (|logits| up to %.3g, tolerance %.3g); ids agree "
            "on %.6f, %d differ off near ties; K1 launches 0"
            % (th, 2 * th, err, scale, f32_tol,
               float((ids_card == ids_cpu).mean()), differ))
        check(err <= f32_tol and differ == 0,
              "the f32 labeler on the card differs from the CPU's")

        # bf16 labels against f32 labels on the card (random weights: not
        # a gate)
        part = small[:32]
        ids_bf16 = labelers[32](part)
        ids_f32 = make_teacher_labeler(ckpt, compute_dtype="float32",
                                       batch=32, device=dev)(part)
        agree = float((ids_bf16 == ids_f32).mean())
        log("  bf16 labels agree with the f32 labels on %.6f of pixels "
            "(32 frames of %dx%d)" % (agree, th, 2 * th))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return cases, runs, {"forward": forward,
                         "f32_card_vs_cpu_logits_max_abs_err": err,
                         "f32_card_vs_cpu_logits_scale": scale,
                         "f32_card_vs_cpu_ids_differ_off_ties": differ,
                         "bf16_vs_f32_agree": agree}


LIVE_SECONDS_BUDGET = 600    # part A's subprocesses, as a whole


def live_lines(text):
    """The server's ``[live]`` lines: -> (labels, rounds), labels as
    (t, frames, seconds) and rounds as (t, round, train s, encode s,
    payload bytes, wire)."""
    import re

    labels = [(float(t), int(n), float(s)) for t, n, s in re.findall(
        r"\[live\] t=(\d+) labeled (\d+) frames in ([\d.]+)s", text)]
    rounds = [(float(t), int(r), float(tr), float(en), int(b), w)
              for t, r, tr, en, b, w in re.findall(
                  r"\[live\] t=(\d+) round (\d+): train ([\d.]+)s encode "
                  r"([\d.]+)s payload (\d+)B \([\w_]+/(\w+)\)", text)]
    return labels, rounds


def live_checkpoints(dev, clip, root):
    """Seeded student and teacher weights with BN statistics from 8 of the
    clip's frames, saved under ``root``: -> (student directory, student
    name, teacher path)."""
    import numpy as np
    import torch
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.data.image import png_read
    from ams_tpu_torch.data.video import frame_path, frame_to_rgb
    from ams_tpu_torch.models import xception_deeplab as xd
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params

    rgb = np.stack([frame_to_rgb(png_read(frame_path(clip, i)), (SH, SW))
                    for i in range(0, 8 * EXP_FPS, EXP_FPS)])
    student = init_student_params(SEED, device=dev)
    calibrate_bn(student, torch.from_numpy(rgb).to(dev))
    sdir = os.path.join(root, "students")
    os.makedirs(sdir)
    np.savez(os.path.join(sdir, "student.npz"), **params_to_numpy(student))
    teacher = xd.init_teacher_params(SEED, device=dev)
    padded = np.pad(rgb, ((0, 0), (1, 0), (1, 0), (0, 0)), mode="symmetric")
    calibrate_bn(teacher, torch.from_numpy(padded).to(dev),
                 xd.teacher_logits_nchw)
    tpath = os.path.join(root, "teacher.npz")
    np.savez(tpath, **params_to_numpy(teacher))
    del student, teacher
    return sdir, "student.npz", tpath


def phase_live_cli(dev, clip, gt, root, sdir, sname, tpath):
    """Phase 8, part A: ``python -m ams_tpu_torch.cli.serve`` and two
    concurrent ``python -m ams_tpu_torch.cli.edge`` processes on the bands
    clip, then SIGTERM to the server."""
    import signal

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    dev_args = (["--device", "cpu"] if dev.type == "cpu"
                else ["--device", "cuda", "--gpu", str(dev.index or 0)])
    t_start = time.perf_counter()
    deadline = t_start + LIVE_SECONDS_BUDGET
    srv_log = os.path.join(root, "serve.log")
    procs = []
    try:
        with open(srv_log, "w") as out:
            srv = subprocess.Popen(
                [sys.executable, "-m", "ams_tpu_torch.cli.serve", "--port",
                 "0", "--max_clients", "2", "--resume_dir",
                 os.path.join(root, "resume"), "--checkpoint_dir", sdir,
                 "--teacher_checkpoint", tpath] + dev_args,
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
        procs.append(srv)
        port = None
        while port is None and time.perf_counter() < deadline:
            with open(srv_log) as f:
                text = f.read()
            if "ams live server on " in text:
                port = int(text.split("ams live server on ")[1].split()[0]
                           .rsplit(":", 1)[1])
            elif srv.poll() is not None:
                check(False, "serve exited rc %s:\n%s" % (srv.returncode,
                                                          text[-3000:]))
            else:
                time.sleep(0.2)
        check(port is not None, "serve never printed its address")
        log("  serve listening on port %d after %.1f s"
            % (port, time.perf_counter() - t_start))
        edges = {}
        for name, wire in (("a", "float16"), ("b", "int8d")):
            out_dir = os.path.join(root, "edge_" + name)
            log_path = out_dir + ".log"
            with open(log_path, "w") as out:
                p = subprocess.Popen(
                    [sys.executable, "-m", "ams_tpu_torch.cli.edge",
                     "--server", "127.0.0.1:%d" % port, "--input_video",
                     clip, "--gt_dir", gt, "--output_dir", out_dir,
                     "--height", str(SH), "--send_period", "2",
                     "--train_period", "4", "--iter", str(ROUND_ITERS),
                     "--batch_size", str(MINI_BATCH), "--coord_fraction",
                     str(COORD_FRAC), "--wire_dtype", wire, "--client_id",
                     name, "--student_checkpoint", sname] + dev_args,
                    cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
            procs.append(p)
            edges[name] = dict(proc=p, wire=wire, out=out_dir, log=log_path)
        for name, e in edges.items():
            try:
                rc = e["proc"].wait(max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            with open(e["log"]) as f:
                e["text"] = f.read()
            check(rc == 0, "edge %s exited rc %s:\n%s"
                  % (name, rc, e["text"][-3000:]))
        edges_s = time.perf_counter() - t_start
        srv.send_signal(signal.SIGTERM)
        try:
            rc = srv.wait(max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = None
        with open(srv_log) as f:
            srv_text = f.read()
        check(rc == 0, "serve exited rc %s after SIGTERM:\n%s"
              % (rc, srv_text[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check("served 4 rounds across 2 sessions" in srv_text,
          "serve did not report 4 rounds across 2 sessions:\n%s"
          % srv_text[-2000:])
    labels, rounds = live_lines(srv_text)
    check(len(labels) == 8 and len(rounds) == 4,
          "serve printed %d label and %d round lines, want 8 and 4"
          % (len(labels), len(rounds)))
    n_frames = 8 * EXP_FPS
    rows = {}
    for name, e in edges.items():
        text = e["text"]
        check("2 deltas applied" in text, "edge %s did not apply 2 deltas:"
              "\n%s" % (name, text[-2000:]))
        base = os.path.join(e["out"], "90_live_results")
        dn = np.load(base + "_bw_downlink.npy")
        up = np.load(base + "_bw_uplink.npy")
        fpc = np.load(base + "_fps_client.npy")
        mt = np.load(base + "_model_update_times.npy")
        scores = np.load(base + "_miou_live.npy")
        with open(base + "_update.txt") as f:
            down, upb, updates, seconds, samples = (
                int(x) for x in f.read().split("\n"))
        check(down == dn.sum() and upb == up.sum() and updates == len(dn)
              == 2 and samples == fpc.sum() and len(mt) == 3
              and seconds == 8,
              "edge %s: _update.txt %s against the .npy artifacts (down %d,"
              " up %d, %d deltas, %d samples, %d update times)"
              % (name, [down, upb, updates, seconds, samples], dn.sum(),
                 up.sum(), len(dn), fpc.sum(), len(mt)))
        check(down > 0 and upb > 0, "edge %s: bits %d down, %d up"
              % (name, down, upb))
        check(scores.shape[0] > 0 and np.isfinite(scores[:, 1]).all(),
              "edge %s: gt mIoU not finite" % name)
        streamed = [ln for ln in text.splitlines()
                    if ln.startswith("streamed ")]
        check(streamed and streamed[-1].startswith("streamed %d frames"
                                                   % n_frames),
              "edge %s: %s" % (name, streamed))
        fps = float(streamed[-1].split("(")[1].split(" fps")[0])
        # the edge's own per-second rates: the seconds it spent streaming,
        # without the end-of-stream wait for the last deltas
        stream_s = float(np.sum(EXP_FPS / np.load(base + "_wall_fps.npy")))
        rows[name] = {"wire": e["wire"], "frames_per_s": fps,
                      "streaming_frames_per_s": n_frames / stream_s,
                      "miou_mean": float(scores[:, 1].mean()),
                      "downlink_bits": down, "uplink_bits": upb,
                      "delta_bytes": [int(b) // 8 for b in dn]}
        log("  edge %s (%s): %s; %.1f frames/s while streaming; gt mIoU "
            "mean %.4f over %d scored frames; deltas %s B"
            % (name, e["wire"], streamed[-1],
               rows[name]["streaming_frames_per_s"], rows[name]["miou_mean"],
               scores.shape[0], rows[name]["delta_bytes"]))
    for t, n, s in labels:
        log("  [live] t=%.0f labeled %d frames in %.2f s" % (t, n, s))
    for t, r, tr, en, b, w in rounds:
        log("  [live] t=%.0f round %d (%s): train %.2f s encode %.2f s "
            "payload %d B" % (t, r, w, tr, en, b))
    wall = time.perf_counter() - t_start
    log("  part A: %.1f s wall (edges done after %.1f s)" % (wall, edges_s))
    return {"edges": rows, "label_s": [s for _, _, s in labels],
            "rounds": [{"t": t, "round": r, "train_s": tr, "encode_s": en,
                        "payload_bytes": b, "wire": w}
                       for t, r, tr, en, b, w in rounds],
            "wall_s": wall}


def phase_live_k1(dev, clip, sdir, sname, tpath):
    """Phase 8, part B: one live session in this process, a ``LiveServer``
    with the bf16 teacher labeler and a ``LiveClient`` on the card, with
    every launch counter set to 0 just before it."""
    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.data.image import png_read
    from ams_tpu_torch.data.video import frame_path, frame_to_rgb
    from ams_tpu_torch.models.mobilenetv2_deeplab import grid_logits_nchw
    from ams_tpu_torch.models.resize import resize_nchw
    from ams_tpu_torch.runtime import live as live_mod
    from ams_tpu_torch.runtime.labeler import auto_batch, \
        make_teacher_labeler
    from ams_tpu_torch.runtime.network import SemanticNetwork

    rgb = np.stack([frame_to_rgb(png_read(frame_path(clip, i)), (SH, SW))
                    for i in range(0, 8 * EXP_FPS, 5)])
    teacher = make_teacher_labeler(tpath, device=dev)
    batch = auto_batch(SH)
    stats = {"chunks": 0, "draws": 0}

    def labeler(frames):
        stats["chunks"] += -(-len(frames) // batch)
        stats["draws"] += 1
        return teacher(frames)

    sent = []
    encode = live_mod.encode_delta

    def capture(params, masks, **kw):
        sent.append(({k: v.copy() for k, v in params.items()},
                     {k: v.copy() for k, v in masks.items()},
                     {k: v.copy() for k, v in kw["stats"].items()}))
        return encode(params, masks, **kw)

    round_s = []
    train = SemanticNetwork.train_with_deque

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(self, *a, **kw)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return out

    live_mod.encode_delta = capture
    SemanticNetwork.train_with_deque = timed
    reset_counters()
    predicted = 0
    try:
        server = live_mod.LiveServer(labeler, device=dev,
                                     checkpoint_dir=sdir)
        server.serve_in_background()
        client = live_mod.LiveClient(
            server.address, exp_num=90, height=SH,
            strategy="coord_desc_auto", iters=ROUND_ITERS,
            batch_size=MINI_BATCH, train_period=2, coord_frac=COORD_FRAC,
            checkpoint=sname, client_id="k1", device=dev)
        initial = {k: v.copy() for k, v in client.network.get_vars().items()}
        draws = ((0.0, rgb[0:2]), (1.0, rgb[2:4]), (2.0, rgb[4:6]))
        rounds = 0
        deadline = time.perf_counter() + 300.0
        for t, frames in draws:
            client.send_samples(frames, t)
            rounds += t in (0.0, 2.0)      # train_period 2: t=0 and t=2
            # the round runs alone on the card and the host (its time is
            # the bf16 round's record); the edge infers after each draw
            while client.deltas_applied < rounds:
                check(time.perf_counter() < deadline,
                      "no delta for the draw at t=%.0f within 300 s" % t)
                got = client.poll_deltas(timeout=5.0)
                check(not client.closed, "server closed the session: %s"
                      % client.server_error)
                if not got:
                    continue
                params, masks, annex = sent[client.deltas_applied - 1]
                cli = client.network.get_vars()
                for k, m in masks.items():
                    want = params[k].astype(np.float16).astype(np.float32)
                    check(np.array_equal(cli[k][m], want[m]),
                          "delta %d: %s differs from the server's value at "
                          "float16 on the selected coordinates"
                          % (client.deltas_applied, k))
                    check(np.array_equal(cli[k][~m], initial[k][~m]),
                          "delta %d: %s moved off its initial value outside "
                          "the mask" % (client.deltas_applied, k))
                for k, v in annex.items():
                    check(np.array_equal(
                        cli[k], v.astype(np.float16).astype(np.float32)),
                        "delta %d: BN statistic %s differs from the annex"
                        % (client.deltas_applied, k))
            for f in rgb[6:8]:
                client.predict(f)
                predicted += 1
        ids = np.stack([client.predict(f) for f in rgb[8:12]])
        predicted += 4
        torch.cuda.synchronize()
        client.close()
        server.join(timeout=120.0)
    finally:
        live_mod.encode_delta = encode
        SemanticNetwork.train_with_deque = train
    launches = launch_counts()
    log("  session: %d draws (%d teacher chunks of %d), %d rounds, %d frames "
        "predicted on the card; launches %s"
        % (stats["draws"], stats["chunks"], batch, len(sent), predicted,
           launches))
    check(len(sent) == 2 and client.deltas_applied == 2,
          "%d deltas sent, %d applied, want 2" % (len(sent),
                                                  client.deltas_applied))
    check(launches["resize_argmax"] == stats["chunks"] + predicted,
          "K1 launched %d times; the labeler's %d chunks and the %d frames "
          "predicted make %d" % (launches["resize_argmax"], stats["chunks"],
                                 predicted, stats["chunks"] + predicted))
    others = {k: v for k, v in launches.items() if k != "resize_argmax"}
    check(not any(others.values()), "other kernels launched: %s" % others)

    srv = server.final_vars["k1"]
    cli = client.network.get_vars()
    checked = 0
    for k, sv in srv.items():
        if "moving_" in k:
            check(np.array_equal(cli[k], sv.astype(np.float16)
                                 .astype(np.float32)),
                  "final BN statistic %s differs from final_vars" % k)
            continue
        changed = cli[k] != initial[k]
        if changed.any():
            check(np.allclose(cli[k][changed], sv[changed], rtol=2e-3,
                              atol=2e-3),
                  "final %s differs from final_vars beyond float16" % k)
            checked += int(changed.sum())
    check(checked > 0, "no coordinate changed")

    # the card's client against a CPU client from the same params, as
    # phase 7 holds the f32 labeler: the f32 logits of the two devices
    # within 1e-3 of their scale, and equal ids wherever the CPU's top-2
    # margin exceeds twice the largest logit difference
    cpu = SemanticNetwork(cli, configs.class_weights(90), height=SH,
                          frozen=True, device="cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_ids = cpu.predict_input(rgb[8:12])
    ci = list(configs.class_indices(90))
    with torch.no_grad():
        def logits(params, d):
            grid = grid_logits_nchw(params, torch.from_numpy(rgb[8:12])
                                    .to(d))
            return resize_nchw(grid[:, ci].float(), (SH, SW)).cpu()
        ref = logits(cpu.params, torch.device("cpu"))
        err = float((logits(client.network.params, dev) - ref).abs().max())
        top2 = torch.topk(ref, 2, dim=1).values
        decisive = ((top2[:, 0] - top2[:, 1]) > 2 * err + TIE_MARGIN).numpy()
    scale = float(ref.abs().max())
    mism = ids != cpu_ids
    off_ties = int((mism & decisive).sum())
    log("  card client against a CPU client, 4 frames: logits max abs err "
        "%.3g (|logits| up to %.3g, tolerance %.3g); %d ids differ, %d where "
        "the top-2 margin exceeds twice that; final params within float16 "
        "of final_vars on %d changed coordinates"
        % (err, scale, 1e-3 * max(1.0, scale), int(mism.sum()), off_ties,
           checked))
    check(err <= 1e-3 * max(1.0, scale) and off_ties == 0,
          "the card's client differs from the CPU client's")
    iters = ROUND_ITERS
    log("  bf16 rounds: %s s (%s ms per iteration)"
        % (["%.3f" % s for s in round_s],
           ["%.2f" % (1e3 * s / iters) for s in round_s]))
    return {"k1_launches": launches["resize_argmax"],
            "chunks": stats["chunks"], "frames_predicted": predicted,
            "draws": stats["draws"], "round_s": round_s,
            "ms_per_iteration": [1e3 * s / iters for s in round_s],
            "mismatches": int(mism.sum()), "mismatches_off_ties": off_ties,
            "cpu_logits_max_abs_err": err,
            "checked_coordinates": checked}


def phase_live(dev, clip, gt):
    """Phase 8: the live runtime on the bands clip (see the module
    docstring): -> (part A's record, part B's record)."""
    root = tempfile.mkdtemp(prefix="ams_chip_smoke_live_")
    try:
        t0 = time.perf_counter()
        sdir, sname, tpath = live_checkpoints(dev, clip, root)
        log("  calibrated student and teacher saved in %.1f s"
            % (time.perf_counter() - t0))
        cli_rec = phase_live_cli(dev, clip, gt, root, sdir, sname, tpath)
        k1_rec = phase_live_k1(dev, clip, sdir, sname, tpath)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return cli_rec, k1_rec


MV_VIDEOS = (25, 22, 12, 17)   # class subsets that differ (union of 7)
MV_FRAMES = 20           # clip frames in each video's memory
MV_ITERS, MV_KEEP_ITERS = 200, 20   # the round, then one with keep_mask
MV_CHECK_ITERS = 6       # the multi- against single-video comparison
MV_CLIENT_FRAMES = 8     # frames the deployed client predicts, one by one
DP_WORLD, DP_ITERS = 2, 6    # the minibatch-parallel round's ranks, iterations
# its cases: coord_desc_auto over DP_ITERS from warm Adam slots, with and
# without K2; full_model for one iteration from zero slots, where the BN
# moving statistics and the weights have tests/test_sharded_round.py's
# tight gates
DP_CASES = {"fused": dict(strategy="coord_desc_auto", fused_loss=True),
            "gather": dict(strategy="coord_desc_auto", fused_loss=False),
            "full_model": dict(strategy="full_model", fused_loss=False,
                               iters=1)}
DP_BN_KEYS = ("MobilenetV2/Conv/BatchNorm/moving_mean",
              "concat_projection/BatchNorm/moving_variance")
DP_MEMORY = 16           # frames in its buffers
DP_TIMEOUT_S = 300       # per rank process
# phase 11: width partitioning (the mesh's model axis), every shard on the
# card; its ranks run with phase 9 part B's data, cases and reference
WIDTH_MODEL = 2          # shards per mesh row
WIDTH_TIME_ITERS = 20    # the partitioned round against the unpartitioned
WIDTH_LABEL_B = 4        # the labeler's batch of 257x513 frames
WIDTH_LABEL_AGREE = 0.999   # tests/test_sharded_labeler.py's bar
WIDTH_LOGIT_RTOL = 1e-3  # f32 logits, partitioned against whole
DETERMINISM_ITERS = 6    # each form of the round, run twice to the bit
# SHA-256 of cv2.imdecode's pixels of png_filtered(decode_probe_frame(), k)
# for k = 3 (Average) and 4 (Paeth), recorded from OpenCV by
# tests/test_torch_repaired_faults.py: the frame itself
DECODE_PROBE = ("018f67d035ef33ebde7983579a39de49"
                "5b9cc51a4183a8b77ba3319ab1dccf7f")


def video_slice(tree, j):
    """Video ``j``'s slice of a stacked parameter, mask or AdamState
    tree."""
    if isinstance(tree, dict):
        return {k: v[j] for k, v in tree.items()}
    return type(tree)(*[video_slice(x, j) if isinstance(x, dict) else x[j]
                        for x in tree])


def tree_max_abs_diff(a, b):
    """max |a - b| over the tensors of two trees of the same keys."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def phase_multi_video(dev, clip):
    """Phase 9, part A: the multi-video server on the card (see the module
    docstring) -> (its record, the calibrated teacher, the clip's frames
    at SHxSW), the last two for phase 11."""
    import dataclasses

    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.data.image import png_read
    from ams_tpu_torch.data.video import frame_path, frame_to_rgb
    from ams_tpu_torch.distill.train_step import make_distill_round
    from ams_tpu_torch.models import xception_deeplab as xd
    from ams_tpu_torch.parallel import (
        make_mesh,
        make_multi_video_round,
        make_sharded_labeler,
    )
    from ams_tpu_torch.runtime.multi_server import MultiVideoServer
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.stream.codec import decode_delta

    n_frames = 8 * EXP_FPS
    t_setup = time.perf_counter()
    rgb = np.stack([frame_to_rgb(png_read(frame_path(clip, i)), (SH, SW))
                    for i in range(n_frames)])
    # phase 7's teacher: seeded, BN statistics from frames 0, 10, ..., 70
    teacher = xd.init_teacher_params(SEED, device=dev)
    padded = np.pad(rgb[::EXP_FPS], ((0, 0), (1, 0), (1, 0), (0, 0)),
                    mode="symmetric")
    calibrate_bn(teacher, torch.from_numpy(padded).to(dev),
                 xd.teacher_logits_nchw)
    mesh = make_mesh(1, device=dev)
    label = make_sharded_labeler(mesh, teacher)
    staged = torch.from_numpy(rgb).to(dev)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = label(staged)
    torch.cuda.synchronize()
    label_s = time.perf_counter() - t0
    label_counts = launch_counts()
    with torch.inference_mode():
        want = xd.teacher_predictions(teacher, staged,
                                      compute_dtype=torch.bfloat16)
    check(ids.shape == (n_frames, SH, SW) and torch.equal(ids, want),
          "the sharded labeler's ids differ from teacher_predictions")
    check(not any(label_counts.values()),
          "the labeler launched kernels: %s" % label_counts)
    labels = ids.cpu().numpy().astype(np.uint8)
    del staged, want
    log("  labeled %d frames of %dx%d in %.2f s over %s (bf16, %d classes "
        "present); ids equal to teacher_predictions; no kernel launched; "
        "clip, teacher and labels %.2f s"
        % (n_frames, SH, SW, label_s, mesh, len(np.unique(labels)),
           time.perf_counter() - t_setup))

    srv = MultiVideoServer(video_ids=MV_VIDEOS, height=SH,
                           batch_size=MINI_BATCH, lr=LR,
                           strategy="coord_desc_auto", coord_frac=COORD_FRAC,
                           device=dev)
    check(srv.spec.compute_dtype == "bfloat16" and len(
        srv.class_indices) == 7, "server spec %s" % (srv.spec,))
    for v in range(srv.V):
        srv.ingest(v, list(rgb[v::srv.V][:MV_FRAMES]),
                   list(labels[v::srv.V][:MV_FRAMES]))
    n_train = sum(x[0].numel() for k, x in srv.params_V.items()
                  if "moving_" not in k)
    log("  server: %d videos (exps %s) on %s, class union %s, %d trainable "
        "coordinates per video, %d frames each"
        % (srv.V, list(MV_VIDEOS), srv.mesh, srv.class_indices, n_train,
           MV_FRAMES))

    # video 0 of a short multi-video round against a single-video round
    # from the same state, generator and class mask
    frames_V = [torch.from_numpy(m.stacked()[0]).to(dev)
                for m in srv.memories]
    labels_V = [torch.from_numpy(m.stacked()[1]).to(dev)
                for m in srv.memories]
    n_valid = [len(m) for m in srv.memories]
    spec = dataclasses.replace(srv.spec, iters=MV_CHECK_ITERS)

    def gens():
        return [torch.Generator(device=dev).manual_seed(1000 + j)
                for j in range(srv.V)]

    t0 = time.perf_counter()
    mv = make_multi_video_round(spec, srv.mesh, with_class_mask=True)(
        srv.params_V, srv.opt_V, frames_V, labels_V, n_valid, gens(), LR,
        srv.mask_V, srv.class_mask_V)
    single = make_distill_round(spec)(
        video_slice(srv.params_V, 0), video_slice(srv.opt_V, 0),
        frames_V[0], labels_V[0], n_valid[0], gens()[0], LR,
        video_slice(srv.mask_V, 0), class_mask=srv.class_mask_V[0])
    check_s = time.perf_counter() - t0
    p_mv = {k: v[0] for k, v in mv[0].items()}
    bitwise = all(torch.equal(p_mv[k], single[0][k]) for k in p_mv) \
        and torch.equal(mv[3][0], single[3]) \
        and all(torch.equal(mv[2][k][0], single[2][k]) for k in single[2])
    param_diff = tree_max_abs_diff(p_mv, single[0])
    loss_diff = float((mv[3][0] - single[3]).abs().max())
    log("  video 0 of a %d-iteration multi-video round against a single-"
        "video round (both in %.2f s): bitwise %s; "
        "max |d param| %.3g, max |d loss| %.3g"
        % (MV_CHECK_ITERS, check_s, bitwise, param_diff, loss_diff))
    check(bitwise or (loss_diff <= 1e-3 * float(single[3].abs().max())
                      and param_diff <= 2.05 * LR * MV_CHECK_ITERS),
          "video 0 of the multi-video round disagrees with the single-"
          "video round")
    del mv, single

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = srv.train_round(iters=MV_ITERS)
    round_s = time.perf_counter() - t0
    masks_1 = {k: v.clone() for k, v in srv.mask_V.items()}
    # one video's round alone over as many iterations, in this call (before
    # the profiled round: the profiler's hooks may outlive it)
    one_round = make_distill_round(dataclasses.replace(srv.spec,
                                                       iters=MV_ITERS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round(video_slice(srv.params_V, 0), video_slice(srv.opt_V, 0),
              frames_V[0], labels_V[0], n_valid[0], gens()[0], LR,
              video_slice(srv.mask_V, 0), class_mask=srv.class_mask_V[0])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    # the keep_mask round under a CUDA-only profile: the device's busy
    # share is its kernels' and copies' time over the round's wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses_keep = srv.train_round(iters=MV_KEEP_ITERS, keep_mask=True)
        torch.cuda.synchronize()
        keep_s = time.perf_counter() - t0
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    if busy_s == 0:
        log("  torch.profiler recorded no device time: busy share not "
            "measured")
    check(losses.shape == (srv.V, MV_ITERS) and np.isfinite(losses).all(),
          "multi-video losses %s" % (losses.shape,))
    check(losses_keep.shape == (srv.V, MV_KEEP_ITERS)
          and np.isfinite(losses_keep).all(), "keep_mask losses")
    check(all(torch.equal(masks_1[k], v) for k, v in srv.mask_V.items()),
          "the keep_mask round changed the masks")
    w = srv.params_V["logits/semantic/weights"]
    check(all(not torch.equal(w[a], w[b]) for a in range(srv.V)
              for b in range(a)), "two videos hold the same parameters")
    shares = []
    for v in range(srv.V):
        host = srv.video_params(v)
        dm, _ = decode_delta(srv.encode_delta(v),
                             {k: x.shape for k, x in host.items()},
                             strategy="coord_desc_auto")
        tk = [k for k in dm if "moving_" not in k]
        shares.append(sum(int(dm[k].sum()) for k in tk)
                      / sum(dm[k].size for k in tk))
    check(all(0.05 < x < 0.15 for x in shares),
          "selected shares of the deltas %s" % shares)


    # save_state / load_state round trip, bitwise
    root = tempfile.mkdtemp(prefix="ams_chip_smoke_mv_")
    try:
        prefix = os.path.join(root, "mv")
        t0 = time.perf_counter()
        srv.save_state(prefix)
        save_s = time.perf_counter() - t0
        back = MultiVideoServer(video_ids=MV_VIDEOS, height=SH,
                                batch_size=MINI_BATCH, lr=LR,
                                strategy="coord_desc_auto",
                                coord_frac=COORD_FRAC, seed=SEED + 1,
                                device=dev)
        check(back.load_state(prefix), "load_state found no bundle")
        same = all(torch.equal(back.params_V[k], v)
                   for k, v in srv.params_V.items()) \
            and all(torch.equal(back.mask_V[k], v)
                    for k, v in srv.mask_V.items()) \
            and torch.equal(back.opt_V.step, srv.opt_V.step) \
            and all(torch.equal(back.opt_V.m[k], srv.opt_V.m[k])
                    and torch.equal(back.opt_V.v[k], srv.opt_V.v[k])
                    for k in srv.opt_V.m) \
            and np.array_equal(back._rng, srv._rng) \
            and all(np.array_equal(a.stacked()[i], b.stacked()[i])
                    for a, b in zip(back.memories, srv.memories)
                    for i in (0, 1))
        check(same, "save_state/load_state is not bitwise")
        del back

        # video 0's deployed artifact on the frozen f32 client, K1 counted
        path = os.path.join(root, "client0")
        srv.deploy(0, path)
        client = SemanticNetwork(path + ".npz",
                                 configs.class_weights(MV_VIDEOS[0]),
                                 height=SH, frozen=True, device=dev)
        reset_counters()
        preds = [client.predict_input(rgb[i:i + 1])
                 for i in range(MV_CLIENT_FRAMES)]
        torch.cuda.synchronize()
        client_counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_sel = len(configs.class_indices(MV_VIDEOS[0]))
    check(all(p.shape == (1, SH, SW) and p.min() >= 0 and p.max() < n_sel
              for p in preds), "deployed client ids")
    check(client_counts["resize_argmax"] == MV_CLIENT_FRAMES
          and sum(client_counts.values()) == MV_CLIENT_FRAMES,
          "the deployed client launched %s for %d frames"
          % (client_counts, MV_CLIENT_FRAMES))
    rec = {"videos": list(MV_VIDEOS), "frames_per_video": MV_FRAMES,
           "label_s": label_s, "label_launches": label_counts,
           "check_bitwise": bitwise, "check_s": check_s,
           "check_param_diff": param_diff, "check_loss_diff": loss_diff,
           "round_s": round_s, "iters": MV_ITERS,
           "ms_per_video_iteration": 1e3 * round_s / (srv.V * MV_ITERS),
           "keep_round_s": keep_s,
           "single_round_s": single_s,
           "single_ms_per_iteration": 1e3 * single_s / MV_ITERS,
           "keep_busy_s": busy_s,
           "busy_share": busy_s / keep_s if busy_s else None,
           "selected_shares": shares, "save_s": save_s,
           "first_losses": losses[:, 0].tolist(),
           "last_losses": losses_keep[:, -1].tolist(),
           "client_launches": client_counts}
    log("  %d iterations for %d videos in %.2f s: %.2f ms per video-"
        "iteration, against %.2f ms per iteration of one video's round of "
        "as many alone (%.2f s); keep_mask round of %d in %.2f s under a CUDA "
        "profile, the device busy %.2f s of it (%s); delta shares %s; "
        "bundle saved in %.2f s, loaded bitwise; deployed client K1 %d "
        "launches for %d frames"
        % (MV_ITERS, srv.V, round_s, rec["ms_per_video_iteration"],
           rec["single_ms_per_iteration"], single_s,
           MV_KEEP_ITERS, keep_s, busy_s,
           "not measured" if not busy_s
           else "%.1f%%" % (100 * rec["busy_share"]),
           ["%.4f" % x for x in shares], save_s,
           client_counts["resize_argmax"], MV_CLIENT_FRAMES))
    return rec, teacher, rgb


def dp_spec(case, idx):
    """The spec of a case of DP_CASES; ``idx`` (iterations, minibatch) sets
    its minibatch and, unless the case names its own, its iterations."""
    from ams_tpu_torch import configs
    from ams_tpu_torch.distill.train_step import DistillSpec

    kw = dict(DP_CASES[case])
    kw.setdefault("iters", idx.shape[0])
    return DistillSpec(batch_size=idx.shape[1], num_classes=19,
                       class_indices=tuple(int(c) for c in
                                           configs.class_indices(0)),
                       coord_frac=COORD_FRAC, compute_dtype="float32", **kw)


def dp_round(round_fn, data, dev, case):
    """One round of ``round_fn`` on the saved student and buffers, from the
    saved Adam slots (zero slots for full_model) -> {name: numpy array}
    (params, masks, losses)."""
    import numpy as np
    import torch
    from ams_tpu_torch.convert import adam_state_from_numpy, \
        params_from_numpy
    from ams_tpu_torch.distill.optimizer import adam_init
    from ams_tpu_torch.distill.train_step import all_true_mask, split_params

    def part(prefix):
        return {k[len(prefix):]: v for k, v in data.items()
                if k.startswith(prefix)}

    params = params_from_numpy(part("param:"), dev)
    opt = adam_init(split_params(params)[0]) if case == "full_model" \
        else adam_state_from_numpy(data["opt:step"], part("optm:"),
                                   part("optv:"), dev)
    p, _, m, losses = round_fn(
        params, opt,
        torch.from_numpy(data["frames"]).to(dev),
        torch.from_numpy(data["labels"]).to(dev), len(data["frames"]), None,
        LR,
        all_true_mask(params), idx_seq=data["idx"])
    out = {"losses": losses.cpu().numpy()}
    out.update({"param:" + k: v.cpu().numpy() for k, v in p.items()})
    out.update({"mask:" + k: v.cpu().numpy() for k, v in m.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def dp_rank_main(argv):
    """A rank of phase 9, part B (``--dp-rank``): the minibatch-parallel
    round of every case of DP_CASES, each with every kernel's launch count
    set to 0 just before it and read just after -> one .npz.  With
    ``--dp-model M`` above 1 (phase 11), rank r also partitions its width
    over row r of a (world, M) mesh whose every entry is this rank's
    device."""
    import argparse

    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ams_tpu_torch.parallel import init_multi_host, \
        make_sharded_distill_round
    from ams_tpu_torch.parallel.mesh import Mesh
    from ams_tpu_torch.utils.platform import resolve_device

    ap = argparse.ArgumentParser()
    for flag in ("--dp-rank", "--dp-world", "--dp-port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--dp-model", type=int, default=1)
    for flag in ("--dp-device", "--dp-data", "--dp-out", "--dp-backend"):
        ap.add_argument(flag, required=True)
    a = ap.parse_args(argv)
    dev = resolve_device(a.dp_device)
    world = init_multi_host("localhost:%d" % a.dp_port, a.dp_world,
                            a.dp_rank, backend=a.dp_backend)
    check(world == a.dp_world, "world size %d" % world)
    mesh = Mesh([[dev] * a.dp_model] * world) if a.dp_model > 1 else None
    with np.load(a.dp_data) as z:
        data = {k: z[k] for k in z.files}
    res = {}
    try:
        for case in DP_CASES:
            fn = make_sharded_distill_round(dp_spec(case, data["idx"]),
                                            mesh)
            reset_counters()
            t0 = time.perf_counter()
            out = dp_round(fn, data, dev, case)
            out["round_s"] = np.float64(time.perf_counter() - t0)
            out.update({"launches:" + k: np.int64(n)
                        for k, n in launch_counts().items()})
            res.update({case + "/" + k: v for k, v in out.items()})
    finally:
        dist.destroy_process_group()
    np.savez(a.dp_out, **res)
    return 0


def phase_data_parallel(dev):
    """Phase 9, part B: the minibatch-parallel round on two gloo ranks that
    share the card, and one rank on the device's backend (NCCL on the card),
    against the single-device round, for every case of DP_CASES; and,
    meanwhile, phase 11 (a): two more gloo ranks that also partition their
    width over a 2-device row of the card -> its record, phase 11 (a)'s
    under "width"."""
    import socket

    import numpy as np
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.distill.train_step import make_distill_round
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params

    frames = synthetic_frames(DP_MEMORY, SH, SW, SEED + 20)
    # labels with the frames' structure: the red channel in 19 bands
    labels = np.minimum(frames[..., 0] // 14, 18).astype(np.uint8)
    idx = np.random.RandomState(SEED).randint(0, DP_MEMORY,
                                              (DP_ITERS, MINI_BATCH))
    data = {"frames": frames, "labels": labels, "idx": idx}
    params = params_to_numpy(init_student_params(SEED, device="cpu"))
    data.update({"param:" + k: v for k, v in params.items()})
    # warm Adam slots keep coord_desc_auto's selection off the tie cluster
    # of a first step from zero slots, where |delta| ~ 3.16 lr_t for most
    # coordinates and rounding alone decides the cut
    rng = np.random.RandomState(SEED + 1)
    data["opt:step"] = np.int32(10)
    for k, v in params.items():
        if "moving_" not in k:
            data["optm:" + k] = (rng.randn(*v.shape) * 1e-3).astype(
                np.float32)
            data["optv:" + k] = rng.uniform(1e-7, 1e-5, v.shape).astype(
                np.float32)
    root = tempfile.mkdtemp(prefix="ams_chip_smoke_dp_")
    try:
        path = os.path.join(root, "data.npz")
        np.savez(path, **data)

        def launch(name, world, backend, model=1):
            with socket.socket() as sk:
                sk.bind(("localhost", 0))
                port = sk.getsockname()[1]
            outs = [os.path.join(root, "%s_%d.npz" % (name, r))
                    for r in range(world)]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 str(r), "--dp-world", str(world), "--dp-port", str(port),
                 "--dp-model", str(model),
                 "--dp-device", str(dev), "--dp-data", path, "--dp-out",
                 outs[r], "--dp-backend", backend], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT) for r in range(world)]
            return procs, outs

        t0 = time.perf_counter()
        # NCCL refuses two ranks on one card: those two talk over gloo; the
        # one rank takes the device's own backend (NCCL on the card)
        runs = {"gloo": launch("gloo", DP_WORLD, "gloo"),
                "one": launch("one", 1,
                              "nccl" if dev.type == "cuda" else "gloo"),
                "width": launch("width", DP_WORLD, "gloo", WIDTH_MODEL)}
        # the single-device round on the card meanwhile, with
        # deterministic algorithms off, as in the ranks
        ref, ref_s = {}, {}
        for case in DP_CASES:
            t1 = time.perf_counter()
            ref[case] = dp_round(make_distill_round(dp_spec(case, idx)),
                                 data, dev, case)
            ref_s[case] = time.perf_counter() - t1
        results = {}
        try:
            for backend, (procs, outs) in runs.items():
                for r, p in enumerate(procs):
                    try:
                        text = p.communicate(timeout=DP_TIMEOUT_S)[0]
                    except subprocess.TimeoutExpired:
                        p.kill()
                        text = p.communicate()[0]
                    text = text.decode(errors="replace")
                    check(p.returncode == 0, "%s rank %d exited %s:\n%s"
                          % (backend, r, p.returncode, text[-3000:]))
                results[backend] = []
                for o in outs:
                    with np.load(o) as z:
                        results[backend].append({k: z[k] for k in z.files})
        finally:
            for procs, _ in runs.values():
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rec = {"ranks_s": ranks_s, "world": DP_WORLD, "width": {}}
    for group in ("gloo", "width"):
        r0, r1 = results[group]
        check(set(r0) == set(r1) and all(np.array_equal(r0[k], r1[k])
                                         for k in r0
                                         if not k.endswith("/round_s")),
              "the two %s ranks' outputs differ" % group)
        for case in DP_CASES:
            got = {k.split("/", 1)[1]: v for k, v in r0.items()
                   if k.startswith(case + "/")}
            gates = dp_case_gates(case, idx, got, ref[case],
                                  "%d %s ranks" % (DP_WORLD, group))
            gates.update({"round_s_per_rank": [float(r[case + "/round_s"])
                                               for r in (r0, r1)],
                          "single_device_round_s": ref_s[case]})
            if group == "width":
                rec["width"][case] = gates
                log("  phase 11 (a), %s (%d iterations): %d gloo ranks, "
                    "each over a %d-shard row of the card (mesh data %d x "
                    "model %d), against the single-device round: loss rel "
                    "%s, masks agree %.6f, BN moving statistics at most "
                    "%.3g of tests/test_sharded_round.py's tolerance, "
                    "weights within %.3g; ranks equal to the bit; per rank "
                    "%s; the round %s s on the ranks, %.2f s on the device "
                    "alone" % (case, gates["iters"], DP_WORLD, WIDTH_MODEL,
                               DP_WORLD, WIDTH_MODEL,
                               ["%.2g" % x for x in gates["loss_rel"]],
                               gates["mask_agreement"],
                               gates["bn_stat_gap_in_tolerances"],
                               gates["weight_max_abs_diff"],
                               gates["launches_per_rank"],
                               ["%.2f" % x
                                for x in gates["round_s_per_rank"]],
                               ref_s[case]))
                continue
            one = {k.split("/", 1)[1]: v for k, v in
                   results["one"][0].items() if k.startswith(case + "/")}
            nccl_bitwise = all(np.array_equal(one[k], ref[case][k])
                               for k in ref[case])
            check(nccl_bitwise, "%s: the one rank is not the single-device "
                  "round to the bit" % case)
            gates.update({"one_rank_bitwise": nccl_bitwise,
                          "one_rank_round_s": float(one["round_s"])})
            rec[case] = gates
            log("  %s (%d iterations): %d ranks (gloo, one card) against the "
                "single-device round: loss rel %s, masks agree %.6f, BN "
                "moving statistics at most %.3g of tests/test_sharded_"
                "round.py's tolerance, weights within %.3g; ranks equal to "
                "the bit; per rank %s; one rank (the device's backend) equal "
                "to the single-device round to the bit: %s; the round %s s "
                "on the ranks, %.2f s on one rank, %.2f s on the device "
                "alone (the first call of each process includes its "
                "warm-up)"
                % (case, gates["iters"], DP_WORLD,
                   ["%.2g" % x for x in gates["loss_rel"]],
                   gates["mask_agreement"],
                   gates["bn_stat_gap_in_tolerances"],
                   gates["weight_max_abs_diff"], gates["launches_per_rank"],
                   nccl_bitwise,
                   ["%.2f" % x for x in gates["round_s_per_rank"]],
                   gates["one_rank_round_s"], ref_s[case]))
    return rec


def dp_case_gates(case, idx, got, want, who):
    """tests/test_sharded_round.py's gates of one case of DP_CASES, a
    rank's results ``got`` against the single-device round's ``want``, and
    the rank's launch counts (K2 loss+grad once per iteration with the
    fused loss, no other kernel) -> the measures."""
    import numpy as np

    spec = dp_spec(case, idx)
    loss_rel = np.abs(got["losses"] - want["losses"]) / np.abs(
        want["losses"])
    masks = [k for k in want if k.startswith("mask:")]
    agree = sum(int((got[k] == want[k]).sum()) for k in masks) \
        / sum(want[k].size for k in masks)
    # BN moving statistics: the largest gap over every BN, in units of
    # tests/test_sharded_round.py's tolerance (atol 1e-6 + rtol 1e-4)
    stat_tol = max(float(np.max(np.abs(got[k] - want[k])
                                / (1e-6 + 1e-4 * np.abs(want[k]))))
                   for k in want if "moving_" in k)
    weight_diff = max(float(np.max(np.abs(got[k] - want[k])))
                      for k in want if k.startswith("param:")
                      and "moving_" not in k)
    if spec.strategy == "full_model":
        # tests/test_sharded_round.py:66-80: one iteration from zero
        # slots; the weights within one Adam step of each other
        check(loss_rel[0] <= 1e-5 and all(
            np.allclose(got["param:" + k], want["param:" + k],
                        rtol=1e-4, atol=1e-6) for k in DP_BN_KEYS)
              and weight_diff <= 2 * LR * 3.2 + 1e-6,
              "%s: %s against one device: loss rel %s, BN statistics %.3g "
              "of the tolerance, weights %.3g apart"
              % (case, who, loss_rel.tolist(), stat_tol, weight_diff))
    else:
        # tests/test_sharded_round.py:101-107
        check(loss_rel[0] <= 1e-5 and loss_rel.max() <= 1e-3
              and agree > 0.999,
              "%s: %s against one device: loss rel %s, mask agreement %.6f"
              % (case, who, loss_rel.tolist(), agree))
    counts = {k[len("launches:"):]: int(v) for k, v in got.items()
              if k.startswith("launches:")}
    k2 = spec.iters if spec.fused_loss else 0
    check(counts == dict(dict.fromkeys(counts, 0), resize_ce_loss_grad=k2),
          "%s: %s: a rank launched %s (K2 loss+grad expected %d times, no "
          "other kernel)" % (case, who, counts, k2))
    return {"iters": spec.iters, "loss_rel": loss_rel.tolist(),
            "mask_agreement": agree, "bn_stat_gap_in_tolerances": stat_tol,
            "weight_max_abs_diff": weight_diff, "launches_per_rank": counts}


def decode_probe_frame(seed=SEED):
    """A fixed 512x1024 BGR frame from integer arithmetic and the legacy
    RandomState stream only: smooth ramps, which the Average and Paeth
    predictors fit, and a band of noise."""
    import numpy as np

    yy, xx = np.mgrid[0:512, 0:1024]
    frame = np.stack([(xx // 4 + yy // 8) % 256, (xx * yy // 512) % 256,
                      (yy // 2 + xx // 7) % 256], -1).astype(np.uint8)
    frame[200:260] = np.random.RandomState(seed).randint(
        0, 256, (60, 1024, 3))
    return frame


def png_filtered(img, kind):
    """A PNG of an (H, W, 3) BGR frame with every row filtered by ``kind``
    (3: Average, 4: Paeth), deflated by zlib at level 6: the rows that
    cv2's writer never makes and other writers do."""
    import struct
    import zlib

    import numpy as np

    h, w, c = img.shape
    raw = np.ascontiguousarray(img[..., ::-1]).reshape(h, w * c).astype(
        np.int32)
    left, up, upleft = (np.zeros_like(raw) for _ in range(3))
    left[:, c:], up[1:], upleft[1:, c:] = raw[:, :-c], raw[:-1], \
        raw[:-1, :-c]
    if kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = (raw - pred) & 0xFF

    def chunk(kind_, body):
        return (struct.pack(">I", len(body)) + kind_ + body
                + struct.pack(">I", zlib.crc32(kind_ + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def phase_width(dev, teacher, rgb, ranks):
    """Phase 11, width partitioning on the card (``ranks``: part (a)'s
    two gloo ranks, from ``phase_data_parallel``): the partitioned round's
    time against the unpartitioned one's and its largest shard; (b) the
    labeler over a one-row mesh with a model axis; (c) the repaired
    faults: the round rerun to the bit with deterministic algorithms off,
    and the native PNG decode of Average and Paeth rows -> its record."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    from ams_tpu_torch.data import image
    from ams_tpu_torch.distill.optimizer import adam_init
    from ams_tpu_torch.distill.train_step import all_true_mask, \
        make_distill_round, split_params
    from ams_tpu_torch.models import mobilenetv2_deeplab as sm
    from ams_tpu_torch.models import xception_deeplab as xd
    from ams_tpu_torch.native import png as native_png
    from ams_tpu_torch.parallel import make_sharded_distill_round, \
        make_sharded_labeler, spatial
    from ams_tpu_torch.parallel.mesh import Mesh

    rec = {"ranks": ranks}
    mesh = Mesh([[dev] * WIDTH_MODEL])
    frames = synthetic_frames(DP_MEMORY, SH, SW, SEED + 20)
    labels = np.minimum(frames[..., 0] // 14, 18).astype(np.uint8)
    frames_d = torch.from_numpy(frames).to(dev)
    labels_d = torch.from_numpy(labels).to(dev)
    idx = np.random.RandomState(SEED + 2).randint(
        0, DP_MEMORY, (WIDTH_TIME_ITERS, MINI_BATCH))
    params = sm.init_student_params(SEED, device=dev)

    def run(round_fn, spec):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = round_fn(params, adam_init(split_params(params)[0]), frames_d,
                       labels_d, DP_MEMORY, None, LR, all_true_mask(params),
                       idx_seq=idx[:spec.iters])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / spec.iters, out, \
            launch_counts()

    # the partitioned round against the unpartitioned one on one rank:
    # phase 4's round (coord_desc_auto, fused loss, f32), in turns
    spec = dp_spec("fused", idx)
    rounds = {"unpartitioned": make_distill_round,
              "partitioned": lambda sp: make_sharded_distill_round(sp, mesh)}
    for name, make in rounds.items():
        run(make(dataclasses.replace(spec, iters=2)),
            dataclasses.replace(spec, iters=2))              # warm-up
    times = {name: [] for name in rounds}
    outs = {}
    for name in ("unpartitioned", "partitioned", "partitioned",
                 "unpartitioned"):
        ms, outs[name], counts = run(rounds[name](spec), spec)
        times[name].append(ms)
        check(counts == dict(dict.fromkeys(counts, 0),
                             resize_ce_loss_grad=spec.iters),
              "%s round launched %s" % (name, counts))
    lu, lp = (outs[n][3].cpu().numpy() for n in ("unpartitioned",
                                                 "partitioned"))
    loss_rel = np.abs(lp - lu) / np.abs(lu)
    check(loss_rel[0] <= 1e-5 and np.isfinite(lp).all(),
          "the partitioned round's first loss %s against %s" % (lp[0],
                                                                lu[0]))
    rec.update({"time_iters": spec.iters, "ms_per_iteration": times,
                "time_loss_rel_first": float(loss_rel[0]),
                "time_loss_rel_max": float(loss_rel.max())})

    # the largest activation of one rank's share of the minibatch (5
    # frames) in a train-mode forward, whole and its largest shard
    conv_columns = spatial.conv_columns
    largest = [0, 0]

    def recording(*a, **kw):
        out = conv_columns(*a, **kw)
        sizes = [p.numel() * p.element_size() for p in out.parts]
        if sum(sizes) > largest[0]:
            largest[:] = [sum(sizes), max(sizes)]
        return out

    spatial.conv_columns = recording
    try:
        with torch.no_grad():
            share = spatial.shard_width(
                frames_d[:MINI_BATCH // DP_WORLD].float(), mesh.rows()[0],
                dim=2)
            sm.grid_logits_nchw(params, share, train=True)
    finally:
        spatial.conv_columns = conv_columns
    rec.update({"largest_activation_bytes": largest[0],
                "largest_shard_bytes": largest[1]})
    log("  one rank, %d iterations of phase 4's round (coord_desc_auto, "
        "fused loss, f32) at %dx%d, minibatch %d: partitioned over %d "
        "shards of the card %s ms per iteration, unpartitioned %s (in "
        "turns); first loss rel %.2g; K2 loss+grad once per iteration in "
        "both; largest activation of a rank's %d frames %d B, its largest "
        "shard %d B"
        % (spec.iters, SH, SW, MINI_BATCH, WIDTH_MODEL,
           ["%.2f" % t for t in times["partitioned"]],
           ["%.2f" % t for t in times["unpartitioned"]], loss_rel[0],
           MINI_BATCH // DP_WORLD, largest[0], largest[1]))

    # (b) the labeler over a one-row mesh with a model axis, phase 7's
    # teacher at 257x513: in f32 (TF32 off), where the shards change only
    # the order of f32 sums, gated; in bf16, whose every rounding the
    # windows' other convolution shapes may move, recorded.  A pixel is a
    # near tie where its top-2 margin is within twice the largest gap
    # between the partitioned and the whole forward's logits: rounding
    # decides its order
    padded = np.pad(rgb[:WIDTH_LABEL_B], ((0, 0), (1, 0), (1, 0), (0, 0)),
                    mode="symmetric")
    staged = torch.from_numpy(padded).to(dev)
    labeled = {}
    for name, cd in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        label = make_sharded_labeler(mesh, teacher, compute_dtype=cd)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = label(staged)
        torch.cuda.synchronize()
        label_s = time.perf_counter() - t0
        counts = launch_counts()
        with torch.inference_mode():
            logits = xd.teacher_logits_nchw(teacher, staged,
                                            compute_dtype=cd)
            parts = xd.teacher_logits_nchw(
                teacher, spatial.shard_width(staged, mesh.rows()[0], dim=2),
                compute_dtype=cd)
            gap = float((parts - logits).abs().max())
            scale = float(logits.abs().max())
            want = torch.argmax(logits, dim=1).to(torch.int32)
            top2 = torch.topk(logits, 2, dim=1).values
            off_ties = (top2[:, 0] - top2[:, 1]) > 2 * gap
        del logits, parts, top2
        check(not any(counts.values()), "the labeler launched %s" % counts)
        labeled[name] = {
            "agreement": float((ids == want).float().mean()),
            "logit_gap": gap, "logit_scale": scale,
            "near_tie_share": 1.0 - float(off_ties.float().mean()),
            "equal_off_ties": bool(torch.equal(ids[off_ties],
                                               want[off_ties])),
            "s": label_s}
    f32 = labeled["float32"]
    check(f32["agreement"] >= WIDTH_LABEL_AGREE and f32["equal_off_ties"]
          and f32["logit_gap"] <= WIDTH_LOGIT_RTOL * f32["logit_scale"],
          "the f32 labeler over %s: %s" % (mesh, f32))
    rec["labeler"] = labeled
    log("  (b) make_sharded_labeler over %s, %d frames of %dx%d, against "
        "teacher_predictions: %s; no kernel launched"
        % (mesh, WIDTH_LABEL_B, padded.shape[1], padded.shape[2],
           "; ".join("%s ids agree on %.6f, equal off near ties %s (logits "
                     "%.3g apart at a scale of %.3g, near ties %.2g of the "
                     "pixels), %.2f s" % (n, r["agreement"],
                                          r["equal_off_ties"],
                                          r["logit_gap"], r["logit_scale"],
                                          r["near_tie_share"], r["s"])
                     for n, r in labeled.items())))

    # (c) the round rerun to the bit with deterministic algorithms off
    check(not torch.are_deterministic_algorithms_enabled()
          and torch.backends.cudnn.deterministic,
          "deterministic algorithms on, or cuDNN's deterministic mode off")
    reruns = {}
    for form, kw in (("bf16", dict(compute_dtype="bfloat16",
                                   fused_loss=False)),
                     ("f32 gather", dict(fused_loss=False)),
                     ("f32 fused", dict(fused_loss=True))):
        sp = dataclasses.replace(spec, iters=DETERMINISM_ITERS, **kw)
        a, b = (run(make_distill_round(sp), sp)[1] for _ in range(2))
        same = all(torch.equal(a[0][k], b[0][k]) for k in a[0]) \
            and torch.equal(a[3], b[3]) \
            and all(torch.equal(a[2][k], b[2][k]) for k in a[2])
        reruns[form] = same
    check(all(reruns.values()), "reruns of the round differ: %s" % reruns)
    rec["bitwise_reruns"] = reruns

    # (c) the native PNG decode of Average and Paeth rows
    src = decode_probe_frame()
    check(hashlib.sha256(src.tobytes()).hexdigest() == DECODE_PROBE,
          "decode_probe_frame is not the frame cv2 decoded")
    decode = {}
    for name, kind in (("average", 3), ("paeth", 4)):
        blob = png_filtered(src, kind)
        calls = native_png.unfilter.calls
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            got = image.png_decode(blob)
            best = min(best, time.perf_counter() - t0)
        check(native_png.unfilter.calls == calls + 3
              and np.array_equal(got, src),
              "png_decode of %s rows" % name)
        decode[name] = {"bytes": len(blob), "decode_s": best}
    rec["png_decode"] = decode
    log("  (c) %d iterations of the round in bf16, f32 (gather loss) and "
        "f32 (fused loss), each run twice with deterministic algorithms "
        "off: equal to the bit %s; png_decode of a 512x1024 frame, every "
        "row Average: %.4f s, Paeth: %.4f s (native unfilter, equal to "
        "cv2's pixels)"
        % (DETERMINISM_ITERS, reruns, decode["average"]["decode_s"],
           decode["paeth"]["decode_s"]))
    return rec


# --- phase 10: the rest of the port's modules ------------------------------
# (a) the TF1 reader on the committed fixture, (b) the converter CLI, (c) the
# native delta codec, (d) the TF32 round, (e) the legacy builders at full
# width, (f) the space-to-depth stem
TF1_PREFIX = os.path.join("tests", "fixtures", "student_tf1", "model")
S2D_SHAPE = (8, 513, 1025, 3)     # the +1-padded 512x1024 client frames
S2D_TOL = 1e-5                    # rtol and atol, f32 with TF32 off
# The TF32 round against the f32 round, from the same state: at the
# horizon of tests/test_torch_bf16_round.py's bars (3 iterations), losses
# per iteration within tests/test_mixed_precision.py's 5%, the parameter
# deltas at cosine above 0.9; at 200 iterations train-mode BN has made any
# two runs diverge (f32 against its own rerun on the card too: losses
# 6.4% apart at worst, delta cosine 0.67; PERF.md §6), so there the
# losses are held over the first 10 iterations and on the plateau (the
# mean of the last 20, tests/test_parity_round_functional.py's gate)
TF32_SHORT_ITERS = 3
TF32_LOSS_RTOL = 0.05
TF32_DELTA_COSINE = 0.9
TF32_EARLY_ITERS, TF32_PLATEAU = 10, 20
# The selection step runs in TF32 too (JAX passes spec.precision to every
# iteration), unlike the bf16 round's f32 selection behind that test's
# 0.995: TF32 moves a warm Adam step's |delta| by a median 8-11% against
# f32's (train-mode BN's backward cancels), which flips 1.1-1.7% of the
# coordinates at the 10% cut, where f32 against its rerun flips none
# (PERF.md §6)
TF32_MASK_AGREE = 0.98
# Adam's first step from cold slots moves every live coordinate by ~lr,
# so the coord_desc_auto selection would slice a tie cluster that TF32
# rounding reorders: the rounds start from slots warmed under an
# all-False mask (params frozen), as tests/test_torch_round.py's do
TF32_WARM_ITERS = 10
CODEC_REPS = 5                    # the encoders' timed calls, in turns
COMPAT_TEACHER_HW = (257, 513)
COMPAT_TEACHER_B = 2


def _tf1_tool():
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "make_tf1_student_ckpt",
        os.path.join(root, "tools", "make_tf1_student_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf32_flags():
    import torch

    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _tf32_recorder():
    """A torch function mode that reads the TF32 flags at every
    convolution and product called under it: ``seen`` counts the calls by
    the flags they ran under."""
    import collections

    from torch.overrides import TorchFunctionMode

    class Recorder(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if "conv" in name or name in ("matmul", "mm", "bmm", "linear",
                                          "einsum"):
                self.seen[_tf32_flags()] += 1
            return func(*args, **(kwargs or {}))

    return Recorder()


def _interleaved_host_ms(fns, reps=CODEC_REPS):
    """The median host milliseconds of each of ``fns`` (a dict of
    host-only callables), called in turns ``reps`` times after one warm-up
    each, so that the host's drift falls on all of them alike."""
    times = {k: [] for k in fns}
    for k, fn in fns.items():
        fn()
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(1e3 * (time.perf_counter() - t0))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def _host_ms(fn, reps=3):
    """Mean host milliseconds of ``fn()`` over ``reps`` calls after one
    warm-up, each ending in a device synchronisation."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_rest(dev, codec_build):
    """Phase 10: the TF1 reader, the converter, the native codec, the TF32
    round, the legacy builders and the s2d stem, every launch counter set
    to 0 just before each part and read just after."""
    import collections
    import gzip
    import warnings
    import zlib

    import numpy as np
    import torch
    from ams_tpu_torch import compat, configs
    from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
    from ams_tpu_torch.distill import train_step as ts
    from ams_tpu_torch.models import layers
    from ams_tpu_torch.models.frozen import fold_student
    from ams_tpu_torch.models.mobilenetv2_deeplab import (
        init_student_params,
        student_logits,
    )
    from ams_tpu_torch.models.xception_deeplab import teacher_predictions
    from ams_tpu_torch.native import codec as native_codec
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.stream.codec import (
        decode_delta,
        delta_order,
        encode_delta,
        pack_payload,
        pack_stats_annex,
    )
    from ams_tpu_torch.utils import checkpoint as ckpt
    from ams_tpu_torch.utils import tf_bundle

    root = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(root, TF1_PREFIX)
    out = {}
    none = {k: 0 for k in launch_counts()}

    # (a) the TF1 reader, on a machine without TensorFlow
    check("tensorflow" not in sys.modules, "tensorflow was imported")
    reset_counters()
    t0 = time.perf_counter()
    student = ckpt.load_tf_checkpoint(prefix)
    read_ms = 1e3 * (time.perf_counter() - t0)
    tool = _tf1_tool()
    want = tool.student_arrays()
    check(sorted(student) == sorted(want), "TF1 reader: %d names, want %d"
          % (len(student), len(want)))
    bad = [k for k in want if student[k].dtype != want[k].dtype
           or not np.array_equal(student[k], want[k])]
    check(not bad, "TF1 reader: values differ from the tool's in %s"
          % bad[:3])
    index = dict(tf_bundle.read_index(prefix)[1])
    check(tool.SLOT in index and "global_step" in index
          and tool.SLOT not in student and "global_step" not in student,
          "TF1 reader: the Adam slot and global_step were not filtered")
    check(launch_counts() == none, "TF1 reader launched %s" % launch_counts())
    out["tf1_read"] = {"ms": read_ms, "tensors": len(student),
                       "bytes": int(sum(v.nbytes for v in student.values()))}
    log("  (a) TF1 reader: %d tensors (%.1f MB) in %.1f ms, equal to the "
        "tool's seeded arrays; the Adam slot and global_step dropped"
        % (len(student), out["tf1_read"]["bytes"] / 1e6, read_ms))

    # (b) the converter, as a subprocess
    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_rest_")
    try:
        reset_counters()
        dst = os.path.join(tmp, "deploy.npz")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ams_tpu_torch.cli.convert", prefix, dst,
             "--fold", "--device", dev.type], cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=300)
        convert_s = time.perf_counter() - t0
        check(proc.returncode == 0, "cli.convert failed (rc %d): %s"
              % (proc.returncode, proc.stderr[-2000:]))
        folded = params_to_numpy(fold_student(params_from_numpy(student,
                                                                dev)))
        with np.load(dst) as z:
            got = {k: z[k] for k in z.files}
        check(sorted(got) == sorted(folded), "cli.convert --fold names")
        bad = [k for k in folded if got[k].dtype != folded[k].dtype
               or got[k].tobytes() != folded[k].tobytes()]
        check(not bad, "cli.convert --fold differs from fold_student in %s"
              % bad[:3])
        check(launch_counts() == none, "the converter's check launched %s"
              % launch_counts())
        out["convert"] = {"s": convert_s, "tensors": len(got)}
        log("  (b) python -m ams_tpu_torch.cli.convert %s --fold --device "
            "%s: %d tensors in %.2f s, bitwise fold_student of (a) on the "
            "same device" % (TF1_PREFIX, dev.type, len(got), convert_s))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the native codec on a full-width student delta
    reset_counters()
    rng = np.random.RandomState(SEED + 40)
    moved = {k: v + (0.01 * rng.randn(*v.shape)).astype(v.dtype)
             for k, v in student.items()}
    shapes = {k: v.shape for k, v in student.items()}
    stats = {k: v for k, v in moved.items() if "moving_" in k}
    coord = {k: rng.rand(*v.shape) < COORD_FRAC
             for k, v in moved.items() if "moving_" not in k}
    cases = {"full_model": dict(masks=None, strategy="full_model"),
             "coord_desc_auto": dict(masks=coord, strategy="coord_desc_auto",
                                     stats=stats)}
    codec = {"build_s": codec_build["seconds"],
             "cached": codec_build["cached"], "path": codec_build["path"]}
    for name, kw in cases.items():
        kw = dict(kw)
        masks = kw.pop("masks")
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # the fallback warns
            blob = encode_delta(moved, masks, **kw)
        check(native_codec._LIB is not None
              and native_codec._LIB._name == codec_build["path"],
              "encode_delta did not load the native library")
        check(blob[9] == 3, "the gzip header's OS byte is %d, not zlib's "
              "Unix 3: not the native codec" % blob[9])
        python = encode_delta(moved, masks, use_native=False, **kw)
        check(gzip.decompress(blob) == gzip.decompress(python),
              "%s: native and Python payloads differ" % name)
        dm, dv = decode_delta(blob, shapes, strategy=kw["strategy"])
        pm, pv = decode_delta(python, shapes, strategy=kw["strategy"])
        check(all(np.array_equal(dm[k], pm[k]) and np.array_equal(dv[k], pv[k])
                  for k in pm), "%s: decoded deltas differ" % name)
        raw = gzip.decompress(python)

        def python_zlib9():
            # the Python path's payload under the native codec's deflate
            # settings (zlib's own gzip wrapper, memLevel 9): the same bytes
            order = delta_order(kw["strategy"], present=moved)
            ms = [np.ones(moved[n].shape, bool) if masks is None
                  else np.asarray(masks[n]) for n in order]
            body = pack_payload(ms, [moved[n] for n in order])
            if kw.get("stats") is not None:
                body += pack_stats_annex(kw["stats"])
            z = zlib.compressobj(9, zlib.DEFLATED, 31, 9)
            return z.compress(body) + z.flush()

        check(python_zlib9() == blob, "%s: the Python payload under "
              "deflate(9, memLevel 9) is not the native bytes" % name)
        encoders = {
            "native_ms": lambda: encode_delta(moved, masks, **kw),
            "python_ms": lambda: encode_delta(moved, masks, use_native=False,
                                              **kw),
            "python_zlib9_ms": python_zlib9}
        codec[name] = {"bytes": len(blob), "raw_bytes": len(raw),
                       **_interleaved_host_ms(encoders)}
        log("  (c) encode_delta %s: native %.1f ms, Python %.1f ms (gzip "
            "module, memLevel 8), Python with the native bytes %.1f ms "
            "(memLevel 9); %d B of %d; payloads equal after decompression "
            "and decode_delta"
            % (name, codec[name]["native_ms"], codec[name]["python_ms"],
               codec[name]["python_zlib9_ms"], len(blob), len(raw)))
    check(launch_counts() == none, "the codec launched %s" % launch_counts())
    out["codec"] = codec
    log("  (c) native codec built in %.2f s%s at first use -> %s"
        % (codec_build["seconds"], " (cached)" if codec_build["cached"]
           else "", codec_build["path"]))

    # (d) the TF32 round against the f32 round, phase 4's setup
    exp = 0
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
    memory = (collections.deque(frames), collections.deque(labels))
    start = params_from_numpy(host, dev)
    train, _ = ts.split_params(start)
    _, warm, _, _ = ts.make_distill_round(ts.DistillSpec(
        iters=TF32_WARM_ITERS, batch_size=MINI_BATCH, num_classes=19,
        class_indices=tuple(int(c) for c in configs.class_indices(exp)),
        strategy="full_model"))(
            start, ts.adam_init(train), torch.from_numpy(frames).to(dev),
            torch.from_numpy(labels).to(dev), MEMORY,
            torch.Generator(device=dev).manual_seed(SEED + 44), LR,
            {k: torch.zeros_like(v, dtype=torch.bool)
             for k, v in train.items()}, reselect=False)
    def facade_round(precision, iters, record=False):
        net = SemanticNetwork(host, configs.class_weights(exp), height=SH,
                              frozen=False, scale=[1],
                              mini_batch_size=MINI_BATCH, lr=LR,
                              coord_frac=COORD_FRAC, fused_loss=True,
                              conv_precision=precision, seed=SEED,
                              device=dev)
        net.opt_state = ts.AdamState(
            step=warm.step.clone(),
            m={k: v.clone() for k, v in warm.m.items()},
            v={k: v.clone() for k, v in warm.v.items()})
        check(_tf32_flags() == (False, False), "TF32 on before the round")
        torch.cuda.synchronize()
        recorder = _tf32_recorder() if record else contextlib.nullcontext()
        reset_counters()
        t0 = time.perf_counter()
        with recorder:
            losses = net.train_with_deque(*memory, iters, "coord_desc_auto")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if record:
            # the flags every convolution and product of the round saw
            want_flags = (precision == "default",) * 2
            check(sum(recorder.seen.values()) > 0
                  and set(recorder.seen) == {want_flags},
                  "%s round: convolutions ran under the TF32 flags %s, "
                  "want only %s" % (precision, dict(recorder.seen),
                                    want_flags))
        counts = launch_counts()
        want_counts = dict(none, resize_ce_loss_grad=iters)
        check(counts == want_counts, "%s round launched %s, want %s"
              % (precision, counts, want_counts))
        check(_tf32_flags() == (False, False),
              "the TF32 flags stayed on after the %s round" % precision)
        check(np.isfinite(losses).all(), "%s round losses %s"
              % (precision, losses[:5]))
        after = net.get_vars()
        return {"losses": losses, "launches": counts, "round_s": seconds,
                "flags_in_round": {str(k): n for k, n in
                                   recorder.seen.items()} if record else None,
                "ms_per_iteration": 1e3 * seconds / iters,
                "mask": np.concatenate([m.reshape(-1)
                                        for m in net.curr_mask]),
                "delta": np.concatenate([(after[k] - host[k]).reshape(-1)
                                         for k in sorted(host)
                                         if "moving_" not in k])}

    def gap(a, b, early=None):
        rel = np.abs(a["losses"] - b["losses"]) / np.abs(b["losses"])
        tail = slice(-TF32_PLATEAU, None)
        return {"early_max_rel": float(rel[:early].max()),
                "max_rel": float(rel.max()),
                "plateau_rel": float(abs(a["losses"][tail].mean()
                                         - b["losses"][tail].mean())
                                     / b["losses"][tail].mean()),
                "mask_agreement": float((a["mask"] == b["mask"]).mean()),
                "delta_cosine": float(np.dot(a["delta"], b["delta"]) / (
                    np.linalg.norm(a["delta"]) * np.linalg.norm(b["delta"])))}

    comparisons = {}
    for iters, early in ((TF32_SHORT_ITERS, None),
                         (ROUND_ITERS, TF32_EARLY_ITERS)):
        # in turns: f32, TF32, f32 again (the pair gives f32's own spread);
        # the short rounds record the flags each convolution ran under (the
        # long ones are timed, so they run without the recording mode)
        record = iters == TF32_SHORT_ITERS
        f32, tf32, f32_again = (facade_round(p, iters, record)
                                for p in ("highest", "default", "highest"))
        comparisons[iters] = {
            "flags_in_round": {"default": tf32["flags_in_round"],
                               "highest": f32["flags_in_round"]},
            "tf32_vs_f32": gap(tf32, f32, early),
            "f32_vs_f32_rerun": gap(f32_again, f32, early),
            "ms_per_iteration": {"default": tf32["ms_per_iteration"],
                                 "highest": [f32["ms_per_iteration"],
                                             f32_again["ms_per_iteration"]]},
            "launches": tf32["launches"]["resize_ce_loss_grad"]}
        log("  (d) %d iterations: TF32 against f32 %s; f32 against its "
            "rerun %s" % (iters, json.dumps(comparisons[iters]["tf32_vs_f32"]),
                          json.dumps(comparisons[iters]["f32_vs_f32_rerun"])))
    short = comparisons[TF32_SHORT_ITERS]["tf32_vs_f32"]
    long_ = comparisons[ROUND_ITERS]["tf32_vs_f32"]
    check(short["max_rel"] < TF32_LOSS_RTOL
          and short["delta_cosine"] > TF32_DELTA_COSINE
          and short["mask_agreement"] >= TF32_MASK_AGREE,
          "TF32 against f32 over %d iterations: %s"
          % (TF32_SHORT_ITERS, short))
    check(long_["early_max_rel"] < TF32_LOSS_RTOL
          and long_["plateau_rel"] < TF32_LOSS_RTOL
          and long_["mask_agreement"] >= TF32_MASK_AGREE,
          "TF32 against f32 over %d iterations: %s" % (ROUND_ITERS, long_))
    # TF32 has to show in the numbers too: its masks stand further from
    # f32's than f32's own rerun does
    rerun = comparisons[ROUND_ITERS]["f32_vs_f32_rerun"]
    check(long_["mask_agreement"] < rerun["mask_agreement"],
          "the TF32 round's masks agree with f32's on %.4f, the f32 rerun's "
          "on %.4f: TF32 left no mark" % (long_["mask_agreement"],
                                          rerun["mask_agreement"]))
    timing = comparisons[ROUND_ITERS]["ms_per_iteration"]
    out["tf32_round"] = {"launches": comparisons[ROUND_ITERS]["launches"],
                         "ms_per_iteration": timing,
                         "by_iterations": comparisons}
    log("  (d) coord_desc_auto round, %d iterations of minibatch %d at "
        "%dx%d, fused loss: TF32 %.2f ms per iteration, f32 %.2f and %.2f; "
        "K2 loss+grad once per iteration in each round, nothing else; "
        "TF32 on for every convolution of the TF32 round, off for the f32 "
        "rounds' and after each"
        % (ROUND_ITERS, MINI_BATCH, SH, SW, timing["default"],
           *timing["highest"]))

    # (e) the legacy builders at full width
    sub_cw = configs.class_weights(SUBSET_EXP)
    n_sel = int(np.sum(sub_cw))
    reset_counters()
    s3 = compat.create_student_v3(prefix, class_weights=sub_cw, device=dev)
    mb = slice(0, MINI_BATCH)
    f_mb, l_mb = frames[mb], labels[mb]
    preds = s3["predictions"](s3["params"], f_mb)
    check(tuple(preds.shape) == (MINI_BATCH, SH, SW)
          and int(preds.max()) < n_sel, "v3 predictions %s" % (preds.shape,))
    loss = float(s3["loss"](s3["params"], f_mb, l_mb))
    check(np.isfinite(loss), "v3 loss %r" % loss)
    cm = s3["update_op"](s3["params"], f_mb, l_mb)
    want_px = int(np.isin(l_mb, np.where(sub_cw.reshape(-1) == 1)[0]).sum())
    check(tuple(cm.shape) == (n_sel, n_sel) and int(cm.sum()) == want_px,
          "v3 update_op %s sums to %s, want %d" % (tuple(cm.shape),
                                                   float(cm.sum()), want_px))
    p, opt = s3["params"], s3["opt_init"]()
    stat = "MobilenetV2/Conv/BatchNorm/moving_mean"
    train_losses = []
    for step in range(3):
        before = p[stat].clone()
        p, opt, step_loss = s3["train"](p, opt, f_mb, l_mb, LR)
        train_losses.append(float(step_loss))
        check(not torch.equal(p[stat], before),
              "v3 train step %d did not move the BN statistics" % step)
    check(int(opt.step) == 3 and np.isfinite(train_losses).all(),
          "v3 train: step %d, losses %s" % (int(opt.step), train_losses))
    masks = {k: torch.rand(v.shape, device=dev) < COORD_FRAC
             for k, v in s3["params"].items() if "moving_" not in k}
    coord_p, _, _ = s3["train_coord"](s3["params"], s3["opt_init"](), f_mb,
                                      l_mb, LR, masks)
    frozen_bad = [k for k, m in masks.items()
                  if not torch.equal(coord_p[k][~m], s3["params"][k][~m])]
    check(not frozen_bad, "v3 train_coord moved unmasked coordinates of %s"
          % frozen_bad[:3])
    check(any(not torch.equal(coord_p[k][m], s3["params"][k][m])
              for k, m in masks.items()), "v3 train_coord moved nothing")
    v3_launches = launch_counts()
    check(v3_launches == none, "v3 launched %s" % v3_launches)
    v3_ms = _host_ms(lambda: s3["train"](s3["params"], s3["opt_init"](),
                                         f_mb, l_mb, LR))
    del s3, p, opt, coord_p

    client_frames = synthetic_frames(B, H, W, SEED + 41)
    reset_counters()
    plain = compat.create_client(prefix, class_weights=sub_cw, device=dev)
    ids = plain["predictions"](client_frames)
    with torch.no_grad():
        lg = student_logits(plain["params"],
                            torch.from_numpy(client_frames).to(dev).float())
        red = lg[..., torch.as_tensor(np.where(sub_cw.reshape(-1) == 1)[0],
                                      device=dev)]
        conf = torch.softmax(red, -1).amax(-1).cpu().numpy()
    threshold = float(np.median(conf))
    gated = compat.create_client(prefix, class_weights=sub_cw,
                                 threshold=threshold, map_misc=0, device=dev)
    gated_ids = gated["predictions"](client_frames)
    colored = gated["output_colored"](client_frames)
    check(colored.shape == (B, H, W, 3), "output_colored %s"
          % (colored.shape,))
    sure = conf > threshold + 1e-4
    unsure = conf < threshold - 1e-4
    check(np.array_equal(gated_ids[sure], ids[sure])
          and (gated_ids[unsure] == 0).all() and sure.mean() > 0.3,
          "create_client's confidence gate: ids differ from the ungated "
          "ids above the threshold (%.4f)" % threshold)
    client_launches = launch_counts()
    check(client_launches == none, "create_client launched %s"
          % client_launches)
    client_ms = _host_ms(lambda: gated["predictions"](client_frames))
    del plain, gated, lg, red

    reset_counters()
    teacher_c = compat.create_teacher(None, class_weights=sub_cw, device=dev)
    th, tw = COMPAT_TEACHER_HW
    tframes = synthetic_frames(COMPAT_TEACHER_B, th, tw, SEED + 42)
    tpreds = teacher_c["predictions"](tframes)
    with torch.no_grad():
        direct = teacher_predictions(
            teacher_c["params"], torch.from_numpy(tframes).to(dev).float())
    check(torch.equal(tpreds, direct), "create_teacher's predictions differ "
          "from teacher_predictions in %d pixels"
          % int((tpreds != direct).sum()))
    teacher_launches = launch_counts()
    check(teacher_launches == none, "create_teacher launched %s"
          % teacher_launches)
    teacher_ms = _host_ms(lambda: teacher_c["predictions"](tframes))
    del teacher_c
    out["compat"] = {
        "v3": {"loss": loss, "train_losses": train_losses,
               "train_step_ms": v3_ms, "frames_per_s":
               MINI_BATCH / (v3_ms / 1e3)},
        "client": {"threshold": threshold, "sure_share": float(sure.mean()),
                   "ms": client_ms, "frames_per_s": B / (client_ms / 1e3)},
        "teacher": {"ms": teacher_ms,
                    "frames_per_s": COMPAT_TEACHER_B / (teacher_ms / 1e3)}}
    log("  (e) compat: create_student_v3 from the TF prefix (exp %d, %d "
        "classes): train step %.1f ms (%.1f frames/s at %dx%d), loss %.4f, "
        "3 steps moved the BN statistics, train_coord kept unmasked "
        "coordinates; create_client %.1f frames/s (%dx%dx%d, threshold "
        "%.4f); create_teacher %.2f frames/s (%dx%dx%d), ids equal to "
        "teacher_predictions; no kernel launched"
        % (SUBSET_EXP, n_sel, v3_ms, out["compat"]["v3"]["frames_per_s"],
           SH, SW, loss, out["compat"]["client"]["frames_per_s"], B, H, W,
           threshold, out["compat"]["teacher"]["frames_per_s"],
           COMPAT_TEACHER_B, th, tw))

    # (f) the space-to-depth stem against the stride-2 SAME convolution
    reset_counters()
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    b, h, w, c = S2D_SHAPE
    x = torch.randn((b, c, h, w), generator=gen, device=dev)
    k = torch.randn((3, 3, c, 32), generator=gen, device=dev) * 0.2
    check(_tf32_flags() == (False, False), "TF32 on for the s2d check")
    want = layers.conv2d(x, k, stride=2)
    got = layers.conv2d_stride2_s2d(x, k)
    err = float((got - want).abs().max())
    check(got.shape == want.shape and torch.allclose(
        got, want, rtol=S2D_TOL, atol=S2D_TOL),
        "s2d stem: max abs err %.3g against the stride-2 conv" % err)
    check(launch_counts() == none, "the s2d check launched %s"
          % launch_counts())
    out["s2d"] = {"shape": list(S2D_SHAPE), "max_abs_err": err,
                  "s2d_ms": cuda_ms(lambda: layers.conv2d_stride2_s2d(x, k),
                                    20),
                  "conv_ms": cuda_ms(lambda: layers.conv2d(x, k, stride=2),
                                     20)}
    log("  (f) s2d stem at %s f32: max abs err %.3g (tolerance %g); %.4f ms "
        "against the stride-2 conv's %.4f ms"
        % ("x".join(map(str, S2D_SHAPE)), err, S2D_TOL, out["s2d"]["s2d_ms"],
           out["s2d"]["conv_ms"]))
    return out


# --- phase 12: Orbax checkpoints without orbax, the validation gate --------
# (a) libzstd on the card's machine, (b) the committed Orbax fixture (an
# OCDBT store written by orbax) against the TF1 fixture, (c) save_orbax and
# load_orbax at full width, (d) the f32 client built from either, (e)
# tools/torch_validate_reference.py on a synthetic clip
ORBAX_DIR = os.path.join("tests", "fixtures", "student_orbax")
ORBAX_READS = 5                  # timed reads of each fixture
ORBAX_WRITES = 3                 # timed save_orbax + load_orbax round trips
VALIDATE_HEIGHT = 256            # the tool's --height (its default)
VALIDATE_TIMEOUT_S = 600


def same_arrays(got, want):
    """Names equal, and each array's dtype, shape and bytes."""
    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in want)


def _timed_ms(fn, reps):
    """(ms of each call, the last result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return times, out


def phase_orbax(dev, clip, gt):
    """Phase 12: Orbax checkpoints read and written without orbax, and the
    port's validation gate, every launch counter set to 0 just before each
    part -> its record."""
    import numpy as np
    import torch
    from ams_tpu_torch import configs
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.utils import checkpoint as ckpt
    from ams_tpu_torch.utils import orbax, zstd

    root = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(root, TF1_PREFIX)
    orbax_dir = os.path.join(root, ORBAX_DIR)
    none = {k: 0 for k in launch_counts()}
    rec = {}

    # (a) the library that every OCDBT node and zarr chunk goes through;
    # a machine without it raises here, naming libzstd.so.1
    version = zstd.version()
    rec["libzstd"] = {"version": version, "library": zstd.library()._name,
                      "zstd_h": os.path.exists("/usr/include/zstd.h")}
    log("  (a) libzstd %s (%s); zstd.h %s" % (
        version, rec["libzstd"]["library"],
        "present" if rec["libzstd"]["zstd_h"] else "absent"))

    # (b) the committed OCDBT store against the TF1 fixture
    reset_counters()
    orbax_ms, from_orbax = _timed_ms(lambda: ckpt.load_any(orbax_dir),
                                     ORBAX_READS)
    tf1_ms, from_tf1 = _timed_ms(lambda: ckpt.load_tf_checkpoint(prefix),
                                 ORBAX_READS)
    check(len(from_tf1) == 272 and same_arrays(from_orbax, from_tf1),
          "the Orbax fixture differs from the TF1 fixture")
    check(launch_counts() == none, "the readers launched %s"
          % launch_counts())
    nbytes = int(sum(v.nbytes for v in from_tf1.values()))
    rec["read"] = {"tensors": len(from_tf1), "bytes": nbytes,
                   "orbax_ms": orbax_ms, "tf1_ms": tf1_ms}
    log("  (b) %s (OCDBT, written by orbax) through load_any: %d tensors "
        "(%.1f MB), equal name for name and bit for bit to the TF1 "
        "fixture; read ms %s, against the TF1 reader's %s"
        % (ORBAX_DIR, len(from_orbax), nbytes / 1e6,
           ["%.1f" % t for t in orbax_ms], ["%.1f" % t for t in tf1_ms]))

    # (c) the port's own layout: save_orbax, then load_orbax
    tmp = tempfile.mkdtemp(prefix="ams_chip_smoke_orbax_")
    try:
        reset_counters()
        path = os.path.join(tmp, "student")
        write_ms, read_ms = [], []
        for _ in range(ORBAX_WRITES):
            t, _ = _timed_ms(lambda: orbax.save_orbax(path, from_tf1), 1)
            write_ms += t
            t, back = _timed_ms(lambda: orbax.load_orbax(path), 1)
            read_ms += t
            check(same_arrays(back, from_tf1),
                  "save_orbax -> load_orbax changed the student")
        check(sorted(os.listdir(tmp)) == ["student"],
              "save_orbax left %s" % sorted(os.listdir(tmp)))
        check(launch_counts() == none, "save_orbax launched %s"
              % launch_counts())
        rec["round_trip"] = {"write_ms": write_ms, "read_ms": read_ms}
        log("  (c) save_orbax (zarr v2 per array, zstd 1) of the same "
            "student: write ms %s, load_orbax ms %s, bitwise"
            % (["%.1f" % t for t in write_ms], ["%.1f" % t for t in read_ms]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the f32 client built from either checkpoint on the card
    frames = synthetic_frames(B, H, W, SEED + 50)
    clients = {}
    for name, src in (("orbax", orbax_dir), ("tf1", prefix)):
        net = SemanticNetwork(src, configs.class_weights(0), height=H,
                              frozen=True, device=dev)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        ids = net.predict_input(frames)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        clients[name] = {"ids": ids, "launches": launch_counts(), "s": s}
        del net
    k1 = {n: c["launches"]["resize_argmax"] for n, c in clients.items()}
    check(clients["orbax"]["launches"] == clients["tf1"]["launches"]
          and k1["orbax"] > 0
          and all(v == 0 for c in clients.values()
                  for k, v in c["launches"].items() if k != "resize_argmax"),
          "the clients' launches differ or are not K1's alone: %s"
          % {n: c["launches"] for n, c in clients.items()})
    check(clients["orbax"]["ids"].shape == (B, H, W)
          and np.array_equal(clients["orbax"]["ids"], clients["tf1"]["ids"]),
          "the client from the Orbax fixture predicts other ids")
    rec["client"] = {"k1_launches": k1, "first_predict_s": {
        n: c["s"] for n, c in clients.items()},
        "classes": np.unique(clients["orbax"]["ids"]).tolist()}
    log("  (d) SemanticNetwork(frozen=True) from %s and from %s on %s: "
        "predict_input of %dx%dx%d frames, ids equal bit for bit, K1 "
        "launches %s and nothing else"
        % (ORBAX_DIR, TF1_PREFIX, dev, B, H, W, k1))

    # (e) the validation gate's inventory, convert and simple stages
    work = tempfile.mkdtemp(prefix="ams_chip_smoke_validate_")
    try:
        cmd = [sys.executable, os.path.join(root, "tools",
                                            "torch_validate_reference.py"),
               "--stages", "inventory,convert,simple", "--checkpoint",
               prefix, "--video", clip, "--gt_dir", gt, "--height",
               str(VALIDATE_HEIGHT), "--device", dev.type, "--workdir",
               os.path.join(work, "out")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                              timeout=VALIDATE_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=root))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("[inventory]", "[convert]", "[simple]",
                               "all requested", "FAILED"))]
    for ln in lines:
        log("    " + ln)
    check(proc.returncode == 0, "torch_validate_reference.py failed (rc "
          "%d): %s" % (proc.returncode, (proc.stdout + proc.stderr)[-3000:]))
    mious = {}
    for ln in lines:
        if "rolling-window mIoU = " in ln:
            mious[ln.split()[1]] = float(ln.split("= ")[1].split()[0])
    check(any(ln.startswith("[inventory] OK") for ln in lines)
          and any(ln.startswith("[convert] OK") for ln in lines)
          and sorted(mious) == ["pretrained", "simple"]
          and all(np.isfinite(v) for v in mious.values()),
          "the validation gate's output: %s" % lines)
    rec["validate"] = {"wall_s": wall, "miou": mious}
    log("  (e) tools/torch_validate_reference.py --stages "
        "inventory,convert,simple --height %d --device %s on %s: exit 0 in "
        "%.1f s wall; mIoU pretrained %.4f, simple %.4f"
        % (VALIDATE_HEIGHT, dev.type, os.path.basename(clip), wall,
           mious["pretrained"], mious["simple"]))
    return rec


def main() -> int:
    if "--dp-rank" in sys.argv:
        return dp_rank_main(sys.argv[1:])
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
    from ams_tpu_torch.native import build as native_build
    codec_build = native_build.build()
    log("  native delta codec (g++ -lz): %.2f s%s -> %s"
        % (codec_build["seconds"], " (cached)" if codec_build["cached"]
           else "", codec_build["path"]))
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

    clip_root = tempfile.mkdtemp(prefix="ams_chip_smoke_clip_")
    try:
        log("phase 6: the emulated experiment (python -m "
            "ams_tpu_torch.cli.run --mode early, then --mode pretrained; %d "
            "s of %dx%d frames at %d fps, --height %d, %d iterations)"
            % (8, EXP_HW[0], EXP_HW[1], EXP_FPS, SH, ROUND_ITERS))
        clip, gt = write_bands_clip(clip_root)
        experiment = phase_experiment(dev, clip, gt)

        log("phase 7: the Xception-65 teacher and the labeler (python -m "
            "ams_tpu_torch.cli.extract_labels on the same clip, --height %d "
            "then full size)" % SH)
        teacher_cases, labeler_runs, teacher_checks = phase_teacher(dev, clip)

        log("phase 8: the live runtime (python -m ams_tpu_torch.cli.serve "
            "and two concurrent python -m ams_tpu_torch.cli.edge on the same "
            "clip, --height %d, %d iterations in bf16; then one session in "
            "this process with K1 counted)" % (SH, ROUND_ITERS))
        live_cli, live_k1 = phase_live(dev, clip, gt)

        log("phase 9: multi-device (MultiVideoServer with %d videos on the "
            "card, --height %d, minibatch %d, %d + %d iterations in bf16; "
            "then the minibatch-parallel round on %d gloo ranks and one "
            "NCCL rank, %d iterations)" % (len(MV_VIDEOS), SH, MINI_BATCH,
                                           MV_ITERS, MV_KEEP_ITERS,
                                           DP_WORLD, DP_ITERS))
        multi_video, teacher, clip_rgb = phase_multi_video(dev, clip)
    finally:
        shutil.rmtree(clip_root, ignore_errors=True)
    data_parallel = phase_data_parallel(dev)

    log("phase 10: the TF1 reader, the converter CLI, the native codec, the "
        "TF32 round (%d iterations), the legacy builders and the s2d stem"
        % ROUND_ITERS)
    rest = phase_rest(dev, codec_build)

    log("phase 11: width partitioning (the mesh's model axis, %d shards of "
        "the card per row): (a) the round on %d gloo ranks (in phase 9 part "
        "B's call), and on one rank against the unpartitioned round; (b) the "
        "labeler; (c) the repaired faults" % (WIDTH_MODEL, DP_WORLD))
    width = phase_width(dev, teacher, clip_rgb, data_parallel.pop("width"))
    del teacher, clip_rgb

    log("phase 12: Orbax checkpoints without orbax (libzstd, the committed "
        "OCDBT fixture, save_orbax/load_orbax, the client from either "
        "checkpoint) and tools/torch_validate_reference.py (inventory, "
        "convert, simple at --height %d)" % VALIDATE_HEIGHT)
    clip_root = tempfile.mkdtemp(prefix="ams_chip_smoke_clip_")
    try:
        clip, gt = write_bands_clip(clip_root)
        orbax_rec = phase_orbax(dev, clip, gt)
    finally:
        shutil.rmtree(clip_root, ignore_errors=True)

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
        "teacher_path_launches": {name: r["k1_launches"]
                                  for name, r in labeler_runs.items()},
        "live_path_launches": live_k1["k1_launches"],
        "multi_video_path_launches": multi_video["client_launches"][
            "resize_argmax"],
        "orbax_path_launches": orbax_rec["client"]["k1_launches"],
        "teacher_max_abs_err": max(c["max_abs_err"] for c in teacher_cases),
        "teacher_cases": teacher_cases,
        "handover": handover,
        "shape": main_case["shape"], "cases": cases}]
    ce_main = ce_cases[0]
    for part, key in (("loss", "loss_abs_err"),
                      ("loss_grad", "grad_max_abs_err")):
        kernels.append({
            "name": "resize_ce_" + part, "route": "cuda",
            "source": frc.SOURCE, "replaces": frc.REPLACES,
            "launches": server_launches["resize_ce_" + part],
            "data_parallel_launches_per_rank": {
                case: r["launches_per_rank"]["resize_ce_" + part]
                for case, r in data_parallel.items() if case in DP_CASES},
            "width_parallel_launches_per_rank": {
                case: r["launches_per_rank"]["resize_ce_" + part]
                for case, r in width["ranks"].items()},
            **({"tf32_round_launches": rest["tf32_round"]["launches"]}
               if part == "loss_grad" else {}),
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
    for c in teacher_cases:
        log("resize_argmax %s %s %s: %.4f ms per call (%.4f on the device; "
            "bound %.4f, %s); plain %.4f / %.4f, library %.4f / %.4f; "
            "mismatches %d, off ties %d"
            % (c["case"], c["shape"], c["dtype"], c["kernel_ms"],
               c["device_ms"], c["bound_ms"], c["bound_by"], c["plain_ms"],
               c["plain_device_ms"], c["library_ms"], c["library_device_ms"],
               c["mismatches"], c["mismatches_off_ties"]))
    for name, r in labeler_runs.items():
        log("labeler %s: batch %d, %d chunks, K1 %d launches; %.2f frames/s "
            "end to end (read %.2f s, predict %.2f s, write %.2f s); the "
            "labeler alone %.1f frames/s, device busy %.1f%% under the "
            "profiler" % (name, r["batch"], r["chunks"], r["k1_launches"],
                          r["end_to_end_frames_per_s"], r["read_s"] or 0,
                          r["predict_s"] or 0, r["write_s"] or 0,
                          r["labeler_frames_per_s"],
                          100 * r["device_busy_share"]))
    log("teacher checks: %s" % json.dumps(teacher_checks))
    for name, r in live_cli["edges"].items():
        log("live edge %s (%s): %.1f frames/s while streaming, %.1f end "
            "to end with the wait for the last deltas; gt mIoU mean %.4f; "
            "deltas %s B" % (name, r["wire"], r["streaming_frames_per_s"],
                             r["frames_per_s"], r["miou_mean"],
                             r["delta_bytes"]))
    log("live server (CLI): label %s s per draw (the first loads the "
        "teacher); rounds (train s include the wait for the device lock) %s"
        % (live_cli["label_s"], json.dumps(live_cli["rounds"])))
    log("live session in process: K1 %d launches = %d teacher chunks + %d "
        "frames predicted; bf16 rounds %s s, %s ms per iteration"
        % (live_k1["k1_launches"], live_k1["chunks"],
           live_k1["frames_predicted"],
           ["%.3f" % x for x in live_k1["round_s"]],
           ["%.2f" % x for x in live_k1["ms_per_iteration"]]))
    log("bf16 round against f32 rounds at %dx%d, minibatch %d, %d "
        "iterations: bf16 (matmul resize) %s ms per iteration; "
        "f32 fused loss (phase 4) %s; f32 gather loss (phase 6) %.2f"
        % (SH, SW, MINI_BATCH, ROUND_ITERS,
           ["%.2f" % x for x in live_k1["ms_per_iteration"]],
           ["%.2f" % ev["ms_per_iteration"] for ev in events],
           experiment["early"]["ms_per_iteration"] or float("nan")))
    log("multi-video server: %s" % json.dumps(multi_video))
    log("minibatch-parallel round: %s" % json.dumps(data_parallel))
    log("TF32 round against f32 at %dx%d, minibatch %d, %d iterations, "
        "fused loss: %.2f against %.2f and %.2f ms per iteration"
        % (SH, SW, MINI_BATCH, ROUND_ITERS,
           rest["tf32_round"]["ms_per_iteration"]["default"],
           *rest["tf32_round"]["ms_per_iteration"]["highest"]))
    log("the rest of the port: %s" % json.dumps(rest))
    log("width partitioning: %s" % json.dumps(width))
    log("Orbax checkpoints and the validation gate: %s"
        % json.dumps(orbax_rec))
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
