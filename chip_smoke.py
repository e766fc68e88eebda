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
   shapes and times kernel, plain version and the nearest library call
   (resize+argmax; resize+CE forward and backward); times the library
   form of the folded client's MBConv blocks, the work of the TPU kernels
   still to port;
3. the client path, with every launch counter set to 0 just before it:
   predict_input on full-class and class-subset clients, delta apply on the
   float16 and int8d wires, predict again, BN-folded export, reload,
   predict_input and per-frame scoring on the folded client; plus a small
   input held against the port's own CPU forward;
4. the server path, with every launch counter set to 0 just before it:
   two events of restore_initial -> train_with_deque (fused resize+CE
   loss) -> encode_delta (float16, then int8d) -> apply_downlink on an
   unfolded client -> predict_input, with the round's invariants checked;
   plus one iteration of the fused loss against the gather loss, the
   device time per iteration of both, a small round held against the
   port's own CPU round, and a profile of one iteration;
5. one JSON line of kernel numbers, the wall-clock, and as the last line
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
TIE_MARGIN = 1e-5        # top-2 margin below which ids may differ
SEED = 0
B, H, W = 8, 512, 1024   # the client's batch and frame size
SUBSET_EXP = 25          # Cityscapes-Frankfurt: 6 of the 19 classes
# the server's distillation round: run.py's defaults
SH, SW = 256, 512        # server frames (run.py --height 256)
MEMORY = 64              # frames in the server's memory
MINI_BATCH = 10          # run.py --batch_size
ROUND_ITERS = 200        # run.py --iter
LR = 1e-3                # run.py --lr
COORD_FRAC = 0.1         # run.py --coord_fraction


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

    top2 = torch.topk(resize_nchw(grid, out_hw), 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < TIE_MARGIN


def resize_argmax_bound_ms(b, c, gh, gw, h, w):
    """Least time for the function on an H100 SXM: each input read once
    and each output written once, over 3.35 TB/s; or the operations of
    the separable lerp (a horizontal lerp per grid row and class, a
    vertical lerp per pixel and class, 3 ops each) plus one compare per
    pixel and class, over 67 TFLOP/s f32.  The larger one bounds."""
    nbytes = b * c * gh * gw * 4 + b * h * w * 4 + (3 * h + 3 * w) * 4
    ops = 3 * b * c * (gh * w + h * w) + b * c * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel_checks(dev):
    """Phase 2: the resize+argmax kernel against its plain version."""
    import torch
    import torch.nn.functional as F
    from ams_tpu_torch.ops import fused_resize_argmax as fra

    cases = [("client, 19 classes", (B, 19, 33, 65, H, W)),
             ("client, exp %d subset" % SUBSET_EXP, (B, 6, 33, 65, H, W)),
             ("ragged", (3, 7, 17, 33, 257, 513))]
    gen = torch.Generator().manual_seed(SEED)
    out = []
    for label, (b, c, gh, gw, h, w) in cases:
        grid = (torch.randn(b, c, gh, gw, generator=gen) * 3).to(dev)
        got = fra.fused_resize_argmax(grid, (h, w))
        want = fra.resize_argmax_plain(grid, (h, w))
        torch.cuda.synchronize()
        ties = near_ties(grid, (h, w))
        diff = got != want
        mism, off = int(diff.sum()), int((diff & ~ties).sum())
        max_err = int((got.long() - want.long()).abs().max())
        k_ms = cuda_ms(lambda: fra.fused_resize_argmax(grid, (h, w)), 100)
        p_ms = cuda_ms(lambda: fra.resize_argmax_plain(grid, (h, w)), 10)
        lib_ms = cuda_ms(lambda: F.interpolate(
            grid, size=(h, w), mode="bilinear",
            align_corners=True).argmax(1), 10)
        bound, bound_by = resize_argmax_bound_ms(b, c, gh, gw, h, w)
        row = {"case": label, "shape": [b, c, gh, gw, h, w],
               "mismatches": mism, "mismatches_off_ties": off,
               "near_tie_pixels": int(ties.sum()), "max_abs_err": max_err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by}
        log("  %s %s: mismatches %d (off ties %d, near-tie pixels %d); "
            "kernel %.4f ms, plain %.4f ms, library %.4f ms, bound %.4f ms "
            "(%s)" % (label, row["shape"], mism, off, row["near_tie_pixels"],
                      k_ms, p_ms, lib_ms, bound, bound_by))
        check(off == 0, "resize_argmax disagrees with its plain version off "
              "ties in case %s: %d pixels" % (label, off))
        out.append(row)
    return out


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
        fra.fused_resize_argmax.launches = 0
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
    return {"resize_argmax": launches}, host_fps, B * 1e3 / dev_ms


def resize_ce_bound_ms(b, c, gh, gw, h, w, backward=False):
    """Least time for the fused resize+CE on an H100 SXM: each input read
    once and each output written once (the grid, int32 labels, f32
    weights; the scalar loss, or the grid gradient) over 3.35 TB/s; or
    the operations over 67 TFLOP/s f32: the separable lerp (3 ops per
    grid-row sample and per pixel, each class) and max/subtract/exp/add per
    pixel and class, plus log and the masked sums per pixel; the backward
    adds the softmax gradient (3 per pixel and class) and the transposed
    separable lerp (4 per pixel and class, 4 per output row, grid column
    and class).  The larger one bounds."""
    grid = b * c * gh * gw * 4
    nbytes = grid + 2 * b * h * w * 4 + (grid if backward else 8)
    ops = 3 * b * c * (gh * w + h * w) + 4 * b * c * h * w + 5 * b * h * w
    if backward:
        ops += 3 * b * c * h * w + 4 * b * c * h * w + 4 * b * c * h * gw
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_resize_ce_checks(dev):
    """Phase 2, K2: the fused resize+CE kernels, forward and backward,
    against the plain version, and their times."""
    import torch
    import torch.nn.functional as F
    from ams_tpu_torch.ops import fused_resize_ce as frc

    cases = [("server round, 19 classes", (10, 19, 17, 33, SH, SW), 0.8),
             ("server round, exp %d subset" % SUBSET_EXP,
              (10, 6, 17, 33, SH, SW), 0.8),
             ("ragged, odd height", (3, 7, 5, 9, 65, 128), 0.8),
             ("all pixels invalid", (10, 19, 17, 33, SH, SW), 0.0)]
    gen = torch.Generator().manual_seed(SEED + 7)
    out = []
    for label, (b, c, gh, gw, h, w), p_valid in cases:
        grid = (torch.randn(b, c, gh, gw, generator=gen) * 3).to(dev)
        labels = torch.randint(0, c, (b, h, w), generator=gen,
                               dtype=torch.int32).to(dev)
        weights = (torch.rand(b, h, w, generator=gen) < p_valid).float() \
            .to(dev)

        def kernel_pair():
            g = grid.clone().requires_grad_(True)
            loss = frc.fused_resize_ce(g, labels, weights, (h, w))
            return loss.detach(), torch.autograd.grad(loss, g)[0]

        def plain_pair():
            g = grid.clone().requires_grad_(True)
            loss = frc.resize_ce_plain(g, labels, weights, (h, w))
            return loss.detach(), torch.autograd.grad(loss, g)[0]

        k_loss, k_grad = kernel_pair()
        k_loss2, k_grad2 = kernel_pair()
        p_loss, p_grad = plain_pair()
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(k_loss, k_loss2)
                         and torch.equal(k_grad, k_grad2))
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

        def library_loss(g):
            full = F.interpolate(g, size=(h, w), mode="bilinear",
                                 align_corners=True)
            ce = F.cross_entropy(full, labels.long(), reduction="none")
            return torch.sum(ce * weights) / torch.clamp(torch.sum(weights),
                                                         min=1.0)

        with torch.no_grad():
            lib_err = float((library_loss(grid) - p_loss).abs())
            fwd_ms = cuda_ms(lambda: frc.resize_ce_fwd(
                grid, labels, weights, (h, w)), 50)
            bwd_ms = cuda_ms(lambda: frc.resize_ce_bwd(
                grid, labels, weights, (h, w)), 50)
            plain_fwd = cuda_ms(lambda: frc.resize_ce_plain(
                grid, labels, weights, (h, w)), 10)
            lib_fwd = cuda_ms(lambda: library_loss(grid), 10)
        g = grid.clone().requires_grad_(True)
        lp = frc.resize_ce_plain(g, labels, weights, (h, w))
        plain_bwd = cuda_ms(lambda: torch.autograd.grad(
            lp, g, retain_graph=True), 10)
        ll = library_loss(g)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            ll, g, retain_graph=True), 10)
        del lp, ll
        fb, fby = resize_ce_bound_ms(b, c, gh, gw, h, w)
        bb, bby = resize_ce_bound_ms(b, c, gh, gw, h, w, backward=True)
        row = {"case": label, "shape": [b, c, gh, gw, h, w],
               "loss": float(k_loss), "loss_abs_err": loss_err,
               "grad_max_abs_err": grad_err, "same_bits": same_bits,
               "library_loss_abs_err": lib_err,
               "fwd_ms": fwd_ms, "fwd_plain_ms": plain_fwd,
               "fwd_library_ms": lib_fwd, "fwd_bound_ms": fb,
               "fwd_bound_by": fby,
               "bwd_ms": bwd_ms, "bwd_plain_ms": plain_bwd,
               "bwd_library_ms": lib_bwd, "bwd_bound_ms": bb,
               "bwd_bound_by": bby}
        log("  resize_ce %s %s: loss %.6f (err %.3g), grad max err %.3g, "
            "same bits on rerun %s; forward kernel %.4f ms, plain %.4f, "
            "library %.4f, bound %.4f (%s); backward kernel %.4f ms, plain "
            "%.4f, library %.4f, bound %.4f (%s); library loss err %.3g"
            % (label, row["shape"], float(k_loss), loss_err, grad_err,
               same_bits, fwd_ms, plain_fwd, lib_fwd, fb, fby, bwd_ms,
               plain_bwd, lib_bwd, bb, bby, lib_err))
        out.append(row)
    return out


def mbconv_library_times(dev):
    """The folded client's MBConv blocks in cuDNN f32 (TF32 off) at the
    client's shapes: the work that the TPU kernels K3 (stride-1 blocks) and
    K4 (stride-1 and stride-2 blocks) do, which the port still runs
    unfused.  Bounds from shapes, f32 as the port computes: input, output
    and weights once over 3.35 TB/s, or the convolutions' multiply-adds
    plus bias and relu6 over 67 TFLOP/s."""
    import torch
    from ams_tpu_torch.models import layers

    gen = torch.Generator().manual_seed(SEED + 9)
    rows = []
    # (block, stride, cin, cout, input h, w): expanded_conv_2 and _1 of the
    # student at 512x1024 frames (+1 pad, stem stride 2)
    for name, stride, cin, cout, h, w in (
            ("expanded_conv_2 (stride 1, residual)", 1, 24, 24, 129, 257),
            ("expanded_conv_1 (stride 2)", 2, 16, 24, 257, 513)):
        mid = 6 * cin
        x = torch.randn(B, cin, h, w, generator=gen).to(dev)
        we = (torch.randn(1, 1, cin, mid, generator=gen) * 0.2).to(dev)
        wd = (torch.randn(3, 3, mid, 1, generator=gen) * 0.3).to(dev)
        wp = (torch.randn(1, 1, mid, cout, generator=gen) * 0.1).to(dev)
        be, bd, bp = (torch.randn(n, generator=gen).to(dev)
                      for n in (mid, mid, cout))

        def block():
            y = layers.relu6(layers.conv2d(x, we) + be[:, None, None])
            y = layers.relu6(layers.depthwise_conv2d(y, wd, stride=stride)
                             + bd[:, None, None])
            y = layers.conv2d(y, wp) + bp[:, None, None]
            return y + x if stride == 1 and cin == cout else y

        with torch.no_grad():
            ms = cuda_ms(block, 20)
            ho, wo = block().shape[2:]
        nbytes = 4 * (B * cin * h * w + B * cout * ho * wo
                      + cin * mid + 9 * mid + mid * cout + 2 * mid + cout)
        ops = (2 * B * h * w * cin * mid + 3 * B * h * w * mid
               + 2 * 9 * B * ho * wo * mid + 3 * B * ho * wo * mid
               + 2 * B * ho * wo * mid * cout + 2 * B * ho * wo * cout)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        row = {"block": name, "input": [B, cin, h, w], "library_ms": ms,
               "bound_ms": max(t_b, t_o) * 1e3,
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        log("  MBConv %s at %s: library (cuDNN f32, unfused) %.4f ms, "
            "bound %.4f ms (%s)" % (name, row["input"], ms, row["bound_ms"],
                                    row["bound_by"]))
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

    frc.resize_ce_fwd.launches = frc.resize_ce_bwd.launches = 0
    fra.fused_resize_argmax.launches = 0
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
        check(frc.resize_ce_fwd.launches == iters_run
              and frc.resize_ce_bwd.launches == iters_run,
              "event %d: resize_ce launched %d forward and %d backward for "
              "%d iterations" % (event, frc.resize_ce_fwd.launches,
                                 frc.resize_ce_bwd.launches, iters_run))
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
    launches = {"resize_ce_fwd": frc.resize_ce_fwd.launches,
                "resize_ce_bwd": frc.resize_ce_bwd.launches,
                "resize_argmax": fra.fused_resize_argmax.launches}
    log("  kernel launches on the server path: %s" % launches)
    check(launches["resize_argmax"] > 0, "the client's predict_input did "
          "not launch resize_argmax on the server path")

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
    from ams_tpu_torch.ops import fused_resize_argmax as fra
    from ams_tpu_torch.ops import fused_resize_ce as frc
    from ams_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")

    log("phase 1: build")
    t0 = time.perf_counter()
    info = build.build(["resize_argmax", "resize_ce"])
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
    mbconv = mbconv_library_times(dev)

    log("phase 3: main path (edge client, %dx%dx%d uint8 frames)" % (B, H, W))
    launches, host_fps, dev_fps = phase_main_path(dev)

    log("phase 4: server path (%d-frame memory of %dx%d, minibatch %d, %d "
        "iterations of coord_desc_auto, fused resize+CE loss)"
        % (MEMORY, SH, SW, MINI_BATCH, ROUND_ITERS))
    server_launches, events, per_iter = phase_server(dev)

    main_case = cases[0]
    kernels = [{
        "name": "resize_argmax", "route": "cuda", "source": fra.SOURCE,
        "replaces": fra.REPLACES, "launches": launches["resize_argmax"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "mismatches": main_case["mismatches"],
        "mismatches_off_ties": sum(c["mismatches_off_ties"] for c in cases),
        "server_path_launches": server_launches["resize_argmax"],
        "shape": main_case["shape"], "cases": cases}]
    ce_main = ce_cases[0]
    for part in ("fwd", "bwd"):
        key = "grad_max_abs_err" if part == "bwd" else "loss_abs_err"
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
            "same_bits_on_rerun": all(c["same_bits"] for c in ce_cases),
            "shape": ce_main["shape"],
            "cases": [{k: v for k, v in c.items()
                       if k in ("case", "shape", key) or k.startswith(part)}
                      for c in ce_cases]})
    log("client throughput: %.1f frames/s end to end, %.1f frames/s on the "
        "device (batch %d, %dx%d)" % (host_fps, dev_fps, B, H, W))
    for ev in events:
        log("server event %d: %d iterations in %.2f s (%.2f ms per iteration "
            "end to end); %s delta %d B; client mIoU %.4f -> %.4f"
            % (ev["event"], ev["iterations"], ev["round_s"],
               ev["ms_per_iteration"], ev["wire"], ev["delta_bytes"],
               ev["client_miou_before"], ev["client_miou_after"]))
    log("server device ms per iteration: fused loss %.3f, gather loss %.3f"
        % (per_iter[True], per_iter[False]))
    log("MBConv library times (the work of K3/K4): %s" % json.dumps(mbconv))
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
