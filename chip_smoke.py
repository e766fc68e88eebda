#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ams_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the deployed edge client's serving path at the real student's full
width (MobileNetV2-DeepLabV3, 19 logits, 512x1024 frames, batch 8) from
seeded random weights, and checks each kernel of the path on the card:

0. device line (name, power limit, torch and CUDA versions); a watchdog
   turns a hang into a traceback and a non-zero exit;
1. builds the kernels from ams_tpu_torch/csrc with nvcc (all in parallel);
2. holds each kernel against its plain PyTorch version at the path's
   shapes and times kernel, plain version and the nearest library call;
3. the main path, with every launch counter set to 0 just before it:
   predict_input on full-class and class-subset clients, delta apply on the
   float16 and int8d wires, predict again, BN-folded export, reload,
   predict_input and per-frame scoring on the folded client; plus a small
   input held against the port's own CPU forward;
4. one JSON line of kernel numbers, the wall-clock, and as the last line
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
    from ams_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")

    log("phase 1: build")
    t0 = time.perf_counter()
    info = build.build(["resize_argmax"])
    log("  built in %.2f s wall" % (time.perf_counter() - t0))
    for name, rec in info.items():
        log("  %s: %.2f s%s -> %s" % (name, rec["seconds"],
                                      " (cached)" if rec["cached"] else "",
                                      rec["path"]))
        for line in rec["ptxas"]:
            log("    " + line)

    log("phase 2: kernels against their plain versions")
    cases = phase_kernel_checks(dev)

    log("phase 3: main path (edge client, %dx%dx%d uint8 frames)" % (B, H, W))
    launches, host_fps, dev_fps = phase_main_path(dev)

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
        "shape": main_case["shape"], "cases": cases}]
    log("client throughput: %.1f frames/s end to end, %.1f frames/s on the "
        "device (batch %d, %dx%d)" % (host_fps, dev_fps, B, H, W))
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
