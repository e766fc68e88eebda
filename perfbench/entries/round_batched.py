"""The batched-weights multi-video round: a server distilling for several
edge cameras at once, as ``parallel.make_vmapped_multi_video_round`` with
class masks (``MultiVideoServer``'s union of the cameras' class subsets,
each camera's {0, 1} row), all cameras' students starting from one
checkpoint.

Set-up makes every input from the seed (the students' weights with their
BN statistics calibrated by the reference, each camera's frame memory and
teacher labels, each camera's draw generator), builds the round, and
drives the server's state through the round's first ``checked_steps``
iterations: the round at one iteration (the peeled float32 selection),
then at the rest with the masks kept, which together are the first
iterations of a whole round, draw for draw.  The window then runs whole
rounds from that state: a round starts while the elapsed time plus the
last round's time stays within ``--seconds``, and one always runs.

The check runs the reference's first steps from the same weights, inputs
and draws, and compares each step's loss, the first gradient (Adam's
first moment after one step over 1 - beta1) and the change of every
trainable and BN moving statistic after the steps, each by its worst leaf.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from perfbench.lib import compare, frames, seeds, weights
from perfbench.reference import student as ref
from perfbench.reference.common import CONTROL_ROUNDING, tf32_off

def inputs(ctx) -> dict:
    """What the benchmark makes from the seed and hands to both sides."""
    tr, dev, seed = ctx.traffic, ctx.device, ctx.seed
    cams = tr["cameras"]
    h, w, n = tr["height"], tr["width"], tr["memory_frames"]
    union = tuple(sorted(set().union(*[c["classes"] for c in cams])))
    tf32_off()
    params0 = weights.init(ref.param_specs(ctx.config["num_classes"]),
                           seeds.sub(seed, "student"), dev)
    with ctx.reference_time():
        ref.calibrate(params0, frames.frames(tr["calibration_frames"], h, w,
                                             seeds.sub(seed, "calibration"),
                                             dev))
    return {
        "union": union,
        "class_mask": torch.tensor(
            [[1.0 if u in c["classes"] else 0.0 for u in union] for c in cams],
            device=dev),
        "params0": params0,
        "frames": torch.stack([frames.frames(n, h, w,
                                             seeds.sub(seed, "memory", v), dev)
                               for v in range(len(cams))]),
        "labels": torch.stack([frames.labels(n, h, w,
                                             ctx.config["num_classes"],
                                             seeds.sub(seed, "labels", v), dev)
                               for v in range(len(cams))]),
        "draw_seeds": [seeds.sub(seed, "draws", v) for v in range(len(cams))],
    }


def _spec(ctx, union):
    from ams_tpu_torch.distill.train_step import DistillSpec

    tr, cfg = ctx.traffic, ctx.config
    return DistillSpec(iters=tr["iters"], batch_size=tr["minibatch"],
                       num_classes=cfg["num_classes"], class_indices=union,
                       strategy=tr["strategy"], coord_frac=tr["coord_frac"],
                       compute_dtype=cfg["compute_dtype"],
                       select_dtype=cfg["select_dtype"])


def setup(ctx) -> dict:
    from ams_tpu_torch.distill.optimizer import adam_init
    from ams_tpu_torch.distill.train_step import all_true_mask, split_params
    from ams_tpu_torch.parallel import (
        make_vmapped_multi_video_round,
        stack_videos,
    )
    from ams_tpu_torch.utils.platform import resolve_device

    resolve_device(ctx.device)
    st = inputs(ctx)
    ctx.log("inputs made: weights, %d memories" % len(ctx.traffic["cameras"]))
    tr, dev = ctx.traffic, ctx.device
    v_count = len(tr["cameras"])
    p0 = st["params0"]
    spec = _spec(ctx, st["union"])
    st.update(
        params=stack_videos([p0] * v_count),
        opt=stack_videos([adam_init(split_params(p0)[0])
                          for _ in range(v_count)]),
        mask=stack_videos([all_true_mask(p0) for _ in range(v_count)]),
        gens=[torch.Generator(device=dev).manual_seed(s)
              for s in st["draw_seeds"]],
        n_valid=[tr["memory_frames"]] * v_count)

    def run(fn):
        out = fn(st["params"], st["opt"], st["frames"], st["labels"],
                 st["n_valid"], st["gens"], tr["lr"], st["mask"],
                 st["class_mask"])
        st["params"], st["opt"], st["mask"] = out[:3]
        return out[3].cpu()

    k = tr["checked_steps"]
    losses = [run(make_vmapped_multi_video_round(
        dataclasses.replace(spec, iters=1), with_class_mask=True))]
    b1 = ref.ADAM_B1
    grad1 = {key: (m / (1.0 - b1)).cpu() for key, m in st["opt"].m.items()}
    losses.append(run(make_vmapped_multi_video_round(
        dataclasses.replace(spec, iters=k - 1), reselect=False,
        with_class_mask=True)))
    st["program"] = {
        "loss": torch.cat(losses, dim=1),
        "grad1": [{key: g[v] for key, g in grad1.items()}
                  for v in range(v_count)],
        "params": [{key: t[v].cpu() for key, t in st["params"].items()}
                   for v in range(v_count)]}
    ctx.log("the round's first %d iterations run" % k)
    st["round"] = make_vmapped_multi_video_round(spec, with_class_mask=True)
    st["run"] = run
    ctx.facts["train_shape"] = (tr["minibatch"], tr["height"], tr["width"],
                                st["union"])
    return st


def window(ctx, st) -> dict:
    tr = ctx.traffic
    t0 = time.perf_counter()
    rounds = failed = 0
    last, lat = 0.0, []
    while rounds == 0 or time.perf_counter() - t0 + last <= ctx.seconds:
        ts = time.perf_counter()
        losses = st["run"](st["round"])
        last = time.perf_counter() - ts
        lat.append(last * 1e3)
        rounds += 1
        failed += int(not bool(torch.isfinite(losses).all()))
    window_s = time.perf_counter() - t0
    steps = rounds * tr["iters"] * len(tr["cameras"])
    return {"attempted": rounds, "failed": failed, "window_s": window_s,
            "frames": steps * tr["minibatch"], "steps": steps,
            "latencies_ms": lat}


def release(ctx, st) -> None:
    for key in ("params", "opt", "mask", "gens", "round", "run"):
        st.pop(key, None)


def reference_record(ctx, st, roundings, half_batch=False) -> list:
    """The reference's first steps for every camera, with each step's
    convolution rounding; ``half_batch``: the fault of a step that takes
    the loss over the first half of its minibatch only."""
    tr, dev = ctx.traffic, ctx.device
    tf32_off()
    recs = []
    for v, s in enumerate(st["draw_seeds"]):
        gen = torch.Generator(device=dev).manual_seed(s)
        draws = [torch.randint(0, tr["memory_frames"], (tr["minibatch"],),
                               generator=gen, device=dev)
                 for _ in range(len(roundings))]
        if half_batch:
            draws = [d[:len(d) // 2] for d in draws]
        recs.append(ref.train_steps(
            st["params0"], st["frames"][v], st["labels"][v], draws,
            union=st["union"], class_mask=st["class_mask"][v], lr=tr["lr"],
            frac=tr["coord_frac"], roundings=roundings))
    return recs


def control_roundings(ctx) -> list:
    cfg = ctx.config
    k = ctx.traffic["checked_steps"]
    return [CONTROL_ROUNDING[cfg["select_dtype"]]] \
        + [CONTROL_ROUNDING[cfg["compute_dtype"]]] * (k - 1)


def numbers(got: list, want: list, params0: dict) -> dict:
    """The numbers of records ``got`` (the program's, or the control's)
    against the reference's ``want``, each camera's worst: each step's
    loss (relative), the first gradient by its worst leaf, the change of
    the trainables after the steps by its median leaf and by its worst,
    and the change of the BN moving statistics by its worst leaf.  The
    change leaves exclude those whose reference gradient is under a
    thousandth of the median leaf's: Adam moves them by rounding alone."""
    out = dict.fromkeys(("loss_step1", "loss_later", "grad_step1",
                         "change_median_leaf", "change_worst_leaf",
                         "change_bn"), 0.0)
    stats = sorted(k for k in params0 if not ref.trainable(k))
    for g, r in zip(got, want):
        for i, (a, b) in enumerate(zip(g["loss"], r["loss"])):
            key = "loss_step1" if i == 0 else "loss_later"
            out[key] = max(out[key], abs(float(a) - b) / abs(b))
        train = sorted(r["grad1"])
        out["grad_step1"] = max(out["grad_step1"], compare.leaf_norm_gap(
            g["grad1"], r["grad1"], train))
        norms = {k: float(torch.linalg.vector_norm(r["grad1"][k]))
                 for k in train}
        floor = 1e-3 * statistics.median(norms.values())
        moved = [k for k in train if norms[k] >= floor]

        def change(rec, keys):
            return {k: rec["params"][k].to(params0[k].device) - params0[k]
                    for k in keys}
        gp, rp = change(g, moved), change(r, moved)
        out["change_median_leaf"] = max(out["change_median_leaf"],
                                        compare.median_leaf_gap(gp, rp, moved))
        out["change_worst_leaf"] = max(out["change_worst_leaf"],
                                       compare.leaf_norm_gap(gp, rp, moved))
        out["change_bn"] = max(out["change_bn"], compare.leaf_norm_gap(
            change(g, stats), change(r, stats), stats))
    return out


def program_records(st) -> list:
    prog = st["program"]
    return [{"loss": prog["loss"][v], "grad1": prog["grad1"][v],
             "params": prog["params"][v]} for v in range(len(prog["grad1"]))]


def check(ctx, st) -> dict:
    want = reference_record(ctx, st, [None] * ctx.traffic["checked_steps"])
    return numbers(program_records(st), want, st["params0"])
