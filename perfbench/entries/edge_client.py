"""The deployed edge client: ``runtime.network.SemanticNetwork`` built from
the BN-folded student (``models.frozen.fold_student``, as
``save_to_frozen_graph`` folds it), frozen, in the configuration's type,
over one camera's class subset; ``predict_input`` on batches of frames
from a seeded pool (upload, folded forward, K1 over the subset, ids
downloaded).

The check runs the unfolded reference student in float32 with its
moving statistics over a seeded sample of the answered requests, and
reads the widest gap by which a served id's logit lies below the best of
the subset.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import frames, seeds, serving, weights
from perfbench.reference import student as ref
from perfbench.counts.bounds import ELEM_BYTES
from perfbench.reference.common import tf32_off

REFERENCE_BLOCK = 8


def inputs(ctx) -> dict:
    """The seeded student (BN statistics calibrated by the reference) and
    the pool of frame batches: what both sides get."""
    tf32_off()
    tr, dev = ctx.traffic, ctx.device
    params = weights.init(ref.param_specs(ctx.config["num_classes"]),
                          seeds.sub(ctx.seed, "student"), dev)
    with ctx.reference_time():
        ref.calibrate(params, frames.frames(tr["calibration_frames"],
                                            tr["height"], tr["width"],
                                            seeds.sub(ctx.seed,
                                                      "calibration"), dev))
    return {"params": params, "batches": serving.pool(ctx),
            "classes": list(tr["classes"])}


def setup(ctx) -> dict:
    from ams_tpu_torch.models.frozen import fold_student
    from ams_tpu_torch.runtime.network import SemanticNetwork
    from ams_tpu_torch.utils.platform import resolve_device

    resolve_device(ctx.device)
    st = inputs(ctx)
    ctx.log("inputs made: the student's weights, %d batches of frames"
            % len(st["batches"]))
    tr, cfg = ctx.traffic, ctx.config
    weights_exp = np.zeros(cfg["num_classes"], np.float32)
    weights_exp[tr["classes"]] = 1.0
    st["net"] = SemanticNetwork(
        fold_student(st["params"]), class_weights_exp=weights_exp,
        height=tr["height"], frozen=True, compute_dtype=cfg["compute_dtype"],
        device=ctx.device)
    st["net"].predict_input(st["batches"][0])   # the one shape it uses
    ctx.facts["k1"] = dict(b=tr["batch"], c=len(tr["classes"]),
                           gh=-(-(tr["height"] + 1) // 16),
                           gw=-(-(tr["width"] + 1) // 16),
                           h=tr["height"], w=tr["width"],
                           elem_bytes=ELEM_BYTES[cfg["compute_dtype"]])
    ctx.facts["infer_shape"] = ("student", tr["batch"], tr["height"],
                                tr["width"])
    return st


def window(ctx, st) -> dict:
    return serving.window(ctx, st["net"].predict_input, st["batches"])


def release(ctx, st) -> None:
    st.pop("net", None)


def reference_logits(ctx, st, frames_np, rounding=None):
    """Blocks of (b, len(classes), H, W) float32 logits."""
    x = torch.from_numpy(frames_np).to(ctx.device)
    for blk in serving.blocks(x, REFERENCE_BLOCK):
        with torch.no_grad():   # not around the yield: it would leak
            out = ref.logits(st["params"], blk, st["classes"],
                             rounding=rounding)
        yield out


def check(ctx, st) -> dict:
    tf32_off()
    return serving.answer_gaps(ctx, st, reference_logits,
                               ctx.window["sample"])
