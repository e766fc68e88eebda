"""The server's teacher labeler: ``runtime.labeler.make_teacher_labeler``
loading a checkpoint of the benchmark's seeded teacher, its ``label()``
called on batches of frames from a seeded pool.  The labeler pads each
frame by one row and column (top, left; symmetric), runs the teacher in
the configuration's type in fixed chunks, labels with K1 and un-pads.

The check runs the reference teacher in float32 over a seeded sample of
the answered requests, padded as AMS pads, and reads the widest gap by
which a served id's logit lies below the best.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from perfbench.lib import frames, seeds, serving, weights
from perfbench.reference import teacher as ref
from perfbench.counts.bounds import ELEM_BYTES
from perfbench.reference.common import tf32_off

REFERENCE_BLOCK = 4          # frames per block of the reference


def pad_like_ams(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H + 1, W + 1, 3): one row on top and one column
    at the left, mirrored (numpy's "symmetric" pad of 1 repeats the
    edge)."""
    x = torch.cat([x[:, :1], x], dim=1)
    return torch.cat([x[:, :, :1], x], dim=2)


def inputs(ctx) -> dict:
    """The seeded teacher (BN statistics calibrated by the reference) and
    the pool of frame batches: what both sides get."""
    tf32_off()
    tr, dev = ctx.traffic, ctx.device
    params = weights.init(ref.param_specs(ctx.config["num_classes"]),
                          seeds.sub(ctx.seed, "teacher"), dev)
    calib = frames.frames(tr["calibration_frames"], tr["height"],
                          tr["width"], seeds.sub(ctx.seed, "calibration"), dev)
    with ctx.reference_time():
        ref.calibrate(params, pad_like_ams(calib))
    return {"params": params, "batches": serving.pool(ctx)}


def setup(ctx) -> dict:
    from ams_tpu_torch.runtime.labeler import make_teacher_labeler
    from ams_tpu_torch.utils.platform import resolve_device

    resolve_device(ctx.device)
    st = inputs(ctx)
    ctx.log("inputs made: the teacher's weights, %d batches of frames"
            % len(st["batches"]))
    tr = ctx.traffic
    fd, path = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        np.savez(path, **{k: v.cpu().numpy() for k, v in st["params"].items()})
        st["label"] = make_teacher_labeler(
            teacher_checkpoint=path,
            compute_dtype=ctx.config["compute_dtype"], device=ctx.device)
    finally:
        os.remove(path)
    st["label"](st["batches"][0])      # the one shape the traffic uses
    # the benchmark's copy waits on the host while the program runs
    st["params"] = {k: v.cpu() for k, v in st["params"].items()}
    h, w = tr["height"] + 1, tr["width"] + 1
    ctx.facts["k1"] = dict(b=tr["batch"], c=ctx.config["num_classes"],
                           gh=-(-h // 16), gw=-(-w // 16), h=h, w=w,
                           elem_bytes=ELEM_BYTES[ctx.config["compute_dtype"]])
    ctx.facts["infer_shape"] = ("teacher", tr["batch"], h, w)
    return st


def window(ctx, st) -> dict:
    return serving.window(ctx, st["label"], st["batches"])


def release(ctx, st) -> None:
    st.pop("label", None)


def reference_logits(ctx, st, frames_np, rounding=None):
    """Blocks of (b, C, H, W) float32 logits of unpadded frames."""
    if "params_dev" not in st:
        st["params_dev"] = {k: v.to(ctx.device)
                            for k, v in st["params"].items()}
        st["params"] = st["params_dev"]
    x = torch.from_numpy(frames_np).to(ctx.device)
    for blk in serving.blocks(x, REFERENCE_BLOCK):
        with torch.no_grad():   # not around the yield: it would leak
            out = ref.logits(st["params_dev"], pad_like_ams(blk),
                             rounding=rounding)[:, :, 1:, 1:]
        yield out


def check(ctx, st) -> dict:
    tf32_off()
    return serving.answer_gaps(ctx, st, reference_logits,
                               ctx.window["sample"])
