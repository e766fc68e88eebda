"""The server's teacher labeler with DeepLabV3+ Xception-65: the labeler of
``entries/labeler.py`` (``runtime.labeler.make_teacher_labeler`` from a
checkpoint of the benchmark's seeded teacher, ``label()`` on batches of a
seeded pool), given the configuration's teacher
(``models.xception_deeplab.deeplab_teacher`` of its ``output_stride`` and
``decoder_output_stride``) and the weights of
``reference/teacher_v3plus.py``.  The labeler pads each frame by one row
and column, runs the teacher in fixed chunks, labels the decoder's
stride-4 grid with K1 and un-pads.

The check runs the reference in float32 over a seeded sample of the
answered requests, padded as AMS pads, in blocks of ``REFERENCE_BLOCK``
frames, and reads the widest gap by which a served id's logit lies below
the best.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from perfbench.counts.bounds import ELEM_BYTES
from perfbench.entries.labeler import pad_like_ams
# the window and the release are the labeler's own
from perfbench.entries.labeler import release, window  # noqa: F401
from perfbench.lib import frames, seeds, serving, weights
from perfbench.reference import teacher_v3plus as ref
from perfbench.reference.common import tf32_off

REFERENCE_BLOCK = 4          # frames per block of the reference


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
        ref.calibrate(params, pad_like_ams(calib),
                      output_stride=ctx.config["output_stride"])
    return {"params": params, "batches": serving.pool(ctx)}


def setup(ctx) -> dict:
    # a program without configurable teachers fails here, before any work
    from ams_tpu_torch.models.xception_deeplab import deeplab_teacher
    from ams_tpu_torch.runtime.labeler import make_teacher_labeler
    from ams_tpu_torch.utils.platform import resolve_device

    resolve_device(ctx.device)
    conf, tr = ctx.config, ctx.traffic
    teacher = deeplab_teacher(conf["output_stride"],
                              conf["decoder_output_stride"])
    st = inputs(ctx)
    ctx.log("inputs made: the teacher's weights, %d batches of frames"
            % len(st["batches"]))
    fd, path = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        np.savez(path, **{k: v.cpu().numpy() for k, v in st["params"].items()})
        st["label"] = make_teacher_labeler(
            teacher_checkpoint=path, compute_dtype=conf["compute_dtype"],
            device=ctx.device, teacher_config=teacher)
    finally:
        os.remove(path)
    st["label"](st["batches"][0])      # the one shape the traffic uses
    # the benchmark's copy waits on the host while the program runs
    st["params"] = {k: v.cpu() for k, v in st["params"].items()}
    h, w = tr["height"] + 1, tr["width"] + 1
    stride = conf["decoder_output_stride"] or conf["output_stride"]
    ctx.facts["k1"] = dict(b=tr["batch"], c=conf["num_classes"],
                           gh=-(-h // stride), gw=-(-w // stride), h=h, w=w,
                           elem_bytes=ELEM_BYTES[conf["compute_dtype"]])
    ctx.facts["infer_shape"] = ("teacher_v3plus", tr["batch"], h, w)
    return st


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
                             rounding=rounding,
                             output_stride=ctx.config["output_stride"]
                             )[:, :, 1:, 1:]
        yield out


def check(ctx, st) -> dict:
    tf32_off()
    return serving.answer_gaps(ctx, st, reference_logits,
                               ctx.window["sample"])
