"""Batched teacher label extraction.

Counterpart of ``ams_tpu/runtime/labeler.py``.  The teacher labels frames
in fixed-size batches; the artifacts are the reference's: ``gt_%06d.png``
(uint8 class ids), ``annot_%06d.png`` (colourised) and ``vis_%06d.png``
(frame and colours blended half and half), with the reference's +1
symmetric pad on top and left before the teacher and the un-pad of that
row and column after it, and its progress lines.  ``make_teacher_labeler``
is the one label path: ``extract_labels`` labels through it.  PNG
writing, cv2's resize and ``addWeighted`` come from ``data/image.py``; the
clip is a frame directory (``data/video.py``).

The default bfloat16 path folds the teacher's inference BN into its
convolutions once, at load (``fold_teacher``: bf16 weights, offsets
added where each convolution writes its output), and ends in the fused
upsample+argmax kernel (``teacher_predict_fast``, one launch per chunk);
float32 keeps the raw params, BN unfused, and takes the
argmax of the full-resolution logits, as the JAX package's
``teacher_outputs(...)["predictions"]``.  Frames go to the device as
uint8 and are cast there.  Labels do not depend on the chunk size:
inference BN couples no two frames.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
from ams_tpu_torch.data.image import (
    add_weighted_u8,
    bgr_to_rgb,
    png_write,
    resize_linear_u8,
    rgb_to_bgr,
)
from ams_tpu_torch.data.video import open_video
from ams_tpu_torch.models import layers
from ams_tpu_torch.models.xception_deeplab import (
    TEACHER_OS16,
    TeacherConfig,
    fold_teacher,
    init_teacher_params,
    teacher_predict_fast,
    teacher_predictions,
)
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.colormap import colormap
from ams_tpu_torch.utils.platform import resolve_device
from ams_tpu_torch.utils.trace import GLOBAL_TIMER


def auto_batch(height: int) -> int:
    """Default frames per teacher call, by frame height: 32 up to 320
    rows, 16 up to 640, 8 beyond.  The JAX package chose these steps
    against a TPU's memory; the port keeps them, since they fix the
    labeler's chunking (ROADMAP §C)."""
    if height <= 320:
        return 32
    if height <= 640:
        return 16
    return 8


def _load_teacher_params(teacher_checkpoint: Optional[str], seed: int,
                         device, config: Optional[TeacherConfig] = None):
    """Teacher params of ``config`` (None: the AMS teacher) on ``device``:
    a checkpoint's values (names with or without a ``teacher/`` prefix)
    over the seeded init, or the seeded init alone when no checkpoint is
    named.  A named checkpoint that is missing raises: synthetic weights
    are opt-in by omitting the path, never a fallback for a typo.  So does
    a named checkpoint without every ``decoder/`` variable of a
    configuration with a decoder (a teacher saved without one, or under
    other names): a seeded decoder never stands in for a trained one."""
    config = config or TEACHER_OS16
    if teacher_checkpoint:
        loaded = ckpt.load_any(teacher_checkpoint)  # missing path raises
        loaded = {k.removeprefix("teacher/"): v for k, v in loaded.items()}
        base = params_to_numpy(init_teacher_params(seed, device="cpu",
                                                   config=config))
        names = {ckpt.strip_suffix(k) for k in loaded}
        missing = sorted(k for k in base
                         if k.startswith("decoder/") and k not in names)
        if missing:
            raise ValueError(
                "teacher checkpoint %s lacks %d of the decoder's variables "
                "(e.g. %s): it holds no decoder for %r"
                % (teacher_checkpoint, len(missing), missing[:3], config))
        return params_from_numpy(ckpt.merge_restore(base, loaded), device)
    return init_teacher_params(seed, device=device, config=config)


def _make_predict(compute_dtype: str, device,
                  config: Optional[TeacherConfig] = None):
    """-> predict(params, frames uint8 (N, H, W, 3) numpy) -> int32 ids
    (N, H, W) numpy, of the teacher ``config`` names (None: the AMS
    teacher); bfloat16 takes the fused fast path."""
    cd = layers.as_dtype(compute_dtype)
    config = config or TEACHER_OS16
    if cd == torch.bfloat16:
        forward = functools.partial(teacher_predict_fast, config=config)
    else:
        forward = functools.partial(teacher_predictions, compute_dtype=cd,
                                    config=config)

    def predict(params, frames: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            with GLOBAL_TIMER.span("labeler/upload"):
                x = torch.from_numpy(frames).to(device)
            with GLOBAL_TIMER.span("labeler/forward"):
                ids = forward(params, x)
            with GLOBAL_TIMER.span("labeler/download"):
                return ids.cpu().numpy()
    return predict


def _predict_fixed_batch(predict, params, arr: np.ndarray,
                         batch: int) -> np.ndarray:
    """Run ``predict`` over ``arr`` (N, H, W, 3) in chunks of exactly
    ``batch`` frames: the tail chunk is padded by repeating its last frame
    and the padded rows are sliced off, so every call has one shape (as
    the JAX package does for its one compiled program).  An empty draw
    makes no call.  Spans: ``labeler/chunk`` per call, ``labeler/join``
    around the chunks' concatenation."""
    n = arr.shape[0]
    outs = []
    for s in range(0, n, batch):
        with GLOBAL_TIMER.span("labeler/chunk"):
            chunk = arr[s:s + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            preds = np.asarray(predict(params, chunk))
            outs.append(preds[:batch - pad] if pad else preds)
    if not outs:
        return np.empty((0, arr.shape[1], arr.shape[2]), np.uint8)
    with GLOBAL_TIMER.span("labeler/join"):
        return np.concatenate(outs)


def make_teacher_labeler(teacher_checkpoint: Optional[str] = None,
                         compute_dtype: str = "bfloat16", seed: int = 0,
                         batch: Optional[int] = None, device=None,
                         teacher_config: Optional[TeacherConfig] = None):
    """-> labeler(frames uint8 (N, H, W, 3) RGB) -> labels uint8 (N, H, W).

    Pads each frame +1 symmetric on top and left, runs the teacher on
    ``device`` (default the card) in fixed ``batch``-size chunks
    (``_predict_fixed_batch``), and drops the padded row and column.
    ``batch=None`` resolves from the first call's (unpadded) frame height
    by ``auto_batch`` and then stays.  In bfloat16 the params are folded
    at load (``fold_teacher``).  Without a checkpoint the teacher is
    seeded synthetic (for tests and demos); a named but missing path
    raises.  ``teacher_config`` chooses the teacher
    (``models.xception_deeplab.TeacherConfig``; None: the AMS teacher).
    Spans: ``labeler/label`` per call, inside it ``labeler/pad``, per
    chunk ``labeler/chunk`` (``labeler/upload``, ``labeler/forward``: the
    teacher and K1 enqueued, with the teacher's ``teacher/trunk``,
    ``teacher/aspp`` and, with a decoder, ``teacher/decoder`` inside it;
    ``labeler/download``), ``labeler/join`` and ``labeler/unpad``."""
    dev = resolve_device(device)
    params = _load_teacher_params(teacher_checkpoint, seed, dev,
                                  teacher_config)
    if layers.as_dtype(compute_dtype) == torch.bfloat16:
        params = fold_teacher(params, torch.bfloat16)
    predict = _make_predict(compute_dtype, dev, teacher_config)
    resolved = {"batch": batch}

    def label(frames: np.ndarray) -> np.ndarray:
        with GLOBAL_TIMER.span("labeler/label"):
            frames = np.asarray(frames, np.uint8)
            if resolved["batch"] is None:
                # from the UNPADDED height: the +1 pad would tip the exact
                # thresholds (320, 640) into the next-smaller batch
                resolved["batch"] = auto_batch(int(frames.shape[1]))
            with GLOBAL_TIMER.span("labeler/pad"):
                arr = np.pad(frames, ((0, 0), (1, 0), (1, 0), (0, 0)),
                             mode="symmetric")
            preds = _predict_fixed_batch(predict, params, arr,
                                         resolved["batch"])
            with GLOBAL_TIMER.span("labeler/unpad"):
                return preds[:, 1:, 1:].astype(np.uint8)

    return label


def extract_labels(input_video: str, dump_path: str,
                   teacher_checkpoint: Optional[str] = None,
                   height: Optional[int] = None, batch: Optional[int] = None,
                   max_frames: Optional[int] = None,
                   compute_dtype: str = "bfloat16", device=None,
                   teacher_config: Optional[TeacherConfig] = None) -> int:
    """Label the clip (a frame directory) with ``make_teacher_labeler`` on
    ``device`` (default the card) and write each frame's ``gt_``,
    ``annot_`` and ``vis_`` PNGs into ``dump_path``.  ``height`` resizes
    frames to (height, 2 height) first (cv2's bilinear); ``batch=None``
    resolves from the first frame's height by ``auto_batch``.  The frame
    limit is the experiment's test length times the clip's fps, capped by
    ``max_frames``.  ``teacher_config`` chooses the teacher as in
    ``make_teacher_labeler``.  Returns the number of frames labelled.
    Spans: ``labeler/load`` (the labeler, built at the first frame),
    ``labeler/read`` (decode, resize), ``labeler/predict`` (one
    ``labeler/label`` call per batch) and ``labeler/write``."""
    dev = resolve_device(device)
    os.makedirs(dump_path, exist_ok=True)
    exp_num = exp_configs.video_exp_num(input_video)
    cmap = colormap()

    reader = open_video(input_video, prefetch=True)
    fps = reader.fps
    limit = exp_configs.test_length(exp_num) * fps
    if max_frames is not None:
        limit = min(limit, max_frames) if limit else max_frames
    if not limit:
        limit = reader.frame_count

    index = 0
    frames = []
    label = None

    def flush():
        nonlocal index
        with GLOBAL_TIMER.span("labeler/predict"):
            labels = label(np.stack(frames))
        with GLOBAL_TIMER.span("labeler/write"):
            for j, (frame, out) in enumerate(zip(frames, labels), index):
                png_write(os.path.join(dump_path, "gt_%06d.png" % j), out)
                colored = cmap[out]
                png_write(os.path.join(dump_path, "annot_%06d.png" % j),
                          rgb_to_bgr(colored))
                overlay = add_weighted_u8(frame, 0.5, colored, 0.5, 0)
                png_write(os.path.join(dump_path, "vis_%06d.png" % j),
                          rgb_to_bgr(overlay))
        index += len(frames)
        frames.clear()

    try:
        while index + len(frames) < limit:
            with GLOBAL_TIMER.span("labeler/read"):
                frame = reader.read()
                if frame is None:
                    break
                frame = bgr_to_rgb(frame)
                if height is not None:
                    frame = resize_linear_u8(frame, (height, height * 2))
            if label is None:
                if batch is None:
                    batch = auto_batch(int(frame.shape[0]))
                with GLOBAL_TIMER.span("labeler/load"):
                    label = make_teacher_labeler(
                        teacher_checkpoint, compute_dtype, seed=0,
                        batch=batch, device=dev,
                        teacher_config=teacher_config)
                begin = time.time()
            frames.append(frame)
            if len(frames) == batch:
                flush()
                if index % 100 < batch:
                    etf = (time.time() - begin) / max(index, 1) \
                        * (limit - index)
                    print("Have computed %d frames so far, ETF: "
                          "%02d:%02d.%02d" % (index, etf // 60, etf % 60,
                                              (etf * 100) % 100))
        if frames:
            flush()
    finally:
        reader.release()
    return index
