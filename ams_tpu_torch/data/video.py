"""Video and ground-truth label IO on frame directories.

Counterpart of ``ams_tpu/data/video.py``, whose clips are mp4 files read by
OpenCV.  The card machine has no OpenCV and no mp4 decoder, so the port's
clip is a **frame directory**: ``frame_%06d.png`` files holding the BGR
frames a decoder gives, plus ``clip.json`` with ``{"fps": int, "frames":
n}``.  ``tools/torch_frames_from_video.py`` turns an mp4 into one with
OpenCV, where OpenCV exists.  Name the directory as the clip was named
(``90-synthetic.mp4``, or ``90-synthetic``): the experiment number and the
artifact names come from its base name.

The readers keep the JAX package's conventions (the reference's run.py:
105-112, 158-167, 413-421): integer fps, frame seek by index, BGR->RGB
plus bilinear resize for frames, nearest resize plus an optional COCO
remap for labels, and a premature end of the video as a hard error.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from ams_tpu_torch.data.image import (
    bgr_to_rgb,
    png_read,
    png_write,
    resize_linear_u8,
    resize_nearest,
)

CLIP_META = "clip.json"


def frame_path(clip_dir: str, index: int) -> str:
    return os.path.join(clip_dir, "frame_%06d.png" % index)


def write_clip_meta(clip_dir: str, fps: int, frames: int) -> None:
    with open(os.path.join(clip_dir, CLIP_META), "w") as f:
        json.dump({"fps": int(fps), "frames": int(frames)}, f)


class VideoReader:
    """Sequential frame reader over a frame directory."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, CLIP_META)
        if not os.path.isfile(meta_path):
            raise IOError("Error opening video stream or file: %s (a frame "
                          "directory with %s)" % (path, CLIP_META))
        with open(meta_path) as f:
            meta = json.load(f)
        self.fps = int(round(float(meta.get("fps", 0))))
        if self.fps <= 0:
            # downstream divides by fps (send rates, schedule lengths)
            warnings.warn("no fps in %s; assuming 30" % meta_path)
            self.fps = 30
        self.frame_count = int(meta["frames"])
        self._pos = 0

    def seek_frame(self, index: int) -> None:
        self._pos = int(index)

    def read(self) -> Optional[np.ndarray]:
        """Next frame as BGR uint8, or None at the end of the clip."""
        if self._pos >= self.frame_count:
            return None
        frame = png_read(frame_path(self.path, self._pos))
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise IOError("frame %d of %s is not a BGR image (shape %s)"
                          % (self._pos, self.path, frame.shape))
        self._pos += 1
        return frame

    def read_or_die(self) -> np.ndarray:
        frame = self.read()
        if frame is None:
            raise EOFError("Premature end of video")
        return frame

    def release(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class PrefetchingVideoReader:
    """VideoReader with a background decode thread and a bounded buffer.

    Keeps up to ``depth`` frames decoded ahead, so PNG decode (zlib and the
    row filters, which release the interpreter lock for most of their
    work) overlaps device compute.  API-compatible with VideoReader; only
    the worker thread touches the inner reader, and seeks flush the buffer
    through an epoch counter.
    """

    def __init__(self, path: str, depth: int = 32):
        self._inner = VideoReader(path)
        self.path = path
        self.fps = self._inner.fps
        self.frame_count = self._inner.frame_count
        self._depth = max(1, depth)
        self._buf = []
        self._cv = threading.Condition()
        self._eof = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._epoch = 0
        self._pending_seek: Optional[int] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # surface decode failures to the reader
            with self._cv:
                self._error = e
                self._cv.notify_all()
        finally:
            self._inner.release()

    def _worker_loop(self):
        while True:
            with self._cv:
                while (not self._stop and self._pending_seek is None
                       and (len(self._buf) >= self._depth or self._eof)):
                    self._cv.wait()
                if self._stop:
                    return
                seek = self._pending_seek
                self._pending_seek = None
                epoch = self._epoch
            # decode outside the lock; only this thread touches the reader
            if seek is not None:
                self._inner.seek_frame(seek)
            frame = self._inner.read()
            with self._cv:
                if self._epoch != epoch:
                    continue  # a seek landed mid-decode: drop the stale frame
                if frame is None:
                    self._eof = True
                else:
                    self._buf.append(frame)
                self._cv.notify_all()

    def seek_frame(self, index: int) -> None:
        with self._cv:
            self._epoch += 1
            self._buf.clear()
            self._eof = False
            self._pending_seek = int(index)
            self._cv.notify_all()

    def read(self) -> Optional[np.ndarray]:
        with self._cv:
            while (not self._buf and not self._eof and self._error is None
                   and not self._stop):
                self._cv.wait()
            if self._buf:
                frame = self._buf.pop(0)
                self._cv.notify_all()
                return frame
            if self._error is not None:
                raise IOError("video decode worker failed for %s"
                              % self.path) from self._error
            if self._stop:
                raise RuntimeError("read() after release() on %s" % self.path)
            return None

    def read_or_die(self) -> np.ndarray:
        frame = self.read()
        if frame is None:
            raise EOFError("Premature end of video")
        return frame

    def release(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def open_video(path: str, prefetch: bool = False):
    return PrefetchingVideoReader(path) if prefetch else VideoReader(path)


def frame_to_rgb(frame_bgr: np.ndarray, size_hw: Tuple[int, int]
                 ) -> np.ndarray:
    """Resize (cv2's bilinear) and convert BGR->RGB (run.py:181-182)."""
    return bgr_to_rgb(resize_linear_u8(frame_bgr, size_hw))


def load_gt_label(gt_path: str, index: int,
                  size_hw: Optional[Tuple[int, int]] = None,
                  coco_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Read gt_%06d.png (a gray PNG of uint8 class ids) with an optional
    nearest resize and COCO remap (run.py:163, 183-187, 420-421)."""
    path = "%sgt_%06d.png" % (gt_path, index)
    if not os.path.isfile(path):
        raise IOError("missing ground-truth label %s" % path)
    label = png_read(path)
    if label.ndim != 2:
        raise IOError("ground-truth label %s is not a gray PNG (shape %s)"
                      % (path, label.shape))
    if size_hw is not None:
        label = resize_nearest(label, size_hw)
    if coco_map is not None:
        label = coco_map[label]
    return label


def write_synthetic_clip(path: str, *, seconds: int = 4, fps: int = 10,
                         size_hw: Tuple[int, int] = (128, 256),
                         seed: int = 0,
                         gt_dir: Optional[str] = None,
                         num_classes: int = 19,
                         label_values: Optional[Sequence[int]] = None,
                         style: str = "sines",
                         ) -> Tuple[str, Optional[str]]:
    """Write a deterministic moving-pattern clip as a frame directory at
    ``path`` (+ optional gt PNGs in ``gt_dir``).

    The frames are the JAX package's ``write_synthetic_clip`` frames, pixel
    for pixel; its mp4 stores them lossily, the frame directory exactly.

    ``style="sines"``: horizontally drifting interference bands; labels
    quantize a drifting vertical coordinate into ``num_classes`` strata
    (not learnable from local appearance).  ``style="bands"``: drifting
    horizontal strata, each class one distinct colour, so a short
    distillation round learns it.
    """
    h, w = size_hw
    os.makedirs(path, exist_ok=True)
    if gt_dir is not None:
        os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    phase = rng.rand() * 6.28
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = seconds * fps
    n_vals = len(label_values) if label_values else num_classes
    palette = np.stack([
        np.asarray([37 * (i + 3) % 256 for i in range(n_vals)]),
        np.asarray([61 * (i + 5) % 256 for i in range(n_vals)]),
        np.asarray([89 * (i + 7) % 256 for i in range(n_vals)]),
    ], axis=-1).astype(np.float32)
    for t in range(n):
        shift = t * 3.0
        strata = ((yy + shift) / h * n_vals).astype(np.int64) % n_vals
        if style == "bands":
            base = palette[strata]
            tex = 12 * np.sin((xx + 2 * t) / 9.0)
            frame = np.clip(base + tex[..., None]
                            + rng.normal(0, 4, base.shape), 0,
                            255).astype(np.uint8)[..., ::-1]  # RGB->BGR
        else:
            r = 127 + 120 * np.sin((xx + shift) / 23.0 + phase)
            g = 127 + 120 * np.sin((yy + 0.5 * shift) / 17.0)
            b = 127 + 120 * np.sin((xx + yy + shift) / 31.0)
            frame = np.stack([b, g, r], axis=-1).astype(np.uint8)
        png_write(frame_path(path, t), frame)
        if gt_dir is not None:
            if label_values:
                label = np.asarray(label_values, np.uint8)[strata]
            else:
                label = strata.astype(np.uint8)
            png_write(os.path.join(gt_dir, "gt_%06d.png" % t), label)
    write_clip_meta(path, fps, n)
    return path, gt_dir
