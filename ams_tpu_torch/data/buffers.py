"""Frame/label memory and minibatch sampling.

Counterpart of ``ams_tpu/data/buffers.py``, with its cv2 resizes on
``data/image.py``.  ``FrameMemory`` is the server's bounded sample memory
(the reference keeps two deques sized memory_len/sampling_period*fps,
run.py:135-138).  ``choose_frames`` and ``mini_batch`` replicate the
reference samplers (utils/utils.py:237-254, 129-185); the AMS loop calls
``mini_batch`` degenerately (scale=[1], flip=False), which is what the
round's own sampler implements.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Sequence, Tuple

import numpy as np

from ams_tpu_torch.data.image import resize_linear_u8, resize_nearest


def choose_frames(frame_label_list: Sequence[Tuple[np.ndarray, np.ndarray]],
                  sample_fraction: float):
    """Equally spaced sampling of (frame, label) pairs from a bucket:
    round(fraction * len) samples at linspace(-1, len-1)[1:] rounded
    indices (utils/utils.py:237-254)."""
    n = len(frame_label_list)
    samples = int(np.round(sample_fraction * n))
    indices = np.linspace(-1, n - 1, samples + 1, endpoint=True)[1:]
    indices = np.round(indices).astype(int)
    if indices.size != samples:
        raise RuntimeError("choose_frames drew %d of %d" % (indices.size,
                                                            samples))
    frames = [frame_label_list[i][0] for i in indices]
    labels = [frame_label_list[i][1] for i in indices]
    return frames, labels


def mini_batch(deque_images, deque_labels, crop_size, scale, mini_batch_size,
               num_of_iterations, flip=False, rng=None):
    """Random pick + random scale + random crop sampler (host side).

    Faithful to utils/utils.py:129-185, including the per-scale resize
    cache and the reference's split RNG sources (np.random for pick/flip,
    stdlib random for scale/crop).  Passing ``rng`` (a ``random.Random``)
    routes every draw through it."""
    seeded = rng is not None
    rng = rng or random

    def pick(n):
        return rng.randrange(n) if seeded else np.random.choice(n)

    def coin():
        return rng.random() if seeded else np.random.random()
    imgs = list(deque_images)
    lbls = list(deque_labels)
    cache_i = {s: {} for s in scale}
    cache_l = {s: {} for s in scale}
    out_i = np.empty((num_of_iterations, mini_batch_size, crop_size[0],
                      crop_size[1], imgs[0].shape[2]))
    out_l = np.empty((num_of_iterations, mini_batch_size, crop_size[0],
                      crop_size[1]))
    total = len(imgs)
    for i in range(num_of_iterations):
        for j in range(mini_batch_size):
            pic = pick(total)
            hh, ww = imgs[pic].shape[:2]
            s = scale[rng.randint(0, len(scale) - 1)]
            actual = s * crop_size[1] / ww
            max_h = int(hh * actual) - crop_size[0]
            max_w = int(ww * actual) - crop_size[1]
            if max_h < 0 or max_w < 0:
                raise ValueError("scale %r crops past the frame" % (s,))
            y = rng.randint(0, max_h)
            x = rng.randint(0, max_w)
            if pic not in cache_i[s]:
                if actual == 1 and s == 1:
                    cache_i[s][pic] = imgs[pic]
                    cache_l[s][pic] = lbls[pic]
                else:
                    size_hw = (int(hh * actual), int(ww * actual))
                    cache_i[s][pic] = resize_linear_u8(imgs[pic], size_hw)
                    cache_l[s][pic] = resize_nearest(lbls[pic], size_hw)
            im = cache_i[s][pic][y:y + crop_size[0], x:x + crop_size[1]]
            lb = cache_l[s][pic][y:y + crop_size[0], x:x + crop_size[1]]
            if flip and coin() > 0.5:
                im = np.flip(im, axis=1)
                lb = np.flip(lb, axis=1)
            out_i[i][j] = im
            out_l[i][j] = lb
    return out_i, out_l


class FrameMemory:
    """Bounded frame+label memory (capacity = memory_len / sampling_period
    * fps entries, run.py:136-137)."""

    def __init__(self, capacity: int, height: int, width: int):
        self.capacity = int(capacity)
        self.height = height
        self.width = width
        self.frames: deque = deque(maxlen=self.capacity)
        self.labels: deque = deque(maxlen=self.capacity)

    def __len__(self):
        return len(self.frames)

    def extend(self, frames: Sequence[np.ndarray],
               labels: Sequence[np.ndarray]) -> None:
        if len(frames) != len(labels):
            raise ValueError("frame/label count mismatch: %d vs %d"
                             % (len(frames), len(labels)))
        for f, l in zip(frames, labels):
            f = np.asarray(f)
            l = np.asarray(l)
            if f.shape != (self.height, self.width, 3):
                raise ValueError("frame shape %s != (%d, %d, 3)"
                                 % (f.shape, self.height, self.width))
            if l.shape != (self.height, self.width):
                raise ValueError("label shape %s != (%d, %d)"
                                 % (l.shape, self.height, self.width))
            self.frames.append(np.ascontiguousarray(f, dtype=np.uint8))
            self.labels.append(np.ascontiguousarray(l, dtype=np.uint8))

    def clear(self) -> None:
        self.frames.clear()
        self.labels.clear()

    def stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live rows, unpadded (resume bundles)."""
        if not self.frames:
            shape_f = (0, self.height, self.width, 3)
            return np.zeros(shape_f, np.uint8), np.zeros(shape_f[:3], np.uint8)
        return np.stack(list(self.frames)), np.stack(list(self.labels))
