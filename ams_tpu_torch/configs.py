"""Per-video experiment registry.

The reference keeps this as if/elif chains keyed by the integer prefix of the
video filename (reference ``exp_configs.py``). We keep the same public
callables (``num_classes``, ``class_weights``, ``test_length``, ``is_coco``,
``coco_class_converter``) but store the registry as data.

Cityscapes class order (19): road, sidewalk, building, wall, fence, pole,
traffic light, traffic sign, vegetation, terrain, sky, person, rider, car,
truck, bus, train, motorcycle, bicycle.

PASCAL-VOC order (21): background, aeroplane, bicycle, bird, boat, bottle,
bus, car, cat, chair, cow, dining table, dog, horse, motorbike, person,
potted plant, sheep, sofa, train, tv/monitor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CITYSCAPES_LABELS = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]

VOC_LABELS = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "dining table", "dog", "horse", "motorbike",
    "person", "potted plant", "sheep", "sofa", "train", "tv/monitor",
]


def class_labels(exp_num: int):
    """Class-name list matching the experiment's label space (19 =
    Cityscapes, 21 = VOC — the LVS/COCO entries)."""
    return list(VOC_LABELS) if num_classes(exp_num) == 21 \
        else list(CITYSCAPES_LABELS)


def _w19(indices):
    w = np.zeros(19, dtype=np.float32)
    w[list(indices)] = 1.0
    return w


def _w21(indices):
    w = np.zeros(21, dtype=np.float32)
    w[list(indices)] = 1.0
    return w


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """One video's experiment configuration (reference exp_configs.py)."""

    exp_num: int
    n_classes: int
    weights: np.ndarray  # (n_classes,) float32 of {0,1}
    length_s: int        # test length in seconds
    coco: bool = False   # labels produced by a COCO-trained Mask R-CNN teacher
    dataset: str = ""


# Registry entries transcribed from reference exp_configs.py:18-322 (data, not
# code).  Key = integer prefix of the video filename ("NUM-name.mp4").
_REGISTRY: dict[int, VideoConfig] = {}


def _add(exp_num, n, idx, length, coco=False, dataset=""):
    _REGISTRY[exp_num] = VideoConfig(
        exp_num, n, _w19(idx) if n == 19 else _w21(idx), length, coco, dataset)


# Full-Cityscapes (used for teacher label extraction, exp_configs.py:39-42).
_add(0, 19, range(19), 0, dataset="cityscapes")
# Outdoor Scenes (exp_configs.py:44-71, lengths :203-223).
_add(12, 19, [0, 1, 2, 8, 10, 11, 13], 900, dataset="outdoor-scenes")
_add(13, 19, [2, 8, 9, 10, 11, 13], 420, dataset="outdoor-scenes")
_add(14, 19, [0, 1, 2, 8, 10, 11], 810, dataset="outdoor-scenes")
_add(15, 19, [0, 2, 8, 10, 11, 13], 900, dataset="outdoor-scenes")
_add(17, 19, [0, 2, 8, 10, 11, 13], 900, dataset="outdoor-scenes")
_add(19, 19, [1, 2, 8, 10, 11], 900, dataset="outdoor-scenes")
_add(21, 19, [0, 8, 9, 10, 11], 800, dataset="outdoor-scenes")
# A2D2 (exp_configs.py:73-84, lengths :224-232).
_add(22, 19, [0, 1, 2, 10, 11, 13], 520, dataset="a2d2")
_add(23, 19, [0, 1, 2, 10, 11, 13], 900, dataset="a2d2")
_add(24, 19, [0, 1, 2, 10, 11, 13], 740, dataset="a2d2")
# Cityscapes-Frankfurt (exp_configs.py:86-89, length :233-235).
_add(25, 19, [0, 1, 2, 10, 11, 13], 2790, dataset="cityscapes")
# LVS videos, COCO-labelled, VOC class space (exp_configs.py:113-196,
# lengths :236-319).
for e in (26, 27, 29, 30, 31, 33, 34, 35, 37, 42, 44, 45):
    _add(e, 21, [0, 15], 1000 if e not in (32, 43, 45) else 500,
         coco=True, dataset="lvs")
_add(28, 21, [0, 15], 1200, coco=True, dataset="lvs")
_add(32, 21, [0, 15], 500, coco=True, dataset="lvs")
_add(36, 21, [0, 15], 1190, coco=True, dataset="lvs")
_add(39, 21, [0, 3], 600, coco=True, dataset="lvs")
_add(40, 21, [0, 7, 12, 15], 1000, coco=True, dataset="lvs")
_add(41, 21, [0, 13, 15], 1250, coco=True, dataset="lvs")
_add(43, 21, [0, 7, 15], 500, coco=True, dataset="lvs")
_add(46, 21, [0, 2, 15], 500, coco=True, dataset="lvs")
_add(47, 21, [0, 7, 15], 1780, coco=True, dataset="lvs")
_add(48, 21, [0, 7, 15], 1200, coco=True, dataset="lvs")
_add(49, 21, [0, 7, 15], 1000, coco=True, dataset="lvs")
_add(50, 21, [0, 2, 7, 15], 1000, coco=True, dataset="lvs")
_add(51, 21, [0, 2, 7, 15], 1000, coco=True, dataset="lvs")
_add(52, 21, [0, 7, 15], 1000, coco=True, dataset="lvs")
_add(53, 21, [0, 2, 7, 15], 1000, coco=True, dataset="lvs")
_add(54, 21, [0, 2, 7, 15], 1000, coco=True, dataset="lvs")

_add(45, 21, [0, 15], 500, coco=True, dataset="lvs")  # 59.94fps clip

# Synthetic clips for tests/benches (not in the reference registry; ids >= 90
# are reserved for ams_tpu.data.video.write_synthetic_clip outputs).
_add(90, 19, [0, 1, 2, 8, 10], 8, dataset="synthetic")
_add(91, 19, range(19), 8, dataset="synthetic")
_add(92, 21, [0, 7, 15], 8, coco=True, dataset="synthetic")  # LVS-style
_add(93, 19, [0, 1, 2, 8, 10], 130, dataset="synthetic")  # reference-cadence
# soak: long enough for simple mode's first-train-at-100s schedule


def get_config(exp_num: int) -> VideoConfig:
    try:
        return _REGISTRY[exp_num]
    except KeyError:
        raise ValueError("Experiment %d not configured" % exp_num) from None


def num_classes(exp_num: int) -> int:
    return get_config(exp_num).n_classes


def class_weights(exp_num: int) -> np.ndarray:
    """(n_classes, 1) float32 column of {0,1} — reference exp_configs.py:199."""
    cfg = get_config(exp_num)
    return cfg.weights.reshape(cfg.n_classes, 1)


def class_indices(exp_num: int) -> np.ndarray:
    """Indices of the selected classes (ascending)."""
    return np.where(get_config(exp_num).weights == 1)[0]


def test_length(exp_num: int) -> int:
    return get_config(exp_num).length_s


def is_coco(exp_num: int) -> bool:
    return get_config(exp_num).coco


def coco_class_converter() -> np.ndarray:
    """COCO(80+bg) id -> VOC(21) id lookup table (exp_configs.py:325-334)."""
    lut = np.zeros(81, dtype=np.int32)
    lut[1] = 15   # person
    lut[2] = 2    # bicycle
    lut[3] = 7    # car
    lut[15] = 3   # bird
    lut[17] = 12  # dog (COCO 'cat'=16 unmapped per reference table)
    lut[18] = 13  # horse
    return lut


def video_exp_num(path: str) -> int:
    """Parse the experiment number from a 'NUM-name.mp4' path (run.py:591)."""
    return int(path.split("/")[-1].split("-")[0])
