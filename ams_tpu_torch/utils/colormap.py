"""Label colormaps for visualization (reference utils/utils.py:52-77)."""

from __future__ import annotations

import numpy as np

_CITYSCAPES = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)


def colormap(name: str = "cityscapes") -> np.ndarray:
    """Return a (256, 3) uint8 colormap; ids beyond the palette map to black."""
    if name != "cityscapes":
        raise ValueError("Unknown colormap %r" % name)
    cmap = np.zeros((256, 3), dtype=np.uint8)
    cmap[: len(_CITYSCAPES)] = _CITYSCAPES
    return cmap
