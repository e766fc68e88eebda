"""ctypes binding of the native PNG row unfilter (``png.cpp``).

``data.image.png_decode`` unfilters through ``unfilter`` and falls back to
its numpy ``_unfilter`` (which runs Average and Paeth rows byte by byte in
Python), with one warning per process, when the native library cannot be
built or loaded: the policy of the native delta codec.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ams_tpu_torch.native.codec import library


def unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) uint8 image of ``h`` filtered rows of ``stride``
    bytes, each after its filter byte; ``ValueError`` for a filter byte
    above 4.  ``unfilter.calls`` counts the calls that reached the
    library."""
    lib = library()
    src = np.ascontiguousarray(data, dtype=np.uint8)
    if src.size < h * (stride + 1):
        raise ValueError("PNG image data too short")
    out = np.empty((h, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.ams_png_unfilter(src.ctypes.data_as(u8), h, stride, bpp,
                              out.ctypes.data_as(u8))
    unfilter.calls += 1
    if rc < 0:
        row = -1 - rc
        raise ValueError("PNG row filter %d" % int(src[row * (stride + 1)]))
    return out


unfilter.calls = 0
