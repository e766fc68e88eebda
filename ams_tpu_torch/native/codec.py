"""ctypes bindings for the native delta codec (``codec.cpp``).

Counterpart of ``ams_tpu/native/codec.py``, with its ``gzip9`` and
``encode_delta_native``.  The library is built (``native.build``) and
loaded at the first call, not at import; ``stream.codec.encode_delta``
falls back to its Python path, with one warning per process, when that
fails.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from ams_tpu_torch.native.build import build

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _bind(lib):
    lib.ams_gzip9.restype = ctypes.c_long
    lib.ams_gzip9.argtypes = [ctypes.c_char_p, ctypes.c_long,
                              ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.ams_encode_delta2.restype = ctypes.c_long
    lib.ams_encode_delta2.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
    ]
    lib.ams_png_unfilter.restype = ctypes.c_long
    lib.ams_png_unfilter.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    return lib


def library() -> ctypes.CDLL:
    """The native library (the codec and ``native.png``'s unfilter),
    built and loaded on first use in this process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()["path"]))
        return _LIB


def gzip9(data: bytes) -> bytes:
    """zlib's gzip container at level 9 (the header names the OS)."""
    cap = len(data) + (len(data) >> 9) + 128
    out = (ctypes.c_uint8 * cap)()
    n = library().ams_gzip9(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError("native gzip failed")
    return ctypes.string_at(out, n)


def encode_delta_native(masks: Sequence[np.ndarray],
                        values: Sequence[np.ndarray],
                        tail: bytes = b"") -> bytes:
    """Single-pass pack+fp16+gzip of an ordered delta payload.

    ``tail`` is appended raw inside the same gzip stream after the values
    section (the BN stats annex).  Wire parity rule: values reach fp16 in
    ONE rounding step — a non-f32 input (f64 checkpoints) is cast source
    dtype -> f16 here, then widened losslessly to f32 for the C ABI (the
    C++ f32->f16 then reproduces the same half exactly); routing f64
    through f32 first would double-round and change wire bytes vs the
    reference's direct astype(np.float16).
    """
    def _as_f32_single_rounded(v):
        v = np.asarray(v)
        if v.dtype == np.float32:
            return v.reshape(-1)
        return v.astype(np.float16).reshape(-1).astype(np.float32)

    if len(masks) != len(values):
        raise ValueError("%d masks for %d values" % (len(masks), len(values)))
    for m, v in zip(masks, values):
        if np.shape(m) != np.shape(v):
            raise ValueError("mask shape %s != value shape %s"
                             % (np.shape(m), np.shape(v)))
    lib = library()
    mask_cat = np.ascontiguousarray(
        np.concatenate([np.asarray(m, bool).reshape(-1).view(np.uint8)
                        for m in masks]))
    val_cat = np.ascontiguousarray(
        np.concatenate([_as_f32_single_rounded(v) for v in values]))
    sizes = np.array([np.asarray(m).size for m in masks], np.int64)
    total_raw = int(sum((s + 7) // 8 for s in sizes)) + \
        int(mask_cat.sum()) * 2 + len(tail)
    cap = total_raw + (total_raw >> 9) + 128
    out = (ctypes.c_uint8 * cap)()
    n = lib.ams_encode_delta2(
        mask_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        val_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(sizes), tail, len(tail), out, cap)
    if n < 0:
        raise RuntimeError("native delta encode failed")
    return ctypes.string_at(out, n)
