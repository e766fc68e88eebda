"""Zstandard through the system's ``libzstd.so.1``, bound with ``ctypes``.

Orbax checkpoints compress every OCDBT node and every zarr chunk with
zstd (``utils.ocdbt``, ``utils.zarr2``).  The binding needs no header and
no Python package: it loads the shared library at the first call.  Where
the library cannot be found, every call raises ``RuntimeError`` naming
``libzstd.so.1``; there is no pure-Python substitute.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

LIBRARY = "libzstd.so.1"

# ZSTD_getFrameContentSize's two sentinels (zstd.h)
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _find_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None: the soname first (the dynamic loader's
    own search), then whatever ``ctypes.util.find_library`` names."""
    for name in (LIBRARY, ctypes.util.find_library("zstd")):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    size_t, vp, cvp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p
    sigs = {
        "ZSTD_versionString": (ctypes.c_char_p, []),
        "ZSTD_isError": (ctypes.c_uint, [size_t]),
        "ZSTD_getErrorName": (ctypes.c_char_p, [size_t]),
        "ZSTD_compressBound": (size_t, [size_t]),
        "ZSTD_compress": (size_t, [vp, size_t, cvp, size_t, ctypes.c_int]),
        "ZSTD_getFrameContentSize": (ctypes.c_ulonglong, [cvp, size_t]),
        "ZSTD_decompress": (size_t, [vp, size_t, cvp, size_t]),
        "ZSTD_createDStream": (vp, []),
        "ZSTD_freeDStream": (size_t, [vp]),
        "ZSTD_initDStream": (size_t, [vp]),
        "ZSTD_DStreamOutSize": (size_t, []),
        "ZSTD_decompressStream": (size_t, [vp, ctypes.POINTER(_OutBuffer),
                                           ctypes.POINTER(_InBuffer)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def library() -> ctypes.CDLL:
    """The bound library, loaded once; ``RuntimeError`` without it."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = _find_library()
            if lib is None:
                raise RuntimeError(
                    "zstd: cannot load %s (the Zstandard library), which "
                    "reading and writing Orbax checkpoints needs; install "
                    "the system's libzstd1 package" % LIBRARY)
            _LIB = _declare(lib)
        return _LIB


def version() -> str:
    """The library's version string, e.g. ``"1.5.4"``."""
    return library().ZSTD_versionString().decode()


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        name = lib.ZSTD_getErrorName(code).decode()
        raise ValueError("zstd %s: %s" % (what, name))
    return code


def compress(buf, level: int = 1) -> bytes:
    """One zstd frame holding ``buf``, at ``level``."""
    lib = library()
    src = bytes(buf)
    cap = lib.ZSTD_compressBound(len(src))
    dst = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(dst, cap, src, len(src), int(level)),
               "compress")
    return dst.raw[:n]


def decompress(buf, size: Optional[int] = None) -> bytes:
    """The bytes that the zstd frame(s) in ``buf`` hold.  ``size`` is the
    decoded size when the caller knows it; otherwise the frame header's
    content size is used, and a frame that does not state it is decoded
    through the streaming API.  A corrupt frame raises ``ValueError``."""
    lib = library()
    src = bytes(buf)
    if size is None:
        fcs = lib.ZSTD_getFrameContentSize(src, len(src))
        if fcs == _CONTENTSIZE_ERROR:
            raise ValueError("zstd decompress: not a zstd frame")
        if fcs != _CONTENTSIZE_UNKNOWN:
            size = int(fcs)
    if size is None:
        return _decompress_stream(lib, src)
    dst = ctypes.create_string_buffer(max(int(size), 1))
    n = _check(lib, lib.ZSTD_decompress(dst, int(size), src, len(src)),
               "decompress")
    return dst.raw[:n]


def _decompress_stream(lib: ctypes.CDLL, src: bytes) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "decompress")
        chunk = lib.ZSTD_DStreamOutSize()
        out = ctypes.create_string_buffer(chunk)
        src_buf = ctypes.create_string_buffer(src, len(src))
        inb = _InBuffer(ctypes.cast(src_buf, ctypes.c_void_p), len(src), 0)
        parts = []
        last = 0
        while True:
            outb = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), chunk, 0)
            last = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            parts.append(out.raw[:outb.pos])
            if inb.pos == inb.size and outb.pos < chunk:
                break
        if last != 0:
            raise ValueError("zstd decompress: truncated frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(ds)
