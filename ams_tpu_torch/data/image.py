"""PNG IO and cv2-exact resizes on numpy and zlib alone.

The JAX package calls OpenCV inline for these; the card machine has no
OpenCV, so the port carries its own, held to cv2's output by the tests:

- ``png_encode`` writes the bytes ``cv2.imencode(".png", img)`` writes
  (libpng under cv2's defaults: the Sub filter on every row, zlib level 1
  with the RLE strategy, IDAT chunks of 8,192 bytes, libpng's window and
  header trimming for images under 16 KiB);
- ``png_decode`` reads 8-bit gray, RGB and RGBA PNGs with any of the five
  row filters and returns colour as BGR(A), as ``cv2.imread`` does; the
  rows are unfiltered by the native library (``native/png.cpp``), or by
  the plain ``_unfilter`` with one warning if that cannot be built;
- ``resize_linear_u8`` is cv2's uint8 ``INTER_LINEAR``: 11-bit fixed-point
  coefficients from float32 source coordinates, an int horizontal sum and
  the SIMD path's vertical rounding, and, at exactly 2x down in both axes,
  cv2's switch to ``INTER_AREA`` (the 2x2 mean, rounded half up);
- ``resize_nearest`` is cv2's ``INTER_NEAREST``;
- ``add_weighted_u8`` is cv2's uint8 ``addWeighted``: the vector path's
  float32 fused multiply-adds, then ``saturate_cast`` (round half to even).

Sizes are ``(height, width)`` throughout, unlike cv2's ``(width, height)``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IDAT_BYTES = 8192                 # libpng's PNG_ZBUF_SIZE
_COEF_BITS = 11                    # cv2's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
# PNG colour type -> channels (8-bit gray, RGB and RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """Swap the first and third channels (either direction), as
    ``cv2.cvtColor`` does for three channels."""
    return np.ascontiguousarray(img[..., ::-1])


rgb_to_bgr = bgr_to_rgb


def add_weighted_u8(a: np.ndarray, alpha: float, b: np.ndarray,
                    beta: float, gamma: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` of two uint8 images of
    one shape: ``fma(a, alpha, fma(b, beta, gamma))`` in float32 (each
    product of a uint8 and a float32 is exact in float64, so one rounding
    to float32 per step gives the fused result), then cv2's
    ``saturate_cast<uchar>``: round half to even, clamp to [0, 255]."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != np.uint8 or b.dtype != np.uint8 or a.shape != b.shape:
        raise ValueError("add_weighted_u8 takes two uint8 images of one "
                         "shape, got %s %s and %s %s"
                         % (a.dtype, a.shape, b.dtype, b.shape))
    f32 = np.float32
    t = (b * np.float64(f32(beta)) + np.float64(f32(gamma))).astype(f32)
    x = (a * np.float64(f32(alpha)) + t).astype(f32)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ encode

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _trim_window(data_size: int) -> int:
    """libpng's ``png_deflate_claim``: the deflate window for a stream of
    ``data_size`` bytes (windowBits 15, cut while the data fits half)."""
    bits = 15
    if data_size <= 16384:
        half = 1 << (bits - 1)
        while data_size + 262 <= half:
            half >>= 1
            bits -= 1
    return max(bits, 9)             # zlib takes 8 as 9


def _optimize_cmf(stream: bytearray, data_size: int) -> None:
    """libpng's ``optimize_cmf``: the zlib header names the smallest window
    that covers the data."""
    if data_size > 16384:
        return
    cmf = stream[0]
    if (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if data_size > half:
        return
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and data_size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    stream[0] = cmf
    tmp = stream[1] & 0xE0
    tmp += 0x1F - ((cmf << 8) + tmp) % 0x1F
    stream[1] = tmp


def png_encode(img: np.ndarray) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA -> PNG bytes, the
    bytes ``cv2.imencode(".png", img)`` gives."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("png_encode takes uint8 images, got %s" % img.dtype)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color, rows = 0, img
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color = 2 if img.shape[2] == 3 else 6
        swap = [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]
        rows = img[..., swap]
    else:
        raise ValueError("png_encode: image of shape %s" % (img.shape,))
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("png_encode: empty image %s" % (img.shape,))
    bpp = 1 if rows.ndim == 2 else rows.shape[2]
    raw = np.ascontiguousarray(rows).reshape(h, w * bpp)
    # the Sub filter on every row: each byte minus the byte bpp before it
    filt = np.empty((h, w * bpp + 1), np.uint8)
    filt[:, 0] = 1
    filt[:, 1:bpp + 1] = raw[:, :bpp]
    np.subtract(raw[:, bpp:], raw[:, :-bpp], out=filt[:, bpp + 1:])
    data_size = filt.size
    comp = zlib.compressobj(1, zlib.DEFLATED, _trim_window(data_size), 8,
                            zlib.Z_RLE)
    stream = bytearray(comp.compress(filt.tobytes()) + comp.flush())
    _optimize_cmf(stream, data_size)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    idats = b"".join(_chunk(b"IDAT", bytes(stream[i:i + _IDAT_BYTES]))
                     for i in range(0, len(stream), _IDAT_BYTES))
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + idats
            + _chunk(b"IEND", b""))


def png_write(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a PNG path."""
    with open(path, "wb") as f:
        f.write(png_encode(img))


# ------------------------------------------------------------------ decode

_warned_native_fallback = False


def _native_unfilter(data: np.ndarray, h: int, stride: int, bpp: int):
    """``native.png.unfilter``, or None (with one warning per process)
    when the native library cannot be built or loaded."""
    global _warned_native_fallback
    try:
        from ams_tpu_torch.native import png as native_png
        native_png.library()
    except Exception as e:  # noqa: BLE001 - any build or load failure
        if not _warned_native_fallback:
            _warned_native_fallback = True
            import warnings
            warnings.warn("native PNG unfilter unavailable (%s: %s); "
                          "falling back to the Python path, which runs "
                          "Average and Paeth rows byte by byte"
                          % (type(e).__name__, e), RuntimeWarning)
        return None
    return native_png.unfilter(data, h, stride, bpp)


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of a decompressed, non-interlaced image:
    runs of None, Sub and Up rows at once, Average and Paeth row by row.
    The plain version of the native unfilter."""
    data = data.reshape(h, stride + 1)
    kinds = data[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError("PNG row filter %d" % int(kinds.max()))
    filt = data[:, 1:]
    out = np.empty((h, stride), np.uint8)
    r = 0
    while r < h:
        kind = int(kinds[r])
        end = r + 1
        while end < h and kinds[end] == kind and kind in (0, 1, 2):
            end += 1
        if kind == 0:
            out[r:end] = filt[r:end]
        elif kind == 1:
            # each byte adds the reconstructed byte bpp to its left: a
            # cumulative sum over each channel's bytes, mod 256
            grid = filt[r:end].reshape(end - r, stride // bpp, bpp)
            out[r:end] = np.cumsum(grid, axis=1, dtype=np.uint8).reshape(
                end - r, stride)
        elif kind == 2:
            prev = out[r - 1] if r else np.zeros(stride, np.uint8)
            out[r:end] = np.cumsum(filt[r:end], axis=0, dtype=np.uint8) + prev
        else:
            prev = (out[r - 1] if r else np.zeros(stride, np.uint8)
                    ).astype(np.int32)
            cur = filt[r].astype(np.int32)
            row = np.zeros(stride, np.int32)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[x] = (cur[x] + pred) & 0xFF
            out[r] = row.astype(np.uint8)
        r = end
    return out


def png_decode(blob: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, as
    ``cv2.imdecode(..., IMREAD_UNCHANGED)`` gives them (8-bit, not
    interlaced, colour types 0, 2 and 6)."""
    blob = bytes(blob)
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG stream")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk %r" % kind)
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _comp, _filter, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError("unsupported PNG: depth %d, colour type %d, "
                         "interlace %d" % (depth, color, interlace))
    bpp = _CHANNELS[color]
    stride = w * bpp
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data too short")
    img = _native_unfilter(data[:h * (stride + 1)], h, stride, bpp)
    if img is None:
        img = _unfilter(data[:h * (stride + 1)], h, stride, bpp)
    if bpp == 1:
        return img.reshape(h, w)
    img = img.reshape(h, w, bpp)
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:bpp]])


def png_read(path: str) -> np.ndarray:
    """``png_decode`` of a file (``cv2.imread(path, IMREAD_UNCHANGED)``)."""
    with open(path, "rb") as f:
        return png_decode(f.read())


# ------------------------------------------------------------------ resize

def _as_hwc(img: np.ndarray):
    img = np.asarray(img)
    if img.ndim == 2:
        return img[..., None], True
    if img.ndim == 3:
        return img, False
    raise ValueError("resize: image of shape %s" % (img.shape,))


def _linear_taps(src: int, dst: int):
    """cv2's per-axis source index and 11-bit coefficient pair."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _coefs(f: np.ndarray):
    c0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    return c0.astype(np.int64), c1.astype(np.int64)


def resize_linear_u8(img: np.ndarray, size_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of a uint8 image."""
    src, flat = _as_hwc(img)
    if src.dtype != np.uint8:
        raise ValueError("resize_linear_u8 takes uint8, got %s" % src.dtype)
    sh, sw = src.shape[:2]
    oh, ow = int(size_hw[0]), int(size_hw[1])
    if (oh, ow) == (sh, sw):
        out = src.copy()
    elif sh == 2 * oh and sw == 2 * ow:
        # cv2 resizes exactly 2x down by INTER_AREA
        s = src.astype(np.uint16)
        out = ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                + s[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    else:
        sx, fx = _linear_taps(sw, ow)
        # x clamps: left of the first pixel and from the last one on, the
        # first/last pixel with weight 1
        lo = sx < 0
        fx[lo], sx[lo] = 0, 0
        hi = sx >= sw - 1
        fx[hi], sx[hi] = 0, sw - 1
        ax0, ax1 = _coefs(fx)
        sy, fy = _linear_taps(sh, oh)
        by0, by1 = _coefs(fy)
        r0 = np.clip(sy, 0, sh - 1)
        r1 = np.clip(sy + 1, 0, sh - 1)
        x1 = np.minimum(sx + 1, sw - 1)

        def horizontal(rows):
            part = src[rows].astype(np.int64)
            return (part[:, sx] * ax0[None, :, None]
                    + part[:, x1] * ax1[None, :, None])

        h0 = horizontal(r0) >> 4
        h1 = horizontal(r1) >> 4
        v = (((h0 * by0[:, None, None]) >> 16)
             + ((h1 * by1[:, None, None]) >> 16) + 2) >> 2
        out = np.clip(v, 0, 255).astype(np.uint8)
    return out[..., 0] if flat else out


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``."""
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    oh, ow = int(size_hw[0]), int(size_hw[1])
    ify = 1.0 / (oh / sh)
    ifx = 1.0 / (ow / sw)
    ys = np.minimum(np.floor(np.arange(oh) * ify).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(ow) * ifx).astype(np.int64), sw - 1)
    return np.ascontiguousarray(img[ys][:, xs])
