"""The port's data layer without OpenCV, held against OpenCV and ams_tpu.

``ams_tpu_torch/data/image.py`` must give OpenCV's results exactly, since
the uplink's accounted bits are PNG sizes and the server's memory holds
resized frames:
- ``png_encode`` is byte-equal to ``cv2.imencode(".png", ·)`` on colour,
  gray, BGRA, odd-width, tiny (libpng's trimmed window) and all-zero
  images;
- ``png_decode`` equals ``cv2.imread``/``imdecode`` on cv2-written files
  and on hand-built PNGs of each row filter (0-4, and all five mixed);
- ``resize_linear_u8`` equals ``cv2.resize`` (``INTER_LINEAR``) at every
  shape tried, down and up, including exactly 2x down (where cv2 switches
  to ``INTER_AREA``) and 4x down; ``resize_nearest`` equals
  ``INTER_NEAREST``.
The frame-directory readers give ams_tpu's readers' frames on a
cv2-decoded synthetic mp4, seeks included; ``write_synthetic_clip`` gives
the frames ams_tpu's hands its mp4 writer, and the same label PNG bytes.
"""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from ams_tpu.data import video as jax_video

from ams_tpu_torch.data import image as im
from ams_tpu_torch.data import video as tv

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from torch_frames_from_video import frames_from_video  # noqa: E402


def _smooth(h, w, c=3):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [127 + 120 * np.sin(xx / 23), 127 + 120 * np.sin(yy / 17),
             127 + 120 * np.sin((xx + yy) / 31), 200 + 50 * np.sin(xx / 5)]
    return np.stack(chans[:c], -1).astype(np.uint8)


def _image(kind):
    rs = np.random.RandomState(len(kind))
    yy = np.mgrid[0:256, 0:512][0]
    return {
        "smooth_rgb": _smooth(256, 512),
        "random_rgb": rs.randint(0, 256, (256, 512, 3)).astype(np.uint8),
        "label_strata": (yy // 13 % 19).astype(np.uint8),
        "random_labels": rs.randint(0, 19, (256, 512)).astype(np.uint8),
        "all_zero": np.zeros((256, 512, 3), np.uint8),
        "odd_width_rgb": rs.randint(0, 256, (37, 101, 3)).astype(np.uint8),
        "odd_width_gray": rs.randint(0, 256, (9, 33)).astype(np.uint8),
        "tiny_rgb": rs.randint(0, 256, (5, 7, 3)).astype(np.uint8),
        "bgra": np.concatenate([_smooth(33, 65), rs.randint(
            0, 256, (33, 65, 1)).astype(np.uint8)], -1),
        "few_levels": rs.randint(0, 4, (64, 128, 3)).astype(np.uint8),
        "wide_frame": _smooth(200, 2048),
    }[kind]


KINDS = ["smooth_rgb", "random_rgb", "label_strata", "random_labels",
         "all_zero", "odd_width_rgb", "odd_width_gray", "tiny_rgb", "bgra",
         "few_levels", "wide_frame"]


@pytest.mark.parametrize("kind", KINDS)
def test_png_encode_bytes_equal_cv2(kind):
    img = _image(kind)
    ok, ref = cv2.imencode(".png", img)
    assert ok
    assert im.png_encode(img) == ref.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_png_read_equals_cv2_imread(kind, tmp_path):
    img = _image(kind)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img)
    got = im.png_read(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if img.ndim == 3 and img.shape[2] == 3:
        assert np.array_equal(got, cv2.imread(path))       # IMREAD_COLOR
    im.png_write(path, img)
    assert np.array_equal(im.png_read(path), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prev, bpp):
    """The PNG specification's filters, byte by byte (the reference the
    vectorised decoder is held to)."""
    out = []
    for x, v in enumerate(row):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((v - pred) % 256)
    return bytes([kind] + out)


def _hand_png(img, kinds):
    """A PNG of ``img`` (gray, RGB or RGBA, stored as given) whose row r
    uses filter kinds[r % len(kinds)]."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(int).tolist()
    prev = [0] * (w * bpp)
    raw = b""
    for r, row in enumerate(rows):
        raw += _filter_row(kinds[r % len(kinds)], row, prev, bpp)
        prev = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (im.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                   [2, 2, 1, 1, 4, 3, 0, 0]])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_every_filter(kinds, channels):
    rs = np.random.RandomState(channels)
    shape = (11, 13) if channels == 1 else (11, 13, channels)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    img[3:6] = img[2]                          # repeated rows and runs
    blob = _hand_png(img, kinds)
    want = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    got = im.png_decode(blob)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    stored_order = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
    assert np.array_equal(got, stored_order)


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((720, 1280), (256, 512)),
    ((1080, 1920), (256, 512)),
    ((1024, 2048), (256, 512)),
    ((128, 256), (100, 200)),
    ((130, 260), (64, 128)),
    ((128, 256), (64, 128)),           # exactly 2x down: cv2's INTER_AREA
    ((512, 1024), (256, 512)),         # exactly 2x down at phase 6's size
    ((256, 512), (64, 128)),           # exactly 4x down
    ((256, 512), (512, 1024)),         # 2x up (the uplink's send size)
    ((64, 128), (130, 260)),
    ((37, 101), (64, 128)),
])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_linear_equals_cv2(src_hw, dst_hw, channels):
    rs = np.random.RandomState(sum(src_hw) + channels)
    shape = src_hw + ((channels,) if channels == 3 else ())
    for img in (rs.randint(0, 256, shape).astype(np.uint8),
                _smooth(*src_hw, c=3)[..., :channels].reshape(shape)):
        want = cv2.resize(img, (dst_hw[1], dst_hw[0]))
        got = im.resize_linear_u8(img, dst_hw)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want), int(
            np.abs(got.astype(int) - want).max())


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1024, 2048), (256, 512)), ((130, 260), (64, 128)),
    ((64, 128), (130, 260)), ((720, 1280), (256, 512)),
    ((100, 200), (64, 128)), ((128, 256), (128, 256))])
def test_resize_nearest_equals_cv2(src_hw, dst_hw):
    lab = np.random.RandomState(3).randint(0, 19, src_hw).astype(np.uint8)
    want = cv2.resize(lab, (dst_hw[1], dst_hw[0]),
                      interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(im.resize_nearest(lab, dst_hw), want)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    mp4 = str(root / "90-sines.mp4")
    jax_video.write_synthetic_clip(mp4, seconds=4, fps=10,
                                   size_hw=(128, 256), gt_dir=str(root / "gt"))
    frames = str(root / "frames" / "90-sines")
    assert frames_from_video(mp4, frames) == 40
    return mp4, frames, str(root / "gt") + "/"


@pytest.mark.parametrize("prefetch", [False, True])
def test_readers_match_jax_frame_for_frame(clip, prefetch):
    mp4, frames, _ = clip
    jr = jax_video.open_video(mp4, prefetch=prefetch)
    pr = tv.open_video(frames, prefetch=prefetch)
    try:
        assert (pr.fps, pr.frame_count) == (jr.fps, jr.frame_count) == (
            10, 40)
        for _ in range(12):
            assert np.array_equal(pr.read_or_die(), jr.read_or_die())
        for start in (17, 3, 38):
            jr.seek_frame(start)
            pr.seek_frame(start)
            for _ in range(2):
                assert np.array_equal(pr.read_or_die(), jr.read_or_die())
        assert pr.read() is None and jr.read() is None
        with pytest.raises(EOFError, match="Premature end of video"):
            pr.read_or_die()
    finally:
        jr.release()
        pr.release()


def test_frame_and_label_loading_match_jax(clip):
    mp4, frames, gt = clip
    jr = jax_video.VideoReader(mp4)
    frame = jr.read()
    jr.release()
    for hw in ((64, 128), (100, 200), (256, 512)):
        assert np.array_equal(tv.frame_to_rgb(frame, hw),
                              jax_video.frame_to_rgb(frame, hw))
    coco = np.arange(256, dtype=np.int32)[::-1].copy()
    for kw in ({}, {"size_hw": (64, 128)}, {"size_hw": (50, 70),
                                             "coco_map": coco}):
        want = jax_video.load_gt_label(gt, 7, **kw)
        got = tv.load_gt_label(gt, 7, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(IOError, match="missing ground-truth label"):
        tv.load_gt_label(gt, 400)
    with pytest.raises(IOError, match="clip.json"):
        tv.VideoReader(mp4)


class _Recorder:
    """Stands in for cv2.VideoWriter: keeps the frames written to it."""
    frames = []

    def __init__(self, *a):
        _Recorder.frames = []

    def isOpened(self):
        return True

    def write(self, f):
        _Recorder.frames.append(f.copy())

    def release(self):
        pass


@pytest.mark.parametrize("style", ["sines", "bands"])
def test_synthetic_clip_is_jax_frames_losslessly(style, tmp_path,
                                                 monkeypatch):
    kw = dict(seconds=2, fps=3, size_hw=(32, 48), seed=5, style=style)
    monkeypatch.setattr(jax_video.cv2, "VideoWriter", _Recorder)
    jax_video.write_synthetic_clip(str(tmp_path / "j.mp4"),
                                   gt_dir=str(tmp_path / "jgt"), **kw)
    monkeypatch.undo()
    d = str(tmp_path / "90-x")
    tv.write_synthetic_clip(d, gt_dir=str(tmp_path / "tgt"), **kw)
    r = tv.VideoReader(d)
    assert (r.fps, r.frame_count) == (3, 6) == (3, len(_Recorder.frames))
    for want in _Recorder.frames:
        assert np.array_equal(r.read(), want)
    for t in range(6):
        name = "gt_%06d.png" % t
        with open(tmp_path / "jgt" / name, "rb") as a, \
                open(tmp_path / "tgt" / name, "rb") as b:
            assert a.read() == b.read()


def test_chip_smoke_png_probe_is_cv2s():
    """chip_smoke.py phase 6 holds the card's zlib to these sizes and
    SHA-256s: they are OpenCV's bytes for its probe images."""
    import hashlib

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    for name, img in chip_smoke.png_probe_images().items():
        ok, blob = cv2.imencode(".png", img)
        assert ok
        blob = blob.tobytes()
        assert (len(blob), hashlib.sha256(blob).hexdigest()) == \
            chip_smoke.PNG_PROBE[name], name
        assert im.png_encode(img) == blob
