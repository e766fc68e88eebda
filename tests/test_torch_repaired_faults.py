"""Three faults of the port, repaired, on the CPU.

1. Another thread's ``resolve_device`` turned a TF32 round back to f32:
   it wrote both TF32 flags off outside the span's lock.  Now it leaves
   them to an open ``conv_precision("default")`` span (two threads, with
   ``torch.cuda.is_available`` patched, as no card is here).
2. The round was not deterministic on the card: ``index_select``'s
   backward in the gather resize adds by atomics there, and cuDNN's
   default algorithms are not deterministic.  The resize's gathers now
   have a backward that sums each source row's band in a fixed order
   (held here against ``index_select``'s own backward), and selecting a
   CUDA device turns cuDNN's deterministic mode on.  Bitwise reruns on
   the card are chip_smoke.py phase 11's.
3. ``png_decode`` unfiltered Average and Paeth rows byte by byte in
   Python.  The native library (``native/png.cpp``) unfilters every row
   now: 512x1024 frames written by OpenCV with each of the five row
   filters decode to cv2's pixels through it (its call count rises), and
   it equals the plain ``_unfilter`` on rows of mixed filters.
"""

import threading
import zlib

import cv2
import numpy as np
import pytest
import torch

from ams_tpu_torch.data import image
from ams_tpu_torch.models import resize
from ams_tpu_torch.native import png as native_png
from ams_tpu_torch.utils import platform


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def fake_card(monkeypatch):
    saved = _flags(), torch.backends.cudnn.deterministic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    yield
    ((torch.backends.cuda.matmul.allow_tf32,
      torch.backends.cudnn.allow_tf32),
     torch.backends.cudnn.deterministic) = saved


# --------------------------------------------------------- 1. TF32 flags


def test_resolve_device_on_another_thread_keeps_a_tf32_span(fake_card):
    """ROADMAP's probe: the flags read (True, True) at the span's start
    and must still after another thread's ``resolve_device``."""
    platform.resolve_device("cuda")
    assert _flags() == (False, False)
    inside, other_done, leave = (threading.Event() for _ in range(3))
    seen = []

    def round_thread():
        with platform.conv_precision("default"):
            seen.append(_flags())
            inside.set()
            other_done.wait(10)
            seen.append(_flags())
            leave.wait(10)
            seen.append(_flags())

    t = threading.Thread(target=round_thread)
    t.start()
    assert inside.wait(10)
    other = threading.Thread(target=platform.resolve_device, args=("cuda",))
    other.start()
    other.join(10)
    other_done.set()
    leave.set()
    t.join(10)
    assert seen == [(True, True)] * 3
    assert _flags() == (False, False)        # restored by the span's exit
    torch.backends.cuda.matmul.allow_tf32 = True
    platform.resolve_device("cuda")          # no span: turned off
    assert _flags() == (False, False)


# -------------------------------------------------------- 2. determinism


def test_selecting_a_card_turns_cudnn_deterministic_on(fake_card):
    torch.backends.cudnn.deterministic = False
    platform.resolve_device("cuda")
    assert torch.backends.cudnn.deterministic


def _index_select_resize(x, out_hw):
    """resize_nchw's arithmetic with ``index_select`` gathers, whose
    backward is ``index_add_``."""
    h, w = x.shape[2], x.shape[3]
    ylo, yhi, yw = resize._device_lerp(h, out_hw[0], x.device)
    xlo, xhi, xw = resize._device_lerp(w, out_hw[1], x.device)

    def h_lerp(rows):
        left, right = rows.index_select(3, xlo), rows.index_select(3, xhi)
        return left + (right - left) * xw

    top, bot = h_lerp(x.index_select(2, ylo)), h_lerp(x.index_select(2, yhi))
    return top + (bot - top) * yw[:, None]


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 17, 33), (256, 512)),
                                          ((1, 4, 5, 9), (3, 4)),
                                          ((1, 2, 9, 17), (9, 40)),
                                          ((1, 1, 3, 3), (1, 7))])
def test_resize_backward_is_index_selects_in_a_fixed_order(shape, out_hw):
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    x.requires_grad_(True)
    got = resize.resize_nchw(x, out_hw)
    want = _index_select_resize(x, out_hw)
    assert torch.equal(got, want)
    seed = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    (g,) = torch.autograd.grad(got, x, seed)
    (w,) = torch.autograd.grad(want, x, seed)
    assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    (again,) = torch.autograd.grad(resize.resize_nchw(x, out_hw), x, seed)
    assert torch.equal(again, g)


# ---------------------------------------------------------- 3. PNG rows


FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


def _filter_bytes(blob, h, stride):
    """The filter byte of each row of a PNG stream."""
    pos, idat = 8, b""
    while pos < len(blob):
        n = int.from_bytes(blob[pos:pos + 4], "big")
        if blob[pos + 4:pos + 8] == b"IDAT":
            idat += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


@pytest.fixture(scope="module")
def frame():
    """A 512x1024 BGR frame: smooth bands (which the predictors fit) and
    noise."""
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:512, 0:1024]
    img = np.stack([(x // 4 + y // 8) % 256, (x * y // 512) % 256,
                    (y // 2) % 256], -1).astype(np.uint8)
    img[200:260] = rng.randint(0, 256, (60, 1024, 3))
    return img


@pytest.mark.parametrize("name", FILTERS)
def test_png_decode_takes_the_native_unfilter_for_every_filter(frame, name):
    ok, blob = cv2.imencode(".png", frame, [
        cv2.IMWRITE_PNG_FILTER, getattr(cv2, "IMWRITE_PNG_FILTER_" + name)])
    assert ok
    blob = blob.tobytes()
    kinds = _filter_bytes(blob, 512, 1024 * 3)
    assert kinds == {FILTERS.index(name)}, kinds
    calls = native_png.unfilter.calls
    got = image.png_decode(blob)
    assert native_png.unfilter.calls == calls + 1
    np.testing.assert_array_equal(got, cv2.imdecode(
        np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_native_unfilter_equals_the_plain_version(bpp):
    rng = np.random.RandomState(bpp)
    h, stride = 23, 7 * bpp
    data = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    data[:, 0] = rng.randint(0, 5, h)
    data[:5, 0] = (3, 4, 4, 3, 1)         # Average and Paeth on row 0 too
    np.testing.assert_array_equal(
        native_png.unfilter(data.reshape(-1), h, stride, bpp),
        image._unfilter(data.reshape(-1), h, stride, bpp))
    data[9, 0] = 5
    for fn in (native_png.unfilter, image._unfilter):
        with pytest.raises(ValueError, match="filter 5"):
            fn(data.reshape(-1), h, stride, bpp)


@pytest.mark.parametrize("kind", [3, 4])
def test_chip_smoke_decode_probe_is_cv2s(kind):
    """chip_smoke.py phase 11 decodes these Average and Paeth PNGs on the
    card and holds the pixels to this digest: cv2's decode of them here."""
    import hashlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    frame = chip_smoke.decode_probe_frame()
    blob = chip_smoke.png_filtered(frame, kind)
    assert _filter_bytes(blob, 512, 1024 * 3) == {kind}
    pixels = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    assert hashlib.sha256(pixels.tobytes()).hexdigest() == \
        chip_smoke.DECODE_PROBE
    np.testing.assert_array_equal(image.png_decode(blob), pixels)
