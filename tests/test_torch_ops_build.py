"""``ops.build``'s one launch path for the port's CUDA kernels, on the CPU.

Every kernel wrapper in ``ops/`` starts its kernel through
``build.launch``: the device made current where it is not, the device's
current stream passed last, a nonzero return raised as a ``RuntimeError``
naming the kernel and the CUDA error, and the launch counted under the
wrapper's name.  Here the loaded library is a stand-in whose entry points
return a chosen code and keep their calls, on a stand-in device 0 that is
current; the kernels themselves run only on the card.  ``ENTRY_POINTS``,
the one declaration of each entry point's C types, is held against the
``extern "C"`` signatures in ``csrc/``.
"""

import ctypes
import re
import sys
import threading

import pytest
import torch

from ams_tpu_torch.ops import build

STREAM = 1234


class StandInEntry:
    """A ctypes entry point's stand-in: returns ``rc``, keeps the
    arguments of its calls, and counts how often it is typed."""

    def __init__(self, rc=0):
        self.rc, self.calls, self.typed = rc, [], 0
        self.restype = None
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.typed += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class StandInLibrary:
    """A loaded library's stand-in: an entry point is made at its first
    lookup and kept, as ``ctypes.CDLL`` does."""

    def __init__(self, path=None, rc=0):
        self.path, self.rc = path, rc

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = StandInEntry(self.rc)
        setattr(self, name, fn)
        return fn


def install_stand_in(monkeypatch, kernel, rc=0):
    """``kernel``'s library as loaded, a stand-in whose entry points return
    ``rc``; device 0 current, each device's stream ``STREAM`` + its
    index.  -> the stand-in library."""
    lib = StandInLibrary(rc=rc)
    monkeypatch.setitem(build._LOADED, kernel, lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "current_stream",
                        lambda index: STREAM + index)
    return lib


def _unasked():
    raise AssertionError("the description is built only on failure")


def test_launch_passes_the_stream_last_and_counts_under_the_wrapper(
        monkeypatch):
    lib = install_stand_in(monkeypatch, "mbconv")
    before = (build.launch_count("mbconv"),
              build.launch_count("mbconv_banded"))
    build.launch("mbconv_banded", "mbconv", 0, (7, 8), _unasked)
    build.launch("mbconv", "mbconv", 0, [9], _unasked)
    assert lib.mbconv_launch.calls == [(7, 8, STREAM), (9, STREAM)]
    assert (build.launch_count("mbconv"),
            build.launch_count("mbconv_banded")) == (before[0] + 1,
                                                 before[1] + 1)


def test_launch_makes_the_device_current_only_where_it_is_not(monkeypatch):
    lib = install_stand_in(monkeypatch, "depthwise_dilated")
    entered = []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    build.launch("depthwise_dilated", "depthwise_dilated", 0, (), _unasked)
    assert entered == []
    build.launch("depthwise_dilated", "depthwise_dilated", 1, (), _unasked)
    assert entered == [1]
    assert lib.depthwise_dilated_launch.calls == [(STREAM,), (STREAM + 1,)]


@pytest.mark.parametrize("kernel,name", [
    ("resize_argmax", "resize_argmax"),
    ("resize_ce", "resize_ce_loss_grad"),
    ("depthwise_dilated", "depthwise_dilated"),
])
def test_a_nonzero_return_raises_naming_the_kernel_and_the_error(
        monkeypatch, kernel, name):
    install_stand_in(monkeypatch, kernel, rc=700)
    asked = []

    def describe():
        asked.append(1)
        return "x (2, 4, 9, 9), rate 2"

    before = build.launch_count(name)
    with pytest.raises(RuntimeError, match=r"^%s kernel launch failed: CUDA "
                       r"error 700 \(x \(2, 4, 9, 9\), rate 2\)$" % kernel):
        build.launch(name, kernel, 0, (1,), describe)
    assert asked == [1]
    assert build.launch_count(name) == before


def test_counts_from_threads_sum_exactly_and_the_reset_clears_them(
        monkeypatch):
    install_stand_in(monkeypatch, "resize_argmax")
    install_stand_in(monkeypatch, "resize_ce")
    names = ("resize_argmax", "resize_ce_loss")
    before = {n: build.launch_count(n) for n in names}
    per_thread, n_threads = 500, 8

    def work(i):
        name = names[i % 2]
        kernel = "resize_argmax" if name == "resize_argmax" else "resize_ce"
        for _ in range(per_thread):
            build.launch(name, kernel, 0, (), _unasked)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for n in names:
        assert build.launch_count(n) == \
            before[n] + per_thread * n_threads // 2
    build.reset_launch_counts()
    assert [build.launch_count(n) for n in names + ("mbconv",)] == [0, 0, 0]


@pytest.mark.parametrize("kernel", sorted(build.ENTRY_POINTS))
def test_each_entry_point_is_typed_once_per_process(monkeypatch, kernel):
    """``load`` types every declared entry point of a library when it
    loads it, and a later load or launch types nothing again."""
    loaded = []

    def cdll(path):
        loaded.append(path)
        return StandInLibrary(path)

    monkeypatch.setattr(build, "_build", lambda names: {})
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "current_stream", lambda index: STREAM)
    lib = build.load(kernel)
    for _ in range(3):
        build.launch(kernel, kernel, 0, (), _unasked)
    assert build.load(kernel) is lib and len(loaded) == 1
    for entry, (restype, argtypes) in build.ENTRY_POINTS[kernel].items():
        fn = getattr(lib, entry)
        assert fn.typed == 1, entry
        assert fn.argtypes == list(argtypes) and fn.restype is restype
    assert len(getattr(lib, kernel + "_launch").calls) == 3


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "size_t": ctypes.c_size_t}
_INT_PTR = ctypes.POINTER(ctypes.c_int)


def _c_type(decl):
    """The ctypes type ``ENTRY_POINTS`` declares for a C parameter or
    return type: a pointer is ``c_void_p``, an ``int*`` that the caller
    fills ``POINTER(c_int)``."""
    decl = re.sub(r"\bconst\b", "", decl).strip()
    if "*" in decl:
        base = decl.split("*")[0].strip()
        return "int*" if base == "int" else ctypes.c_void_p
    base = re.sub(r"\s+\w+$", "", decl).strip() if " " in decl else decl
    return _C_TYPES[base]


@pytest.mark.parametrize("kernel", sorted(build.ENTRY_POINTS))
def test_entry_points_declare_the_kernel_sources_signatures(kernel):
    src = (build.CSRC / (kernel + ".cu")).read_text()
    found = {m.group(2): (m.group(1), m.group(3)) for m in re.finditer(
        r'extern "C" ([\w ]+?) (\w+)\(([^)]*)\)', src)}
    assert set(found) == set(build.ENTRY_POINTS[kernel])
    for entry, (restype, argtypes) in build.ENTRY_POINTS[kernel].items():
        ret, params = found[entry]
        assert _c_type(ret) is restype, entry
        want = [_c_type(p) for p in params.split(",")]
        assert len(want) == len(argtypes), entry
        for i, (w, got) in enumerate(zip(want, argtypes)):
            if w == "int*":
                # an int* the launcher reads (a table) goes as c_void_p;
                # one the caller fills as POINTER(c_int)
                assert got in (ctypes.c_void_p, _INT_PTR), (entry, i)
            else:
                assert got is w, (entry, i, got, w)
        if entry.endswith("_launch"):
            assert argtypes[-1] is ctypes.c_void_p, entry   # the stream
