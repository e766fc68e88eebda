"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and includes no
PyTorch header, so it compiles in seconds into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/ams_tpu_torch/<name>-<key>.so

The library lands in ``build/ams_tpu_torch/`` at the root of the checkout,
under a name keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  It is written to a
temporary name and ``os.replace``-d into place: no lock file, and a build
cut off midway leaves nothing that a later run would load.

Nothing here runs at import: the first call that needs a kernel builds it.
Threads of one process (the live server's sessions, a client beside them)
may need a kernel at the same moment: ``build`` and ``load`` hold one lock,
so a library is compiled and loaded once per process.  ``load`` types each
entry point once, from its declaration in ``ENTRY_POINTS``.

``launch`` is the one way a wrapper in ``ops/`` starts a kernel: it makes
the device current where it is not, passes the device's current stream,
raises on a CUDA error, and counts the launch under the wrapper's name.
``launch_count(name)`` reads a count and ``reset_launch_counts()`` clears
them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ams_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# each library's entry points, {name: (restype, argtypes)}, as
# csrc/<library>.cu declares them; a ``<library>_launch`` takes the stream
# last
ENTRY_POINTS = {
    "resize_argmax": {
        "resize_argmax_launch": (_I, (_P, _I) + (ctypes.c_longlong,) * 4
                                 + (_P, _I) + (_P,) * 3 + (_I,) * 6 + (_P,)),
    },
    "resize_ce": {
        "resize_ce_launch": (_I, (_P,) * 15 + (_I,) * 11 + (_P,)),
        "resize_ce_smem_bytes": (ctypes.c_size_t, (_I,) * 4),
        "resize_ce_smem_limit": (_I, (_I,)),
    },
    "mbconv": {
        "mbconv_launch": (_I, (_P,) * 6 + (_I,) * 18 + (_P,)),
        "mbconv_smem_bytes": (_I, (_I,) * 8),
        "mbconv_tilings": (_I, (ctypes.POINTER(_I),) * 4 + (_I,)),
        "mbconv_resident": (_I, (_I,) * 3),
    },
    "depthwise_dilated": {
        "depthwise_dilated_launch": (_I, (_P,) * 4 + (_I,) * 12 + (_P,)),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()
_LAUNCHES: Counter = Counter()
_LAUNCH_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s/bin and on PATH): the port's CUDA "
            "kernels build only where the CUDA toolkit is installed" % home)
    return found


def library_path(name: str) -> Path:
    src = (CSRC / (name + ".cu")).read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("%s-%s.so" % (name, key[:16]))


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every named kernel library that is not built yet, all
    ``nvcc`` processes started together, and wait for them.  Returns
    {name: {"path", "seconds", "cached", "ptxas"}}, ptxas being the
    compiler's register, spill and shared-memory lines.  Raises with the
    compiler's output if any build fails."""
    with _LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"path": str(out), "seconds": 0.0, "ptxas": [],
                          "cached": True}
            continue
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append("%s (rc %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
        info[name] = {
            "path": str(out), "seconds": seconds, "cached": False,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "smem" in ln]}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


def current_stream(device_index: int) -> int:
    """PyTorch's current stream on the device, as the raw handle a
    launcher takes."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process,
    its ``ENTRY_POINTS`` typed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for entry, (restype, argtypes) in ENTRY_POINTS[name].items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, list(argtypes)
            _LOADED[name] = lib
        return lib


def launch(name: str, kernel: str, device_index: int, args: Sequence,
           describe: Callable[[], str]) -> None:
    """Launch ``kernel``'s ``<kernel>_launch`` with ``args`` and the
    current stream of CUDA device ``device_index``, made the current
    device for the call where it is not already, and count the launch
    under ``name``, the wrapper's.  A nonzero return raises
    ``RuntimeError`` with the kernel, the CUDA error and ``describe()``,
    called only then."""
    import torch

    fn = getattr(load(kernel), kernel + "_launch")
    stream = current_stream(device_index)
    if device_index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device_index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (kernel, err, describe()))
    with _LAUNCH_COUNT_LOCK:
        _LAUNCHES[name] += 1


def launch_count(name: str) -> int:
    """Kernel launches counted under ``name`` since the last reset."""
    return _LAUNCHES[name]


def reset_launch_counts() -> None:
    """Every launch count to 0."""
    with _LAUNCH_COUNT_LOCK:
        _LAUNCHES.clear()
