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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ams_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


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


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use in this process."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
