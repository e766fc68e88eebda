"""Build the native delta codec (``codec.cpp``) with ``g++`` and zlib.

    g++ -O3 -shared -fPIC -std=c++17 codec.cpp -o build/ams_tpu_torch/<name>.so -lz

The library lands in ``build/ams_tpu_torch/`` at the root of the checkout
(not in the package directory), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.  It is
compiled to a temporary name and ``os.replace``-d into place, under a lock
for the threads of one process, as ``ops/build.py`` does for the kernels:
a build cut off midway leaves nothing that a later run would load.

Usage: python -m ams_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ams_tpu_torch.ops.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "codec.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)

_LOCK = threading.Lock()


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes()
                         + "\0".join(FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / ("ams_codec-%s.so" % key[:16])


def build() -> dict:
    """Compile the codec unless it is built already.  Returns {"path",
    "seconds", "cached"}; raises ``RuntimeError`` with the compiler's
    output if there is no ``g++`` or the build fails (zlib's header or
    library missing, say)."""
    with _LOCK:
        out = library_path()
        if out.exists():
            return {"path": str(out), "seconds": 0.0, "cached": True}
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the native codec "
                               "builds from source")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        t0 = time.perf_counter()
        proc = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("g++ failed for the native codec (rc %d):\n%s"
                               % (proc.returncode, proc.stdout))
        os.replace(tmp, out)
        return {"path": str(out), "seconds": time.perf_counter() - t0,
                "cached": False}


if __name__ == "__main__":
    print(build())
