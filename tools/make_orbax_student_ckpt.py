"""Write the Orbax student checkpoint fixture that the port's Orbax reader
is held to (``tests/fixtures/student_orbax/``).

It reads the committed TF1 fixture (``tests/fixtures/student_tf1/model``:
the full-width student, 272 tensors once the restore filter drops the Adam
slot and ``global_step``) with the JAX package's ``load_tf_checkpoint``
and writes it with the JAX package's ``save_orbax``, that is orbax's
``PyTreeCheckpointer`` with its defaults: one OCDBT store (zstd-compressed
B+tree nodes, values out of line in ``ocdbt.process_0/d/`` files, the root
merged into the directory's own ``manifest.ocdbt``) of zarr v2 arrays.
The committed fixture was written by orbax-checkpoint 0.11.32 with
tensorstore 0.1.80.  A machine without orbax (the card's) can read it only
through ``ams_tpu_torch.utils.orbax``, and it must equal the TF1 fixture
name for name and bit for bit.

Usage (needs JAX, orbax and TensorFlow):
    python tools/make_orbax_student_ckpt.py [--out tests/fixtures/student_orbax]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF1_PREFIX = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")
DEFAULT_OUT = os.path.join(REPO, "tests", "fixtures", "student_orbax")


def write(out: str, prefix: str = TF1_PREFIX) -> int:
    """Write the fixture; returns its tensor count."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ams_tpu.utils import checkpoint as ckpt

    params = ckpt.load_tf_checkpoint(prefix)
    ckpt.save_orbax(out, params)
    # orbax leaves nothing temporary behind on success; make sure of it
    for left in glob.glob(out.rstrip("/") + ".orbax-checkpoint-tmp*"):
        shutil.rmtree(left, ignore_errors=True)
    return len(params)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="checkpoint directory to write (replaced)")
    ap.add_argument("--tf1", default=TF1_PREFIX,
                    help="TF1 checkpoint prefix to read")
    a = ap.parse_args()
    n = write(a.out, a.tf1)
    print("wrote %s (%d tensors)" % (a.out, n))


if __name__ == "__main__":
    main()
