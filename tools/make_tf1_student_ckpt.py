"""Write the TF1 student checkpoint fixture that the port's TF reader is
held to (``tests/fixtures/student_tf1/model.{index,data-00000-of-00001}``).

A ``tf.compat.v1.train.Saver`` checkpoint, the reference's shipped format,
with the full-width student's variable names and shapes (MobileNetV2 1.0,
ASPP 256, 19 classes; the port's ``init_student_params``), values drawn
from ``np.random.RandomState(seed)`` by ``student_arrays``, plus one Adam
slot and ``global_step``, which a restore drops.  ``student_arrays``
needs only numpy and the port, so a machine without TensorFlow (the card's)
can regenerate the values it must read back.

Usage (needs TensorFlow):
    python tools/make_tf1_student_ckpt.py [--out tests/fixtures/student_tf1/model]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PREFIX = os.path.join(REPO, "tests", "fixtures", "student_tf1",
                              "model")
SEED = 15
SLOT = "logits/semantic/weights/Adam"   # dropped by the restore filter
GLOBAL_STEP = 1234


def student_arrays(seed: int = SEED) -> dict:
    """The fixture's student values: weights at the fan-in scale, BN
    gammas near 1, betas and moving means near 0, moving variances in
    [0.5, 1.5), all float32, in sorted-name order from one RandomState."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params

    shapes = {k: tuple(v.shape) for k, v in
              init_student_params(0, device="cpu").items()}
    rs = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if name.endswith("moving_variance"):
            v = rs.uniform(0.5, 1.5, shape)
        elif name.endswith("gamma"):
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name.endswith(("beta", "moving_mean", "biases")):
            v = 0.1 * rs.standard_normal(shape)
        else:                                 # conv weights, HWIO
            fan_in = shape[0] * shape[1] * (1 if "depthwise" in name
                                            else shape[2])
            v = rs.standard_normal(shape) / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def extras(arrays: dict) -> dict:
    """The two entries a restore must drop: an Adam slot and the step."""
    return {SLOT: np.full(arrays["logits/semantic/weights"].shape, 0.25,
                          np.float32),
            "global_step": np.int64(GLOBAL_STEP)}


def write(prefix: str, seed: int = SEED) -> None:
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
    import tensorflow as tf

    v1 = tf.compat.v1
    arrays = student_arrays(seed)
    g = tf.Graph()
    with g.as_default():
        for name, val in {**arrays, **extras(arrays)}.items():
            v1.get_variable(name, initializer=tf.constant(val))
        saver = v1.train.Saver()
        init = v1.global_variables_initializer()
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with v1.Session(graph=g) as sess:
        sess.run(init)
        saver.save(sess, prefix, write_meta_graph=False,
                   write_state=False)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_PREFIX,
                    help="checkpoint prefix to write")
    ap.add_argument("--seed", type=int, default=SEED)
    a = ap.parse_args()
    write(a.out, a.seed)
    print("wrote %s.index and its data file" % a.out)


if __name__ == "__main__":
    main()
