"""Three port faults found against ams_tpu, each held to the reference.

- Confusion matrices with label or prediction ids outside [0, C) (255,
  C, -1): ams_tpu one-hot encodes, so such a pixel adds nothing; the port
  gives it weight 0.  The matrices must be equal (integer counts in f32).
- An extension-less checkpoint path with both ``.npy`` and ``.npz``
  beside it: ams_tpu's ``load_any`` takes ``.npy`` first; the facade must
  load the same weights, filtered and suffix-stripped alike.
- ``close_model`` drops cached rounds only: a closed network still
  predicts and ``get_vars`` still returns its weights, in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.models import mobilenetv2_deeplab as jm
from ams_tpu.runtime.network import SemanticNetwork as JaxNetwork
from ams_tpu.utils import checkpoint as jckpt
from ams_tpu.utils.metrics import confusion_matrix as j_confusion_matrix

from ams_tpu_torch.runtime.network import SemanticNetwork as TorchNetwork
from ams_tpu_torch.utils import metrics as tmetrics

C = 6


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("bad", [255, C, -1])
def test_confusion_matrix_ignores_ids_out_of_range(bad):
    rng = np.random.RandomState(bad % 97)
    labels = rng.randint(0, C, (3, 8, 10)).astype(np.int32)
    preds = rng.randint(0, C, (3, 8, 10)).astype(np.int32)
    weights = (rng.rand(3, 8, 10) < 0.9).astype(np.float32)
    labels[0, :2] = bad                     # frame 0: out-of-range labels
    preds[1, 3:5] = bad                     # frame 1: out-of-range preds
    want_f = np.stack([np.asarray(j_confusion_matrix(
        jnp.asarray(labels[b]), jnp.asarray(preds[b]), C,
        jnp.asarray(weights[b]))) for b in range(3)])
    want = np.asarray(j_confusion_matrix(jnp.asarray(labels),
                                         jnp.asarray(preds), C,
                                         jnp.asarray(weights)))
    t = [torch.from_numpy(a) for a in (labels, preds, weights)]
    got = tmetrics.confusion_matrix(*t[:2], C, t[2]).numpy()
    got_f = tmetrics.confusion_matrix_per_frame(*t[:2], C, t[2]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_f, want_f)
    # unweighted too, and nothing spills into a neighbouring frame
    np.testing.assert_array_equal(
        tmetrics.confusion_matrix(*t[:2], C).numpy(),
        np.asarray(j_confusion_matrix(jnp.asarray(labels),
                                      jnp.asarray(preds), C)))
    assert got_f[0].sum() == weights[0, 2:].sum()
    assert got_f[1].sum() == weights[1].sum() - weights[1, 3:5].sum()


@pytest.fixture(scope="module")
def student():
    return {k: np.asarray(v) for k, v in
            jm.init_student_params(jax.random.PRNGKey(3)).items()}


def test_checkpoint_lookup_takes_npy_before_npz(student, tmp_path):
    prefix = str(tmp_path / "model")
    npy = dict(student)
    npy["MobilenetV2/Conv/weights:0"] = npy.pop("MobilenetV2/Conv/weights")
    npy["MobilenetV2/Conv/weights/Adam"] = np.ones(1, np.float32)
    jckpt.save_params(prefix + ".npy", npy)
    npz = {k: v + np.float32(1.0) for k, v in student.items()}
    np.savez(prefix + ".npz", **npz)
    want = jckpt.load_any(prefix)
    np.testing.assert_array_equal(want["MobilenetV2/Conv/weights"],
                                  student["MobilenetV2/Conv/weights"])
    kw = dict(class_weights_exp=configs.class_weights(0), height=64,
              frozen=True)
    got = TorchNetwork(prefix, device="cpu", **kw).get_vars()
    assert sorted(got) == sorted(JaxNetwork(prefix, **kw).get_vars())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # an explicit .npz path still loads the .npz, filtered the same way
    np.savez(prefix + "_z.npz", **npy)
    got_z = TorchNetwork(prefix + "_z.npz", device="cpu", **kw).get_vars()
    want_z = jckpt.load_any(prefix + "_z.npz")
    for k in want_z:
        np.testing.assert_array_equal(got_z[k], want_z[k])


def test_closed_network_still_predicts(student):
    frames = np.random.RandomState(4).randint(
        0, 256, (1, 64, 128, 3)).astype(np.uint8)
    kw = dict(class_weights_exp=configs.class_weights(0), height=64,
              frozen=True)
    jnet = JaxNetwork(dict(student), **kw)
    tnet = TorchNetwork(dict(student), device="cpu", **kw)
    before = tnet.predict_input(frames)
    for net in (jnet, tnet):
        net.close_model()
    np.testing.assert_array_equal(tnet.predict_input(frames), before)
    assert jnet.predict_input(frames).shape == before.shape
    j_vars, t_vars = jnet.get_vars(), tnet.get_vars()
    assert sorted(t_vars) == sorted(j_vars)
    for k in j_vars:
        np.testing.assert_array_equal(t_vars[k], j_vars[k])
