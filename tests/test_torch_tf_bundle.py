"""The port's TF checkpoint reader (``utils/tf_bundle.py``, behind
``utils.checkpoint.load_tf_checkpoint`` and ``load_any``) against
ams_tpu's ``load_tf_checkpoint``, which calls TensorFlow's own reader.

Every checkpoint here is written by TensorFlow in this process: a TF1
``Saver`` checkpoint with an Adam slot and ``global_step``; one with
f16, f32, f64, i32, i64 and bool tensors, a scalar and a zero-size tensor;
one sharded over two devices (two data files); a TF2
``tf.train.Checkpoint`` with its object-graph string.  Each is read by the
port key for key, with the same dtype, shape and bytes as JAX's.  A data
byte flipped or a truncated data file raises; a partitioned variable
raises ``NotImplementedError``.  The committed fixture
(``tests/fixtures/student_tf1``, written by
``tools/make_tf1_student_ckpt.py``) holds its tool's seeded arrays, and a
process where tensorflow cannot be imported reads it.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ams_tpu.utils import checkpoint as jckpt

from ams_tpu_torch.utils import checkpoint as tckpt
from ams_tpu_torch.utils import tf_bundle

tf = pytest.importorskip("tensorflow")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_tf1_student_ckpt",
        os.path.join(REPO, "tools", "make_tf1_student_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tf1(prefix, arrays, two_shards=False, partitioned=None):
    v1 = tf.compat.v1
    g = tf.Graph()
    with g.as_default():
        for i, (name, val) in enumerate(arrays.items()):
            with tf.device("/cpu:%d" % (i % 2) if two_shards else None):
                v1.get_variable(name, initializer=tf.constant(val),
                                trainable=val.dtype.kind == "f")
        if partitioned is not None:
            v1.get_variable(partitioned, shape=(8, 3),
                            initializer=v1.ones_initializer(),
                            partitioner=v1.fixed_size_partitioner(2))
        saver = v1.train.Saver(sharded=two_shards)
        init = v1.global_variables_initializer()
    config = v1.ConfigProto(device_count={"CPU": 2})
    with v1.Session(graph=g, config=config) as sess:
        sess.run(init)
        saver.save(sess, prefix, write_meta_graph=False, write_state=False)
    return prefix


def _assert_same_as_jax(prefix):
    got = tckpt.load_tf_checkpoint(prefix)
    want = jckpt.load_tf_checkpoint(prefix)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        assert got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    return got


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "a/weights": rng.randn(3, 3, 4, 5).astype(np.float32),
        "a/BatchNorm/moving_variance": rng.rand(5).astype(np.float32),
        "b/half": rng.randn(7).astype(np.float16),
        "b/double": rng.randn(2, 3),
        "c/int32": rng.randint(-9, 9, (4,)).astype(np.int32),
        "c/int64": rng.randint(-9, 9, (2, 2)).astype(np.int64),
        "d/bool": rng.rand(6) > 0.5,
        "e/scalar": np.float32(2.5),
        "e/empty": np.zeros((0, 3), np.float32),
    }


@pytest.fixture(scope="module")
def saver_ckpt(tmp_path_factory):
    arrays = _arrays(0)
    slot = {"a/weights/Adam": np.ones((3, 3, 4, 5), np.float32),
            "global_step": np.int64(77)}
    prefix = str(tmp_path_factory.mktemp("tf1") / "model")
    return _write_tf1(prefix, {**arrays, **slot}), arrays


def test_saver_checkpoint_matches_jax_and_drops_slots(saver_ckpt):
    prefix, arrays = saver_ckpt
    got = _assert_same_as_jax(prefix)
    assert sorted(got) == sorted(arrays)       # slot and step filtered
    for k, v in arrays.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    names = [n for n, _ in tf_bundle.read_index(prefix)[1]]
    assert "a/weights/Adam" in names and "global_step" in names


def test_every_dtype_scalar_and_empty_tensor(saver_ckpt):
    prefix, arrays = saver_ckpt
    got = tckpt.load_tf_checkpoint(prefix)
    assert {str(got[k].dtype) for k in got} >= {
        "float16", "float32", "float64", "int32", "int64", "bool"}
    assert got["e/scalar"].shape == () and got["e/empty"].shape == (0, 3)


def test_two_shards_match_jax(tmp_path):
    prefix = _write_tf1(str(tmp_path / "model"), _arrays(1), two_shards=True)
    header, _ = tf_bundle.read_index(prefix)
    assert header["num_shards"] == 2
    assert sorted(os.listdir(tmp_path)) == [
        "model.data-00000-of-00002", "model.data-00001-of-00002",
        "model.index"]
    got = _assert_same_as_jax(prefix)
    for k, v in _arrays(1).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_tf2_checkpoint_with_object_graph_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    ck = tf.train.Checkpoint(
        w=tf.Variable(rng.randn(4, 3).astype(np.float32)),
        step=tf.Variable(np.int64(5)))
    prefix = ck.write(str(tmp_path / "tf2"))
    got = _assert_same_as_jax(prefix)
    graph = got["_CHECKPOINTABLE_OBJECT_GRAPH"]
    want = jckpt.load_tf_checkpoint(prefix)["_CHECKPOINTABLE_OBJECT_GRAPH"]
    assert graph.dtype == want.dtype and graph.dtype.kind == "S"
    assert graph.shape == () and graph.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got["w/.ATTRIBUTES/VARIABLE_VALUE"],
                                  ck.w.numpy())


def test_flipped_data_byte_fails_the_crc(saver_ckpt, tmp_path):
    prefix, _ = saver_ckpt
    copy = str(tmp_path / "model")
    for ext in (".index", ".data-00000-of-00001"):
        shutil.copy(prefix + ext, copy + ext)
    entry = dict(tf_bundle.read_index(copy)[1])["a/weights"]
    with open(copy + ".data-00000-of-00001", "r+b") as f:
        f.seek(entry["offset"] + entry["size"] // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(ValueError, match="CRC"):
        tckpt.load_tf_checkpoint(copy)


def test_truncated_data_file_raises(saver_ckpt, tmp_path):
    prefix, _ = saver_ckpt
    copy = str(tmp_path / "model")
    shutil.copy(prefix + ".index", copy + ".index")
    data = open(prefix + ".data-00000-of-00001", "rb").read()
    kept = [e for n, e in tf_bundle.read_index(prefix)[1]
            if tckpt.default_filter(n) is not None and e["size"]]
    cut = max(e["offset"] + e["size"] for e in kept) - 1
    with open(copy + ".data-00000-of-00001", "wb") as f:
        f.write(data[:cut])
    with pytest.raises(ValueError, match="truncated"):
        tckpt.load_tf_checkpoint(copy)


def test_partitioned_variable_raises(tmp_path):
    prefix = _write_tf1(str(tmp_path / "model"),
                        {"w": np.ones(3, np.float32)}, partitioned="part")
    with pytest.raises(NotImplementedError, match="partitioned"):
        tckpt.load_tf_checkpoint(prefix)


def test_load_any_reads_the_prefix_as_jax_does():
    got, want = tckpt.load_any(FIXTURE), jckpt.load_any(FIXTURE)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def test_committed_fixture_holds_the_tools_arrays():
    tool = _tool()
    want = tool.student_arrays()
    got = _assert_same_as_jax(FIXTURE)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    index = dict(tf_bundle.read_index(FIXTURE)[1])
    assert tool.SLOT in index and "global_step" in index


def test_crc32c_known_values():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    assert tf_bundle.crc32c(b"") == 0
    rng = np.random.RandomState(4)
    for n in (1, 17, 255, 4097, 70001):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert tf_bundle.crc32c(data) == \
            tf_bundle._step_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF, n


_BLOCKED = r"""
import sys
BLOCKED = ("tensorflow", "jax", "ams_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
from ams_tpu_torch.utils import checkpoint
got = checkpoint.load_any(%r)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(got), sum(v.size for v in got.values()))
"""


def test_reader_runs_without_tensorflow():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED % FIXTURE],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    n, size = map(int, proc.stdout.split())
    want = _tool().student_arrays()
    assert n == len(want) and size == sum(v.size for v in want.values())
