"""Orbax checkpoints without orbax (``ams_tpu_torch.utils.{zstd, ocdbt,
zarr2, orbax}``) against ams_tpu's ``save_orbax``/``load_orbax``, which
call orbax, on the CPU:

* a dict that JAX's ``save_orbax`` writes (an OCDBT store, orbax's
  default) reads through the port's ``load_orbax`` to JAX's
  ``load_orbax`` arrays, bit for bit: every dtype a checkpoint holds,
  scalars, names with '/' and ':0', a value stored out of line, and the
  full-width student;
* a dict that the port's ``save_orbax`` writes (zarr v2 per array) reads
  back through JAX's ``load_orbax`` and ``load_any`` bit for bit;
* the committed fixture ``tests/fixtures/student_orbax/`` equals the TF1
  fixture;
* the OCDBT reader against tensorstore's on stores with interior B+tree
  nodes, version-tree nodes, deleted keys and values in and out of line;
  the zarr reader against tensorstore's zarr arrays on a chunk grid with
  absent chunks;
* a flipped byte in a node or the manifest, a directory without
  ``_METADATA``, and a host without ``libzstd.so.1`` raise;
* ``StudentConfig`` and ``block_names`` equal JAX's.
"""

import dataclasses
import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch

from ams_tpu.models import mobilenetv2_deeplab as jstudent
from ams_tpu.utils import checkpoint as jckpt

import ams_tpu_torch.models as tmodels
from ams_tpu_torch.models import mobilenetv2_deeplab as tstudent
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils import ocdbt, orbax, zarr2, zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF1 = os.path.join(REPO, "tests", "fixtures", "student_tf1", "model")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "student_orbax")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _bits(a):
    """The bytes, dtype and shape of an array; bfloat16 of either package
    as its 16-bit words."""
    a = np.asarray(a)
    if a.dtype == zarr2.BFLOAT16 or a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16).tobytes(), "bfloat16", a.shape
    return a.tobytes(), a.dtype.str, a.shape


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def _cases():
    rng = np.random.default_rng(0)
    return {
        "float32": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
        "float16": {"h": rng.standard_normal(7).astype(np.float16)},
        "float64": {"d": rng.standard_normal((2, 3, 2))},
        "int32": {"i": np.arange(-5, 6, dtype=np.int32)},
        "int64": {"l": np.arange(9, dtype=np.int64) * (1 << 40)},
        "bool": {"b": rng.random(11) > 0.5},
        "bfloat16": {"bf": rng.standard_normal((4, 5)).astype(
            ml_dtypes.bfloat16)},
        "scalar": {"global_step": np.int64(1234), "s": np.float32(3.5),
                   "z": np.zeros((), np.int32)},
        "names": {"MobilenetV2/Conv/weights:0": np.ones((3, 3, 3, 32),
                                                        np.float32),
                  "a/b/c/d": np.arange(4, dtype=np.uint8),
                  "logits/semantic/biases:0": np.zeros(19, np.float32)},
        # 64 KiB of noise: far past max_inline_value_bytes (1 KiB), so the
        # chunk lies in a data file, referenced by (file, offset, length)
        "out_of_line": {"big": rng.standard_normal((128, 128)).astype(
            np.float32), "small": np.ones(2, np.float32)},
        "student": None,
    }


CASES = _cases()


def _params(case):
    if case == "student":
        return jckpt.load_tf_checkpoint(TF1)
    return CASES[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_reads_what_jax_writes(case, tmp_path):
    params = _params(case)
    path = str(tmp_path / "ckpt")
    jckpt.save_orbax(path, params)
    with open(os.path.join(path, orbax.METADATA)) as f:
        assert json.load(f)["use_ocdbt"] is True
    want = jckpt.load_orbax(path)
    _assert_bitwise(orbax.load_orbax(path), want)
    _assert_bitwise(ckpt.load_any(path), want)
    if case == "out_of_line":
        store = ocdbt.Store(path)
        assert isinstance(store._index["big/0.0"], tuple)   # out of line
        assert isinstance(store._index["small/0"], bytes)   # inline


@pytest.mark.parametrize("case", ["float32", "bfloat16", "scalar", "names",
                                  "student"])
def test_jax_reads_what_the_port_writes(case, tmp_path):
    params = _params(case)
    if case == "bfloat16":
        params = {k: v.view(np.uint16).view(zarr2.BFLOAT16)
                  for k, v in params.items()}
    path = str(tmp_path / "ckpt")
    orbax.save_orbax(path, params)
    with open(os.path.join(path, orbax.METADATA)) as f:
        meta = json.load(f)
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    want = {jckpt.strip_suffix(k): np.asarray(v) for k, v in params.items()}
    _assert_bitwise(jckpt.load_orbax(path), want)
    _assert_bitwise(jckpt.load_any(path), want)
    _assert_bitwise(orbax.load_orbax(path), want)
    # force=True: a second save replaces the first, and leaves no sibling
    orbax.save_orbax(path, {"only": np.ones(3, np.float32)})
    assert sorted(jckpt.load_orbax(path)) == ["only"]
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_save_takes_tensors_and_refuses_what_orbax_refuses(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    path = str(tmp_path / "t")
    orbax.save_orbax(path, t)
    got = orbax.load_orbax(path)
    assert np.array_equal(got["w"], t["w"].numpy())
    assert torch.equal(zarr2.bfloat16_to_torch(got["bf"]), t["bf"])
    assert jckpt.load_orbax(path)["bf"].dtype == ml_dtypes.bfloat16
    for bad in ({"e": np.zeros((0, 3), np.float32)}, {"a/../b": np.ones(1)},
                {"": np.ones(1)}):
        with pytest.raises(ValueError):
            orbax.save_orbax(str(tmp_path / "bad"), bad)
    assert sorted(os.listdir(tmp_path)) == ["t"]


def test_committed_fixture_equals_the_tf1_fixture():
    want = ckpt.load_tf_checkpoint(TF1)
    assert len(want) == 272
    got = ckpt.load_any(FIXTURE)
    _assert_bitwise(got, want)
    _assert_bitwise(got, jckpt.load_orbax(FIXTURE))
    with open(os.path.join(FIXTURE, orbax.METADATA)) as f:
        assert json.load(f)["use_ocdbt"] is True
    assert not [n for n in os.listdir(os.path.dirname(FIXTURE))
                if ".orbax-checkpoint-tmp" in n]


def _ts_store(path, config):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + os.path.abspath(path),
                            "config": config}).result()


def _assert_store_matches_tensorstore(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + os.path.abspath(path)}).result()
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    got = ocdbt.Store(path)
    assert list(got) == sorted(want)
    assert {k: got[k] for k in got} == want
    assert all(k in got for k in want) and "k99" not in got


@pytest.mark.parametrize("config", [
    # small nodes and arity 2: interior nodes, version-tree nodes
    {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8,
     "version_tree_arity_log2": 1,
     "compression": {"id": "zstd", "level": 3}},
    # orbax's arity, uncompressed nodes
    {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16,
     "version_tree_arity_log2": 4, "compression": None},
], ids=["zstd_arity2", "raw_arity16"])
def test_ocdbt_reader_matches_tensorstore(config, tmp_path):
    path = str(tmp_path / "store")
    kv = _ts_store(path, config)
    for i in range(45):
        key = b"k%02d/%s" % (i % 13, b"x" * (i % 5))
        kv.write(key, bytes([i]) * (i % 23)).result()
        if i % 7 == 0:        # a deletion is a version too
            gone = b"k%02d/" % ((i + 3) % 13)
            kv.delete_range(ts.KvStore.KeyRange(gone, gone + b"~")).result()
        if i in (0, 1, 15, 16, 17, 44):
            _assert_store_matches_tensorstore(path)


def test_empty_and_missing_stores(tmp_path):
    path = str(tmp_path / "store")
    kv = _ts_store(path, {})
    kv.write(b"a", b"1").result()
    kv.delete_range(ts.KvStore.KeyRange(b"", b"")).result()
    assert dict(ocdbt.Store(path)) == {}
    with pytest.raises(FileNotFoundError):
        ocdbt.Store(str(tmp_path))


def test_zarr_reader_matches_tensorstore_on_a_chunk_grid(tmp_path):
    rng = np.random.default_rng(1)
    full = rng.standard_normal((5, 7)).astype(np.float32)
    for sep, comp, fill in (("/", {"id": "zstd", "level": 1}, 2.5),
                            (".", None, None), (".", None, "NaN")):
        d = str(tmp_path / ("z%s%s" % (sep == "/", fill)))
        arr = ts.open({"driver": "zarr", "kvstore": "file://" + d,
                       "metadata": {"shape": [5, 7], "chunks": [2, 3],
                                    "dtype": "<f4", "compressor": comp,
                                    "fill_value": fill,
                                    "dimension_separator": sep}},
                      create=True).result()
        arr[1:4, 2:6] = full[1:4, 2:6]          # some chunks stay absent
        want = arr.read().result()
        got = zarr2.read_array(d)
        assert np.array_equal(got, want, equal_nan=True)
        assert got.dtype == want.dtype
    with open(os.path.join(d, ".zarray")) as f:
        meta = json.load(f)
    for key, value in (("order", "F"), ("compressor", {"id": "blosc"}),
                       ("filters", [{"id": "delta"}]), ("dtype", ">f4")):
        with open(os.path.join(d, ".zarray"), "w") as f:
            json.dump(dict(meta, **{key: value}), f)
        with pytest.raises(ValueError):
            zarr2.read_array(d)


def test_a_flipped_byte_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    shutil.copytree(FIXTURE, path)
    (root_node,) = os.listdir(os.path.join(path, "d"))
    for name in (os.path.join("d", root_node), "manifest.ocdbt"):
        target = os.path.join(path, name)
        with open(target, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0x10
        with open(target, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(ValueError, match="CRC-32C"):
            orbax.load_orbax(path)
        data[len(data) // 2] ^= 0x10
        with open(target, "wb") as f:
            f.write(bytes(data))
    assert len(orbax.load_orbax(path)) == 272
    with open(os.path.join(path, "manifest.ocdbt"), "r+b") as f:
        f.write(b"\x00")                        # the magic
    with pytest.raises(ValueError, match="magic"):
        orbax.load_orbax(path)


def test_missing_metadata_and_zarr3_raise(tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="empty"):
        orbax.load_orbax(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_any(str(tmp_path / "empty"))
    (tmp_path / "z3").mkdir()
    (tmp_path / "z3" / orbax.METADATA).write_text(json.dumps(
        {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": True}))
    with pytest.raises(ValueError, match="zarr3"):
        orbax.load_orbax(str(tmp_path / "z3"))


def test_without_libzstd_the_port_raises_and_names_it(monkeypatch):
    monkeypatch.setattr(zstd, "_find_library", lambda: None)
    monkeypatch.setattr(zstd, "_LIB", None)
    for call in (zstd.version, lambda: zstd.compress(b"x"),
                 lambda: orbax.load_orbax(FIXTURE)):
        with pytest.raises(RuntimeError, match="libzstd.so.1"):
            call()


def test_zstd_binding_round_trips_and_rejects_corrupt_frames():
    import zstandard

    data = bytes(range(256)) * 300 + b"tail"
    assert zstd.version().count(".") == 2
    c = zstd.compress(data, 1)
    assert zstandard.ZstdDecompressor().decompress(c) == data
    assert zstd.decompress(c) == data
    # a frame that does not state its size goes through the stream API
    blind = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert zstd.decompress(blind) == data
    assert zstd.decompress(blind, len(data)) == data
    for bad in (c[:-9], blind[:-9], b"not zstd"):
        with pytest.raises(ValueError):
            zstd.decompress(bad)


def test_student_config_and_block_names_match_jax():
    assert tstudent.block_names() == jstudent.block_names()
    assert tmodels.block_names is tstudent.block_names
    jf = dataclasses.fields(jstudent.StudentConfig)
    tf = dataclasses.fields(tmodels.StudentConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, t = jstudent.StudentConfig(), tmodels.StudentConfig()
    assert t.num_classes == j.num_classes == 19
    assert t.compute_dtype is torch.float32
    assert np.dtype(j.compute_dtype) == np.float32
    assert dataclasses.is_dataclass(t)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.num_classes = 21
    assert tmodels.StudentConfig(num_classes=21,
                                 compute_dtype=torch.bfloat16).num_classes \
        == jstudent.StudentConfig(num_classes=21).num_classes
