"""The port's native delta codec (``ams_tpu_torch/native``) against
ams_tpu's, on the CPU.

Both packages build ``codec.cpp`` with ``g++ -lz`` (the port into
``build/ams_tpu_torch/``); the payloads must be equal byte for byte, the
gzip header's OS byte included: ``encode_delta``'s default on the float16,
int8 and int8d wires, with and without the stats annex, and the native
functions on JAX's fp16 edge cases and on f64 values (one rounding step).
When the library cannot be built, ``encode_delta`` falls back to the
Python path with one warning per process, as JAX's does.
"""

import gzip
import warnings

import numpy as np
import pytest
import torch

from ams_tpu.native import codec as jnative
from ams_tpu.stream import codec as jcodec
from ams_tpu.models.var_order import TRAINABLE_ORDER

from ams_tpu_torch.native import build as tbuild
from ams_tpu_torch.native import codec as tnative
from ams_tpu_torch.stream import codec as tcodec


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def delta():
    rng = np.random.RandomState(5)
    shapes = {TRAINABLE_ORDER[0]: (3, 3, 3, 32), TRAINABLE_ORDER[1]: (32,),
              TRAINABLE_ORDER[2]: (32,), TRAINABLE_ORDER[3]: (3, 3, 32, 1)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    moved = {k: v + 0.01 * rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    masks = {k: rng.rand(*s) < 0.3 for k, s in shapes.items()}
    stats = {"MobilenetV2/Conv/BatchNorm/moving_mean":
             rng.randn(32).astype(np.float32),
             "MobilenetV2/Conv/BatchNorm/moving_variance":
             rng.rand(32).astype(np.float32)}
    return params, moved, masks, stats


def test_native_builds_outside_the_package(delta):
    info = tbuild.build()
    assert info["path"].startswith(str(tbuild.BUILD_DIR))
    assert tbuild.library_path().exists()
    assert tnative.library() is tnative.library()


@pytest.mark.parametrize("wire", ["float16", "int8", "int8d"])
@pytest.mark.parametrize("annex", [False, True])
def test_payloads_equal_jax_native_byte_for_byte(wire, annex, delta):
    params, moved, masks, stats = delta
    kw = dict(strategy="coord_desc_auto", wire_dtype=wire,
              stats=stats if annex else None,
              base=params if wire == "int8d" else None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no fallback
        ours = tcodec.encode_delta(moved, masks, **kw)
    assert ours == jcodec.encode_delta(moved, masks, use_native=True, **kw)
    python = tcodec.encode_delta(moved, masks, use_native=False, **kw)
    assert gzip.decompress(ours) == gzip.decompress(python)
    assert ours[9] == 3 and python[9] == 255        # the gzip OS byte


def test_native_functions_match_jax():
    rng = np.random.RandomState(2)
    masks = [rng.rand(64, 3) > 0.4, rng.rand(1000) > 0.8]
    values = [(rng.randn(*m.shape) * 10).astype(np.float32) for m in masks]
    raw = jcodec.pack_payload(masks, values)
    ours = tnative.encode_delta_native(masks, values, tail=b"annex")
    assert ours == jnative.encode_delta_native(masks, values, tail=b"annex")
    assert gzip.decompress(ours) == raw + b"annex"
    assert tnative.gzip9(raw) == jnative.gzip9(raw)
    assert gzip.decompress(tnative.gzip9(raw)) == raw


@pytest.mark.parametrize("sizes", [(1,), (13, 0, 7), (9, 1000, 3)])
def test_native_packs_sizes_off_the_byte_grid(sizes):
    """Variables whose sizes are no multiple of 8 (and empty ones): the
    last mask byte of each is partial, as np.packbits pads it."""
    rng = np.random.RandomState(len(sizes))
    masks = [rng.rand(n) > 0.5 for n in sizes]
    values = [rng.randn(n).astype(np.float32) for n in sizes]
    ours = tnative.encode_delta_native(masks, values, tail=b"t")
    assert ours == jnative.encode_delta_native(masks, values, tail=b"t")
    assert gzip.decompress(ours) == \
        jcodec.pack_payload(masks, values) + b"t"


def test_native_fp16_edge_cases():
    vals = np.array([0.0, -0.0, 1.0, -1.0, 65504.0, 65520.0, 1e-8, -1e-8,
                     np.inf, -np.inf, np.nan, 3.14159, 6.1e-5, 5.9e-8],
                    dtype=np.float32)
    masks = [np.ones(vals.shape, bool)]
    blob = tnative.encode_delta_native(masks, [vals])
    assert blob == jnative.encode_delta_native(masks, [vals])
    raw = gzip.decompress(blob)
    nbytes = (vals.size + 7) // 8
    got = np.frombuffer(raw, np.float16, offset=nbytes)
    np.testing.assert_array_equal(got.tobytes(),
                                  vals.astype(np.float16).tobytes())


def test_native_single_rounding_for_f64():
    rng = np.random.RandomState(13)
    vals = np.concatenate([
        np.float64([1.0009765625 + 2 ** -13 + 2 ** -30]),  # f16 tie + eps
        rng.randn(511) * rng.choice([1e-3, 1.0, 1e3], 511)])
    mask = np.ones(vals.shape, bool)
    blob = tnative.encode_delta_native([mask], [vals])
    assert blob == jnative.encode_delta_native([mask], [vals])
    assert gzip.decompress(blob) == tcodec.pack_payload([mask], [vals])


def test_native_fallback_warns_once_per_process(monkeypatch, delta):
    """A failed build is correctness-preserving (the Python path is the
    oracle) but never silent: one warning per process."""
    params, moved, masks, _ = delta

    def no_compiler():
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(tcodec, "_warned_native_fallback", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "build", no_compiler)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a = tcodec.encode_delta(moved, masks, strategy="coord_desc_auto")
        b = tcodec.encode_delta(moved, masks, strategy="coord_desc_auto",
                                wire_dtype="int8")
    msgs = [x for x in w if "native delta codec" in str(x.message)]
    assert len(msgs) == 1
    assert a == tcodec.encode_delta(moved, masks, strategy="coord_desc_auto",
                                    use_native=False)
    assert b == jcodec.encode_delta(moved, masks, strategy="coord_desc_auto",
                                    wire_dtype="int8", use_native=False)
