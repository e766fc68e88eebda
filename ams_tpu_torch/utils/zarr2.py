"""One zarr v2 array at a time: the per-array layout of an Orbax
checkpoint (``.zarray`` metadata plus chunk keys under the array's name).

``read_array`` takes its keys from a directory (the per-array layout) or
from a mapping of key to bytes (an OCDBT store, ``utils.ocdbt.Store``),
under a key prefix.  It covers what an Orbax checkpoint of numpy arrays
holds: C order, chunks compressed with zstd or stored raw, no filters,
``fill_value`` for absent chunks, 0-d arrays, and the dtypes
``<f2 <f4 <f8 |i1 <i2 <i4 <i8 |u1 <u2 <u4 <u8 |b1`` and ``bfloat16``.
numpy has no bfloat16, so a bfloat16 array is read into ``BFLOAT16``, a
structured dtype over the raw 16 bits: ``bfloat16_to_torch`` makes the
``torch.bfloat16`` tensor, and numpy arithmetic refuses it rather than
taking the bits for integers.  ``encode_array`` writes what Orbax writes:
one chunk of the whole array, zstd at level 1.
"""

from __future__ import annotations

import json
import math
import os
from collections.abc import Mapping
from typing import Dict, Union

import numpy as np
import torch

from ams_tpu_torch.utils import zstd

BFLOAT16 = np.dtype([("bfloat16", "<u2")])

_KINDS = "biuf"


def bfloat16_to_torch(a: np.ndarray) -> torch.Tensor:
    """A ``BFLOAT16`` array as a ``torch.bfloat16`` tensor, bit for bit."""
    bits = np.ascontiguousarray(a).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def bfloat16_from_torch(t: torch.Tensor) -> np.ndarray:
    """A ``torch.bfloat16`` tensor as a ``BFLOAT16`` array, bit for bit."""
    bits = t.detach().cpu().contiguous().view(torch.int16).numpy()
    return bits.view(np.uint16).copy().view(BFLOAT16)


def _dtype(name: str, where: str) -> np.dtype:
    if name == "bfloat16":
        return BFLOAT16
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError("%s: unknown dtype %r" % (where, name)) from None
    if dt.kind not in _KINDS or dt.byteorder == ">" or dt.fields:
        raise ValueError("%s: dtype %r is not read" % (where, name))
    return dt


def _dtype_name(dt: np.dtype) -> str:
    if dt == BFLOAT16:
        return "bfloat16"
    if dt.kind not in _KINDS:
        raise ValueError("zarr: dtype %s is not written" % dt)
    return dt.newbyteorder("<").str if dt.itemsize > 1 else dt.str


def _fill(meta: dict, dt: np.dtype, where: str):
    fv = meta.get("fill_value")
    if fv is None:
        return 0
    if dt == BFLOAT16:
        raise ValueError("%s: a bfloat16 fill_value is not read" % where)
    if isinstance(fv, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if fv not in named or dt.kind != "f":
            raise ValueError("%s: fill_value %r" % (where, fv))
        return named[fv]
    return fv


class _Directory:
    """The files under a directory, keyed by their '/'-joined paths."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *key.split("/"))

    def __getitem__(self, key: str) -> bytes:
        path = self._path(key)
        if not os.path.isfile(path):
            raise KeyError(key)
        with open(path, "rb") as f:
            return f.read()

    def __contains__(self, key) -> bool:
        return os.path.isfile(self._path(key))


Source = Union[str, Mapping]


def _source(source: Source):
    return _Directory(str(source)) if isinstance(source, (str, os.PathLike)) \
        else source


def read_array(source: Source, prefix: str = "") -> np.ndarray:
    """The array whose keys are ``prefix + ".zarray"`` and ``prefix`` +
    each chunk's key, in ``source`` (a directory or a mapping)."""
    src = _source(source)
    where = "%s%s" % ((str(source) + ":") if isinstance(source, str) else "",
                      prefix + ".zarray")
    try:
        meta = json.loads(src[prefix + ".zarray"])
    except KeyError:
        raise FileNotFoundError(where) from None
    if meta.get("zarr_format") != 2:
        raise ValueError("%s: zarr_format %r, expected 2"
                         % (where, meta.get("zarr_format")))
    if meta.get("order", "C") != "C":
        raise ValueError("%s: order %r; only C order is read"
                         % (where, meta.get("order")))
    if meta.get("filters"):
        raise ValueError("%s: filters %r are not read" % (where,
                                                          meta["filters"]))
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError("%s: compressor %r; only zstd or none is read"
                         % (where, comp.get("id")))
    dt = _dtype(meta["dtype"], where)
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError("%s: chunks %r for shape %r" % (where, chunks, shape))
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta, dt, where)
    out = np.zeros(shape, dt) if dt == BFLOAT16 else np.full(shape, fill, dt)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    for idx in np.ndindex(*grid):
        key = prefix + (sep.join(str(i) for i in idx) if idx else "0")
        if key not in src:
            continue
        raw = src[key]
        if comp is not None:
            raw = zstd.decompress(raw, chunk_bytes)
        if len(raw) != chunk_bytes:
            raise ValueError("%s: chunk %s holds %d bytes, expected %d"
                             % (where, key, len(raw), chunk_bytes))
        block = np.frombuffer(raw, dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def encode_array(a, level: int = 1) -> Dict[str, bytes]:
    """``{".zarray": ..., chunk key: ...}`` for ``a`` (a numpy array or a
    tensor) as one chunk, zstd-compressed at ``level``: Orbax's layout."""
    if isinstance(a, torch.Tensor):
        a = bfloat16_from_torch(a) if a.dtype == torch.bfloat16 \
            else a.detach().cpu().numpy()
    a = np.asarray(a)
    if a.size == 0:
        raise ValueError("zarr: cannot write an array of zero size %s"
                         % (a.shape,))
    if a.dtype != BFLOAT16 and a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    meta = {"chunks": list(a.shape), "compressor": {"id": "zstd",
                                                    "level": int(level)},
            "dimension_separator": ".", "dtype": _dtype_name(a.dtype),
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}
    key = ".".join("0" for _ in a.shape) or "0"
    body = zstd.compress(np.ascontiguousarray(a).tobytes(), level)
    return {".zarray": json.dumps(meta, separators=(",", ":")).encode(),
            key: body}


def write_array(directory: str, a, level: int = 1) -> None:
    """``encode_array``'s keys as files under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    for key, data in encode_array(a, level).items():
        with open(os.path.join(directory, key), "wb") as f:
            f.write(data)
