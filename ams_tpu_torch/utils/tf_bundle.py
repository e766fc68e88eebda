"""Read a TensorFlow checkpoint (``prefix.index`` + ``prefix.data-*``)
without TensorFlow.

The JAX package reads the reference's TF1 checkpoints through TF's own
reader (``ams_tpu/utils/checkpoint.py::load_tf_checkpoint``); the card
machine has no TensorFlow, so the port reads the tensor-bundle format
itself, with numpy:

- ``prefix.index`` is a LevelDB-style table: data blocks of
  prefix-compressed keys with restart points, each block followed by a
  5-byte trailer (compression type, masked CRC-32C), and a 48-byte footer
  that holds the metaindex and index block handles and ends in the magic
  ``0xdb4775248b80fb57``.  TF's ``BundleWriter`` writes it uncompressed.
- Key ``""`` holds a ``BundleHeaderProto`` (shard count, endianness); every
  other key is a tensor name whose value is a ``BundleEntryProto`` (dtype,
  shape, shard, offset, size, masked CRC-32C of the bytes, slices).
- ``prefix.data-%05d-of-%05d`` holds the tensors' bytes, little-endian; a
  ``DT_STRING`` tensor is its elements' varint lengths, the masked CRC-32C
  of those lengths as 4-byte words, then the bytes.  Its entry's CRC-32C
  runs over the lengths as 4-byte words, that checksum and the bytes.

Every entry read is checked against its size and its CRC-32C, so a
truncated or corrupt file raises ``ValueError`` and never loads quietly.
Compressed blocks, big-endian bundles, partitioned (sliced) variables and
dtypes numpy lacks raise.  The protobufs are decoded by a small varint
reader: no protobuf dependency.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xdb4775248b80fb57
FOOTER_LEN = 48
BLOCK_TRAILER_LEN = 5

# types.proto DataType -> numpy, little-endian
DTYPES = {
    1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
    4: np.dtype("u1"), 5: np.dtype("<i2"), 6: np.dtype("i1"),
    8: np.dtype("<c8"), 9: np.dtype("<i8"), 10: np.dtype("?"),
    17: np.dtype("<u2"), 18: np.dtype("<c16"), 19: np.dtype("<f2"),
    22: np.dtype("<u4"), 23: np.dtype("<u8"),
}
DT_STRING = 7


# --- CRC-32C (Castagnoli), as TF's crc32c with its mask -------------------

def _crc_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78),
                         table >> 1).astype(np.uint32)
    return table


_T = _crc_table()
_T_LIST = _T.tolist()


def _step_bytes(reg: int, data) -> int:
    """The raw CRC register after feeding ``data`` one byte at a time."""
    for b in data:
        reg = _T_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _gf2_apply(cols: np.ndarray, v: int) -> int:
    """The 32x32 GF(2) matrix with columns ``cols`` times the vector v."""
    bits = (v >> np.arange(32, dtype=np.uint64)) & 1
    return int(np.bitwise_xor.reduce(np.where(bits.astype(bool), cols,
                                              np.uint32(0))))


def _gf2_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([_gf2_apply(a, int(c)) for c in b], np.uint32)


@functools.lru_cache(maxsize=64)
def _zeros_tables(n: int) -> Tuple[Tuple[int, ...], ...]:
    """Four 256-entry tables whose XOR over the register's bytes gives the
    register after n zero bytes (the linear map, by squaring the one-byte
    map)."""
    one = np.array([_step_bytes(1 << k, (0,)) for k in range(32)], np.uint32)
    result = np.array([1 << k for k in range(32)], np.uint32)  # identity
    power = one
    while n:
        if n & 1:
            result = _gf2_mul(power, result)
        power = _gf2_mul(power, power)
        n >>= 1
    byte = np.arange(256)
    tables = []
    for k in range(4):
        t = np.zeros(256, np.uint32)
        for bit in range(8):
            t ^= np.where((byte >> bit) & 1, result[8 * k + bit],
                          np.uint32(0)).astype(np.uint32)
        tables.append(tuple(t.tolist()))
    return tuple(tables)


def crc32c(data) -> int:
    """CRC-32C of a bytes-like object.  The bulk is fed as many equal
    chunks side by side (one numpy step per byte of a chunk), and the
    chunks' registers are then chained through the zero-bytes map."""
    a = np.frombuffer(data, np.uint8)
    n = a.size
    # chunks of a power of two near sqrt(n) bytes: few distinct maps to
    # build, and about as many numpy steps as chained registers
    span = 1 << max(int(np.sqrt(n)).bit_length() - 1, 0)
    lanes = n // span
    reg = 0xFFFFFFFF
    if span >= 16:
        body = np.ascontiguousarray(a[:lanes * span].reshape(lanes, span).T)
        c = np.zeros(lanes, np.uint32)
        for row in body:
            c = _T[(c ^ row) & 0xFF] ^ (c >> 8)
        t0, t1, t2, t3 = _zeros_tables(span)
        for ci in c.tolist():
            reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF]
                   ^ t2[(reg >> 16) & 0xFF] ^ t3[reg >> 24]) ^ ci
        a = a[lanes * span:]
    return _step_bytes(reg, a.tolist()) ^ 0xFFFFFFFF


def masked_crc32c(data) -> int:
    """TF's stored form of a CRC-32C (``crc32c::Mask``)."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


# --- varints and protobuf fields -------------------------------------------

def _varint(buf, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(buf) -> Iterator[Tuple[int, object]]:
    """(field number, value) of a protobuf message: an int for varint and
    fixed fields, the bytes of a length-delimited one."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value = bytes(buf[pos:pos + n])
            pos += n
        elif wire == 5:
            value = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError("unsupported protobuf wire type %d" % wire)
        if pos > len(buf):
            raise ValueError("truncated protobuf field %d" % field)
        yield field, value


_ENTRY_INTS = {3: "shard_id", 4: "offset", 5: "size", 6: "crc32c"}


def _entry(value: bytes) -> dict:
    """A BundleEntryProto as a dict."""
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": 0, "sliced": False}
    for field, v in _fields(value):
        if field == 1:
            e["dtype"] = v
        elif field == 2:                       # TensorShapeProto
            for f2, dim in _fields(v):
                if f2 == 2:                    # Dim
                    e["shape"].append(
                        next((s for f3, s in _fields(dim) if f3 == 1), 0))
                elif f2 == 3 and dim:
                    raise ValueError("tensor of unknown rank")
        elif field in _ENTRY_INTS:
            e[_ENTRY_INTS[field]] = v
        elif field == 7:
            e["sliced"] = True
    return e


# --- the table -----------------------------------------------------------

def _block(data: bytes, handle: Tuple[int, int], what: str) -> bytes:
    off, size = handle
    end = off + size + BLOCK_TRAILER_LEN
    if end > len(data):
        raise ValueError("%s block runs past the end of the index file"
                         % what)
    contents = data[off:off + size]
    kind = data[off + size]
    if kind != 0:
        raise ValueError("compressed %s block (type %d): TF's BundleWriter "
                         "writes none" % (what, kind))
    want = int.from_bytes(data[off + size + 1:end], "little")
    if masked_crc32c(data[off:off + size + 1]) != want:
        raise ValueError("%s block fails its CRC-32C" % what)
    return contents


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise ValueError("index block too short")
    n_restarts = int.from_bytes(block[-4:], "little")
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError("index block's restart array is corrupt")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > end:
            raise ValueError("corrupt index block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _handle(buf, pos: int = 0) -> Tuple[Tuple[int, int], int]:
    off, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (off, size), pos


def read_index(prefix: str) -> Tuple[dict, List[Tuple[str, dict]]]:
    """-> (header {"num_shards", "endianness"}, [(name, entry)] in key
    order) of ``prefix.index``."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    if len(data) < FOOTER_LEN:
        raise ValueError("%s.index is too short for a table" % prefix)
    footer = data[-FOOTER_LEN:]
    if int.from_bytes(footer[-8:], "little") != TABLE_MAGIC:
        raise ValueError("%s.index is not a TF table (bad magic)" % prefix)
    _, pos = _handle(footer)                  # metaindex: unused
    index_handle, _ = _handle(footer, pos)
    header = {"num_shards": 1, "endianness": 0}
    entries = []
    for _, value in _block_entries(_block(data, index_handle, "index")):
        for key, v in _block_entries(_block(data, _handle(value)[0],
                                            "data")):
            if key == b"":
                for field, x in _fields(v):
                    if field == 1:
                        header["num_shards"] = x
                    elif field == 2:
                        header["endianness"] = x
                continue
            entries.append((key.decode("utf-8", "surrogateescape"),
                            _entry(v)))
    if header["endianness"] != 0:
        raise ValueError("big-endian tensor bundle: not supported")
    return header, entries


def _strings(raw: bytes, count: int, name: str) -> Tuple[List[bytes], bytes]:
    """-> (the elements, the bytes TF's CRC-32C runs over)."""
    pos, lengths = 0, []
    for _ in range(count):
        n, pos = _varint(raw, pos)
        lengths.append(n)
    if any(n > 0xFFFFFFFF for n in lengths):
        raise ValueError("string tensor %r has an element of 4 GiB or more"
                         % name)
    words = np.asarray(lengths, "<u4").tobytes()
    checksum = raw[pos:pos + 4]
    if int.from_bytes(checksum, "little") != masked_crc32c(words):
        raise ValueError("string tensor %r: its lengths fail their CRC-32C"
                         % name)
    pos += 4
    out = []
    for n in lengths:
        out.append(raw[pos:pos + n])
        pos += n
    if pos != len(raw):
        raise ValueError("string tensor %r: %d bytes for %d" % (
            name, len(raw), pos))
    return out, words + raw[pos - sum(lengths) - 4:]


def _read_entry(f, name: str, e: dict):
    f.seek(e["offset"])
    shape = tuple(int(d) for d in e["shape"])
    if e["dtype"] == DT_STRING:
        raw = f.read(e["size"])
        if len(raw) != e["size"]:
            raise ValueError("tensor %r is truncated: %d of %d bytes"
                             % (name, len(raw), e["size"]))
        out = raw
    else:
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError("tensor %r has TF dtype %d, which the reader "
                             "does not take" % (name, e["dtype"]))
        out = np.empty(shape, dtype)
        if out.nbytes != e["size"]:
            raise ValueError("tensor %r: %d bytes on disk for shape %s of "
                             "%s" % (name, e["size"], shape, dtype))
        raw = memoryview(out.reshape(-1).view(np.uint8))
        got = f.readinto(raw)
        if got != e["size"]:
            raise ValueError("tensor %r is truncated: %d of %d bytes"
                             % (name, got, e["size"]))
    if e["dtype"] == DT_STRING:
        strings, raw = _strings(out, int(np.prod(shape, dtype=np.int64)),
                                name)
    if masked_crc32c(raw) != e["crc32c"]:
        raise ValueError("tensor %r fails its CRC-32C: the data file is "
                         "corrupt" % name)
    if e["dtype"] != DT_STRING:
        return out
    if not shape:
        return np.asarray(strings[0])
    return np.array(strings, dtype=object).reshape(shape)


def read_bundle(prefix: str,
                keep: Optional[Callable[[str], bool]] = None
                ) -> Dict[str, np.ndarray]:
    """Every tensor of the bundle at ``prefix`` for which ``keep(name)``
    holds (all if None), as numpy arrays under TF's names; a scalar string
    is a 0-d bytes array, as ``np.asarray`` of TF's reader gives."""
    header, entries = read_index(prefix)
    entries = [(n, e) for n, e in entries if keep is None or keep(n)]
    for name, e in entries:
        if e["sliced"] or name.startswith("\x00"):
            raise NotImplementedError(
                "tensor %r is partitioned (a sliced entry): the reader "
                "takes whole tensors only" % (name,))
    out = {}
    files = {}
    try:
        for name, e in entries:
            shard = e["shard_id"]
            if not 0 <= shard < header["num_shards"]:
                raise ValueError("tensor %r names shard %d of %d"
                                 % (name, shard, header["num_shards"]))
            if shard not in files:
                files[shard] = open("%s.data-%05d-of-%05d" % (
                    prefix, shard, header["num_shards"]), "rb")
            out[name] = _read_entry(files[shard], name, e)
    finally:
        for f in files.values():
            f.close()
    return out
