"""A read-only reader of OCDBT key-value stores, the layout in which
Orbax writes a checkpoint by default (``use_ocdbt``).

OCDBT ("optionally-cooperative distributed B+tree") is TensorStore's
kvstore format: a manifest names the versions of the store, each version
is the root of a B+tree, and the tree's leaves hold each key's value
inline or as a (data file, offset, length) reference.  This module follows
the "Format" section of TensorStore's OCDBT documentation, field for
field, and reads it with numpy-free Python:

* every file starts ``magic (u32 big-endian) | length (u64) | version
  (varint, 0) | compression (varint: 0 none, 1 zstd)``, then the body,
  then the CRC-32C of all that precedes it (u32);
* the manifest (``manifest.ocdbt``, magic ``0cdb3a2a``) holds the store's
  config, a data-file table and the newest versions inline, and refers to
  version-tree nodes (magic ``0cdb1234``) for the older ones;
* B+tree nodes (magic ``0cdb20de``) sit at an offset of a data file
  (``d/<hash>``), each with its own data-file table; keys are
  prefix-compressed, and an interior entry's subtree stores its keys
  without the prefix that all of them share.

Data-file paths are relative to the store's directory: each table entry
is ``base_path + relative_path``, and the base path is itself relative to
the base path of the file that holds the table, which is how the root of
a store that Orbax merged from ``ocdbt.process_N/`` stores reaches their
``d/`` files.  Magic, version, length and checksum mismatches raise
``ValueError`` naming the file.
"""

from __future__ import annotations

import os
import struct
from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

from ams_tpu_torch.utils import zstd
from ams_tpu_torch.utils.tf_bundle import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE

MANIFEST_NAME = "manifest.ocdbt"

# the offset and length of an empty tree's root (all ones, as a varint)
_NO_NODE = (1 << 64) - 1


class _Reader:
    """Cursor over a decoded body; every read past the end raises."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise ValueError("%s: truncated (%d bytes wanted at %d of %d)"
                             % (self.what, n, self.pos, len(self.buf)))

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError("%s: varint longer than 64 bits" % self.what)

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError("%s: %d bytes left over after the last field"
                             % (self.what, len(self.buf) - self.pos))


def decode_envelope(data: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT file or node: header, length and CRC-32C
    checked, zstd undone."""
    if len(data) < 18:
        raise ValueError("%s: %d bytes is too short for an OCDBT header"
                         % (what, len(data)))
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError("%s: magic %08x, expected %08x" % (what, got, magic))
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError("%s: header says %d bytes, holds %d"
                         % (what, length, len(data)))
    want = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != want:
        raise ValueError("%s: CRC-32C mismatch" % what)
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError("%s: format version %d, expected 0" % (what, version))
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError("%s: unknown compression format %d" % (what, compression))


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """(base path, path in the store) of each data file a body refers to;
    ``base`` is the base path of the file that holds the body."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base_len[i] > prefix[i] + suffix[i]:
            raise ValueError("%s: bad data file table entry %d" % (r.what, i))
        full = prev[:prefix[i]] + r.take(suffix[i])
        prev = full
        file_base = base + full[:base_len[i]].decode()
        out.append((file_base, base + full.decode()))
    return out


def _file_ref(table, i: int, what: str) -> Tuple[str, str]:
    if i >= len(table):
        raise ValueError("%s: data file id %d of %d" % (what, i, len(table)))
    return table[i]


class Store(Mapping):
    """The newest version of the OCDBT store at ``path``, as a mapping of
    key (``str``) to value (``bytes``).  Opening reads the manifest and
    every B+tree node; values are read when asked for."""

    def __init__(self, path: str):
        self.path = str(path)
        self._files: Dict[str, bytes] = {}
        manifest = os.path.join(self.path, MANIFEST_NAME)
        if not os.path.isfile(manifest):
            raise FileNotFoundError("%s: no %s" % (self.path, MANIFEST_NAME))
        root = self._read_manifest(manifest)
        # key -> inline bytes, or (file, offset, length)
        self._index: Dict[str, object] = {}
        if root is not None:
            self._walk(root, b"")

    # --- files ------------------------------------------------------------
    def _file(self, rel: str) -> bytes:
        data = self._files.get(rel)
        if data is None:
            full = os.path.join(self.path, *rel.split("/"))
            if not os.path.isfile(full):
                raise ValueError("%s: data file %s is missing"
                                 % (self.path, rel))
            with open(full, "rb") as f:
                data = self._files[rel] = f.read()
        return data

    def _slice(self, rel: str, offset: int, length: int) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise ValueError("%s: [%d, %d) lies past the end of %s (%d bytes)"
                             % (self.path, offset, offset + length, rel,
                                len(data)))
        return data[offset:offset + length]

    # --- manifest ---------------------------------------------------------
    def _read_manifest(self, name: str):
        with open(name, "rb") as f:
            data = f.read()
        r = _Reader(decode_envelope(data, MANIFEST_MAGIC, name), name)
        r.take(16)                                   # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError("%s: manifest kind %d (numbered manifests) is "
                             "not read; Orbax writes a single manifest"
                             % (name, kind))
        r.varint()                                   # max_inline_value_bytes
        r.varint()                                   # max_decoded_node_bytes
        r.u8()                                       # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.take(4)                                # zstd level (int32)
        elif method != 0:
            raise ValueError("%s: unknown compression method %d"
                             % (name, method))
        table = _data_file_table(r, "")
        versions = self._versions(r, table)
        self._version_nodes(r, table)
        r.end()
        if not versions:
            return None
        newest = max(versions, key=lambda v: v[0])
        return newest[1]

    @staticmethod
    def _versions(r: _Reader, table) -> List[Tuple[int, tuple]]:
        """(generation, root) of each version the manifest lists; the root
        is (height, file, offset, length), or None for an empty tree (an
        empty path and all-ones offset and length)."""
        n = r.varint()
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                             # statistics
        for _ in range(n):
            r.u64()                                  # commit time
        out = []
        for i in range(n):
            if ln[i] in (0, _NO_NODE):
                out.append((gen[i], None))
            else:
                out.append((gen[i], (height[i],
                                     _file_ref(table, fid[i], r.what),
                                     off[i], ln[i])))
        return out

    @staticmethod
    def _version_nodes(r: _Reader, table) -> None:
        """Skip the references to version-tree nodes: they hold only
        versions older than the manifest's own, the newest of which is
        the store's current root."""
        n = r.varint()
        r.varints(n)                                 # generation
        for i in r.varints(n):                       # file id
            _file_ref(table, i, r.what)
        r.varints(2 * n)                             # offset, length
        r.varints(n)                                 # num_generations
        for _ in range(n):
            r.u64()                                  # commit time
        r.take(n)                                    # height

    # --- B+tree -----------------------------------------------------------
    def _node(self, ref):
        """The node that ``ref`` = (height, (base, file), offset, length)
        names: its body's cursor past the data-file table, and the table."""
        height, (base, rel), offset, length = ref
        what = "%s: B+tree node at %s+%d" % (self.path, rel, offset)
        r = _Reader(decode_envelope(self._slice(rel, offset, length),
                                    BTREE_MAGIC, what), what)
        got = r.u8()
        if got != height:
            raise ValueError("%s: height %d, expected %d"
                             % (what, got, height))
        return r, _data_file_table(r, base)

    @staticmethod
    def _keys(r: _Reader, n: int, common: bool):
        prefix = [0] + r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        shared = r.varints(n) if common else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise ValueError("%s: key %d shares %d bytes of a %d-byte key"
                                 % (r.what, i, prefix[i], len(prev)))
            prev = prev[:prefix[i]] + r.take(suffix[i])
            keys.append(prev)
        return keys, shared

    def _walk(self, ref, prefix: bytes) -> None:
        r, table = self._node(ref)
        height = ref[0]
        n = r.varint()
        if height == 0:
            keys, _ = self._keys(r, n, common=False)
            lengths = r.varints(n)
            kinds = r.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError("%s: unknown value kind" % r.what)
            indirect = [i for i in range(n) if kinds[i] == 1]
            fids = r.varints(len(indirect))
            offs = r.varints(len(indirect))
            where = dict(zip(indirect, zip(fids, offs)))
            for i, key in enumerate(keys):
                name = (prefix + key).decode()
                if kinds[i] == 0:
                    self._index[name] = r.take(lengths[i])
                else:
                    fid, off = where[i]
                    _, rel = _file_ref(table, fid, r.what)
                    self._index[name] = (rel, off, lengths[i])
            r.end()
            return
        keys, shared = self._keys(r, n, common=True)
        fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)                             # statistics
        r.end()
        for i, key in enumerate(keys):
            if shared[i] > len(key):
                raise ValueError("%s: subtree prefix %d of a %d-byte key"
                                 % (r.what, shared[i], len(key)))
            self._walk((height - 1, _file_ref(table, fid[i], r.what),
                        off[i], ln[i]), prefix + key[:shared[i]])

    # --- Mapping ----------------------------------------------------------
    def __getitem__(self, key: str) -> bytes:
        v = self._index[key]
        if isinstance(v, bytes):
            return v
        return self._slice(*v)

    def __contains__(self, key) -> bool:
        return key in self._index

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._index))

    def __len__(self) -> int:
        return len(self._index)

