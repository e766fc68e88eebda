"""Model-delta wire codec (the downlink payload), numpy/zlib path.

Counterpart of ``ams_tpu/stream/codec.py``, byte-compatible with it and with
the reference's format (run.py:316-333):

    [ for each var in order: packbits(mask.flatten()) ]       # bitmask section
    [ for each var in order: params[mask].astype(fp16) ]      # values section
    -> DEFLATE (gzip -9)

plus the opt-in ``int8`` and ``int8d`` wires and the stats annex.  Variable
order is the TF collection order in ``ams_tpu_torch.models.var_order``.
The codec runs on the host in numpy, as the JAX package's does.  The native
C++ encoder of ``ams_tpu/native`` is a later slice: ``use_native=True``
raises here rather than falling back.
"""

from __future__ import annotations

import gzip
import io
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ams_tpu_torch.models.var_order import (
    SAVEABLE_ORDER,
    STATS_ORDER,
    TRAINABLE_ORDER,
)

# Stats-annex magic (wire extension; current header version 2 = magic +
# u8 version + u32 var count + u32 CRC32 of the newline-joined var names;
# v1 lacked the CRC and is still accepted at decode).  The reference's
# coord-descent payload cannot reconstruct the deployed model: BN moving
# statistics advance during training (control-dep updates are never
# masked/reverted) but curr_mask iterates only grad_masks_pl — the
# trainables (SemanticNetwork.py:290-294) — so a real delta consumer would
# run the new weights against STALE normalizer stats (measured: 73% pixel
# agreement with the deploy after one synthetic-init round).  full_model
# payloads don't have the gap (save_vars includes the stats, all-ones
# masks).  The annex appends the fp16 moving stats after the reference-
# compatible sections, inside the same gzip stream; decode auto-detects
# it, and payloads without it remain byte-identical to the reference.
# Wire cost at the real student (33,088 stats values in 108 tensors):
# +51.8 KB ≈ +9.6% on a coord@10% payload (538 KB -> 590 KB gzip'd).
STATS_MAGIC = b"AMSB"

def delta_order(strategy: str, present=None) -> List[str]:
    """Canonical wire order for a strategy's delta payload (the ONLY place
    this rule lives): coord-descent strategies ship trainable vars in
    grad_masks_pl order; full_model ships every saveable var.  ``present``
    optionally filters to keys that exist in a given param dict."""
    order = list(SAVEABLE_ORDER) if strategy == "full_model" \
        else list(TRAINABLE_ORDER)
    if present is not None:
        present = set(present)
        order = [n for n in order if n in present]
    return order


def pack_payload(masks: Sequence[np.ndarray],
                 values: Sequence[np.ndarray],
                 wire_dtype: str = "float16",
                 base: Optional[Sequence[np.ndarray]] = None) -> bytes:
    """Raw (pre-compression) payload from per-var masks + masked params.

    wire_dtype "float16" is the reference-compatible format.  "int8" is an
    opt-in extension the reference lacks: per-var symmetric quantization
    (one f32 scale + int8 values per var), halving the values section —
    downlink bandwidth is AMS's headline cost.  "int8d" quantizes
    ``value - base`` instead of the raw value (``base`` required, in wire
    order): with restore-mode training every round's delta is relative to
    the INITIAL checkpoint — which the client holds as its re-basing
    snapshot — so both ends share the base and the quantization range
    shrinks from max|weight| to max|param movement| (measured ~20x finer
    steps on a real round, tools/probe_int8_delta.py / PERFORMANCE.md).
    Both ends must agree on the dtype (the live runtime negotiates it in
    the hello).
    """
    if wire_dtype == "int8d" and base is None:
        raise ValueError("wire_dtype 'int8d' requires the base snapshot")
    buf = io.BytesIO()
    for m in masks:
        buf.write(np.packbits(np.asarray(m, bool).reshape(-1)).tobytes())
    for i, (m, v) in enumerate(zip(masks, values)):
        v = np.asarray(v)
        if v.shape != np.asarray(m).shape:
            # a real wire-integrity check, not a debug assert: under
            # python -O a stale/mismatched mask would silently mis-slice
            # every subsequent var on the client
            raise ValueError("mask shape %s != value shape %s"
                             % (np.shape(m), v.shape))
        picked = v[np.asarray(m, bool)]
        if wire_dtype == "float16":
            # single cast from the source dtype: an f32 intermediate would
            # double-round f64 params and change wire bytes vs the
            # reference's direct astype(np.float16) (run.py:330)
            buf.write(picked.astype(np.float16).tobytes())
        elif wire_dtype in ("int8", "int8d"):
            picked = picked.astype(np.float32)
            if wire_dtype == "int8d":
                b = np.asarray(base[i])
                if b.shape != v.shape:
                    raise ValueError("base shape %s != value shape %s"
                                     % (b.shape, v.shape))
                picked = picked - b[np.asarray(m, bool)].astype(np.float32)
            maxabs = float(np.max(np.abs(picked))) if picked.size else 0.0
            if not np.isfinite(maxabs):
                # a NaN/Inf parameter (diverged round) would make the scale
                # non-finite and silently corrupt the whole payload — the
                # quantized bytes round-trip to garbage without any error
                raise ValueError(
                    "non-finite parameter values in %s delta "
                    "(max|v|=%r); refusing to quantize"
                    % (wire_dtype, maxabs))
            scale = maxabs / 127.0
            buf.write(np.float32(scale).tobytes())
            if picked.size:
                q = np.clip(np.round(picked / scale) if scale else picked,
                            -127, 127).astype(np.int8)
                buf.write(q.tobytes())
        else:
            raise ValueError("unknown wire_dtype %r" % wire_dtype)
    return buf.getvalue()


def _stats_inventory_crc(names: Sequence[str]) -> int:
    import zlib
    return zlib.crc32("\n".join(names).encode()) & 0xFFFFFFFF


def pack_stats_annex(stats: Dict[str, np.ndarray]) -> bytes:
    """Stats-annex section: magic + version + var count + CRC32 of the
    newline-joined var names + fp16 dense values for every STATS_ORDER var
    present in ``stats`` (dense — the stats have no mask; they always all
    advance).  Both ends derive the var list from var_order; the count AND
    the name-list CRC are on the wire, so an inventory mismatch fails
    loudly at decode even when the counts happen to agree (a count-only
    check would silently hand one var's bytes to a different var).

    Values must be finite and inside fp16 range: the annex is a wire
    extension with no reference-parity constraint, and a NaN/inf (or
    >65504 overflowing to inf) moving statistic would silently corrupt the
    client's normalizers — same policy as the int8 branch above."""
    names = [n for n in STATS_ORDER if n in stats]
    buf = io.BytesIO()
    buf.write(STATS_MAGIC)
    buf.write(np.uint8(2).tobytes())
    buf.write(np.uint32(len(names)).tobytes())
    buf.write(np.uint32(_stats_inventory_crc(names)).tobytes())
    fp16_max = float(np.finfo(np.float16).max)
    for n in names:
        # no f32 intermediate: same single-cast rule as pack_payload —
        # f64 stats must round f64->f16 once, not f64->f32->f16
        v = np.asarray(stats[n])
        maxabs = float(np.max(np.abs(v))) if v.size else 0.0
        if not np.isfinite(maxabs) or maxabs > fp16_max:
            raise ValueError(
                "moving statistic %r has non-finite or fp16-overflowing "
                "values (max|v|=%r); refusing to ship a corrupt stats "
                "annex" % (n, maxabs))
        buf.write(v.astype(np.float16).tobytes())
    return buf.getvalue()


def encode_delta(params: Dict[str, np.ndarray],
                 masks: Optional[Dict[str, np.ndarray]],
                 strategy: str = "full_model",
                 use_native: bool = False,
                 wire_dtype: str = "float16",
                 stats: Optional[Dict[str, np.ndarray]] = None,
                 base: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Gzip'd downlink payload for one training round.

    params: post-round parameter dict (flat TF names).
    masks: bool dict over trainable params (None -> all-ones, full_model).
    wire_dtype: "float16" (reference format), "int8", or "int8d"
        (delta-vs-base quantization; requires ``base`` — see pack_payload).
    stats: optional BN moving statistics to append as the stats annex
        (see STATS_MAGIC above) — without them a coord-descent delta
        cannot reconstruct the deployed model.  None (default) keeps the
        payload byte-identical to the reference wire.
    base: the initial-checkpoint snapshot both ends hold (int8d only).
    use_native: must stay False; the native encoder is not ported yet.
    """
    if use_native:
        raise NotImplementedError(
            "the native C++ delta encoder (ams_tpu/native) is not ported "
            "yet; use use_native=False (same bytes)")
    order = delta_order(strategy, present=params)
    if wire_dtype == "int8d":
        if base is None:
            raise ValueError("wire_dtype 'int8d' requires the base "
                             "snapshot")
        base_list = [np.asarray(base[n]) for n in order]
    else:
        base_list = None
    mask_list, value_list = [], []
    for name in order:
        v = np.asarray(params[name])
        m = None if masks is None else masks.get(name)
        m = np.ones(v.shape, bool) if m is None else np.asarray(m, bool)
        if m.shape != v.shape:
            raise ValueError("mask/param shape mismatch for %s: %s vs %s"
                             % (name, m.shape, v.shape))
        mask_list.append(m)
        value_list.append(v)
    if stats is not None and strategy == "full_model":
        raise ValueError(
            "full_model payloads already carry the moving statistics "
            "(SAVEABLE_ORDER); the stats annex is for coord strategies")
    tail = b"" if stats is None else pack_stats_annex(stats)
    raw = pack_payload(mask_list, value_list, wire_dtype=wire_dtype,
                       base=base_list) + tail
    buf = io.BytesIO()
    # mtime=0 keeps payloads deterministic (gzip -9 parity is about size,
    # not the header timestamp).
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=9, mtime=0) as f:
        f.write(raw)
    return buf.getvalue()


def decode_delta(blob: bytes,
                 shapes: Dict[str, Tuple[int, ...]],
                 strategy: str = "full_model",
                 wire_dtype: str = "float16",
                 base: Optional[Dict[str, np.ndarray]] = None,
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Inverse of encode_delta -> (masks, sparse values per var).

    Returns masks and, for each var, the masked values (fp16, or
    dequantized f32 for the int8/int8d wires) scattered into a dense
    array (unmasked entries are 0); use ``apply_delta`` to overlay onto a
    parameter dict.  For "int8d" the wire carries value-minus-base, so
    ``base`` (the client's initial-checkpoint snapshot) is required and
    the returned values are already re-absolutized (base + delta) —
    apply_delta works unchanged.
    """
    if wire_dtype == "int8d" and base is None:
        raise ValueError("wire_dtype 'int8d' requires the base snapshot")
    raw = gzip.decompress(blob)
    order = delta_order(strategy, present=shapes)
    off = 0
    masks = {}
    for name in order:
        shape = shapes[name]
        n = int(np.prod(shape))
        nbytes = (n + 7) // 8
        bits = np.frombuffer(raw, np.uint8, count=nbytes, offset=off)
        masks[name] = np.unpackbits(bits)[:n].astype(bool).reshape(shape)
        off += nbytes
    values = {}
    for name in order:
        m = masks[name]
        cnt = int(m.sum())
        if wire_dtype == "float16":
            vals = np.frombuffer(raw, np.float16, count=cnt, offset=off)
            off += cnt * 2
            dense = np.zeros(m.shape, np.float16)
        elif wire_dtype in ("int8", "int8d"):
            scale = float(np.frombuffer(raw, np.float32, count=1,
                                        offset=off)[0])
            off += 4
            q = np.frombuffer(raw, np.int8, count=cnt, offset=off)
            off += cnt
            vals = q.astype(np.float32) * scale
            if wire_dtype == "int8d":
                b = np.asarray(base[name])
                if b.shape != m.shape:
                    raise ValueError("base shape %s != wire shape %s for %s"
                                     % (b.shape, m.shape, name))
                vals = b[m].astype(np.float32) + vals
            dense = np.zeros(m.shape, np.float32)
        else:
            raise ValueError("unknown wire_dtype %r" % wire_dtype)
        dense[m] = vals
        values[name] = dense
    if off < len(raw) and raw[off:off + 4] == STATS_MAGIC:
        # stats annex (wire extension): dense fp16 moving statistics, in
        # STATS_ORDER.  Returned as all-ones-masked dense vars so
        # apply_delta overlays them like any other section.
        off += 4
        if off + 5 > len(raw):
            # keep the decoder's error contract: truncation raises
            # ValueError like every other corruption, never IndexError
            raise ValueError("truncated stats annex header")
        version = raw[off]
        off += 1
        if version not in (1, 2):
            raise ValueError("unknown stats annex version %d" % version)
        count = int(np.frombuffer(raw, np.uint32, count=1, offset=off)[0])
        off += 4
        names = [n for n in STATS_ORDER if n in shapes]
        if count != len(names):
            raise ValueError(
                "stats annex var count %d != decoder's %d — encoder and "
                "decoder disagree on the moving-statistics inventory"
                % (count, len(names)))
        if version >= 2:
            # v2 adds a CRC32 of the name list; v1 payloads (persisted
            # artifacts from earlier rounds) stay decodable with the
            # count-only check
            if off + 4 > len(raw):
                raise ValueError("truncated stats annex header")
            crc = int(np.frombuffer(raw, np.uint32, count=1, offset=off)[0])
            off += 4
            if crc != _stats_inventory_crc(names):
                raise ValueError(
                    "stats annex inventory CRC mismatch — encoder and "
                    "decoder agree on the count (%d) but not the var names; "
                    "refusing to assign one statistic's bytes to another "
                    "var" % count)
        for name in names:
            n = int(np.prod(shapes[name]))
            vals = np.frombuffer(raw, np.float16, count=n, offset=off)
            off += n * 2
            masks[name] = np.ones(shapes[name], bool)
            values[name] = vals.reshape(shapes[name]).copy()
    if off != len(raw):
        raise ValueError("trailing bytes in delta payload: %d" %
                         (len(raw) - off))
    return masks, values


def apply_delta(params: Dict[str, np.ndarray],
                masks: Dict[str, np.ndarray],
                values: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Client-side update: overwrite masked entries with the fp16 values
    (cast up to the param dtype), as the edge device would."""
    out = dict(params)
    for name, m in masks.items():
        if name not in out:
            continue
        p = np.array(out[name])
        p[m] = values[name][m].astype(p.dtype)
        out[name] = p
    return out


def payload_bits(blob: bytes) -> int:
    """Downlink size accounting (run.py:333: bytes * 8)."""
    return len(blob) * 8
