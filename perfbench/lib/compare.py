"""The numbers that decide ``correct``.

Training: by the worst leaf, the gap between the program's norm of a
leaf and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf (some gradients are all but zero).  Serving:
the widest gap by which a served id's reference logit lies below the
reference's best.
"""

from __future__ import annotations

import statistics

import torch


def leaf_norm_gaps(prog: dict, ref: dict, keys) -> dict:
    """{k: | |prog[k]| - |ref[k]| | / max(|ref[k]|, median over keys of
    |ref[.]|)} over ``keys``."""
    keys = list(keys)
    ref_n = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    prog_n = {k: float(torch.linalg.vector_norm(prog[k].double()))
              for k in keys}
    median = statistics.median(ref_n.values())
    out = {}
    for k in keys:
        den = max(ref_n[k], median)
        gap = abs(prog_n[k] - ref_n[k])
        out[k] = gap / den if den > 0 else (0.0 if gap == 0
                                            else float("inf"))
    return out


def leaf_norm_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap (``leaf_norm_gaps``)."""
    return max(leaf_norm_gaps(prog, ref, keys).values())


def median_leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The median over the leaves of their gaps (``leaf_norm_gaps``)."""
    return statistics.median(leaf_norm_gaps(prog, ref, keys).values())


def served_gap(ref_logits: torch.Tensor, ids: torch.Tensor) -> float:
    """Widest ref_logits.max(class) - ref_logits[served id] over the
    pixels; (B, C, H, W) logits, (B, H, W) ids.  An id outside [0, C) is
    an infinite gap."""
    c = ref_logits.shape[1]
    ids = ids.to(ref_logits.device).long()
    if bool(((ids < 0) | (ids >= c)).any()):
        return float("inf")
    got = ref_logits.gather(1, ids[:, None]).squeeze(1)
    return float((ref_logits.amax(dim=1) - got).amax())
