"""Checkpoint IO for flat TF-named parameter dicts (numpy on the host).

Counterpart of ``save_params``, ``load_params`` and ``merge_restore`` in
``ams_tpu/utils/checkpoint.py``: the reference's ``.npy`` dict snapshots,
plus the ``.npz`` snapshots that ``save_to_frozen_graph`` writes.  The TF1
checkpoint reader and Orbax come in a later slice of the port.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np

# Name fragments excluded when restoring weights, mirroring
# SemanticNetwork.OPT_FILTER / OP_FILTER (reference SemanticNetwork.py:25-26):
# optimizer slots and graph-plumbing variables never ship in a checkpoint.
OPT_FILTER = ("Adam", "Momentum")
OP_FILTER = ("image_cache", "global_step")


def default_filter(name: str) -> Optional[str]:
    """Reference restore filter (SemanticNetwork.py:154-156)."""
    clean = name[:-2] if name.endswith(":0") else name
    if any(k in clean for k in OPT_FILTER) or clean in OP_FILTER:
        return None
    return name


def strip_suffix(name: str) -> str:
    return name[:-2] if name.endswith(":0") else name


def save_params(path: str, params: Mapping[str, np.ndarray]) -> None:
    """Save a flat name->array dict as a reference-compatible .npy dict."""
    host = {k: np.asarray(v) for k, v in params.items()}
    np.save(path, host, allow_pickle=True)


def load_params(path: str,
                name_filter: Callable[[str], Optional[str]] = default_filter,
                ) -> dict:
    """Load a .npy dict or .npz checkpoint; keys normalized to suffix-less
    names."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
    else:
        raw = np.load(path, allow_pickle=True).item()
    out = {}
    for k, v in raw.items():
        if name_filter is not None and name_filter(k) is None:
            continue
        out[strip_suffix(k)] = np.asarray(v)
    return out


def merge_restore(params: dict, restored: Mapping[str, np.ndarray]) -> dict:
    """Overlay ``restored`` values onto ``params`` (restore_vars semantics).

    Keys present in the checkpoint but absent from the model are ignored
    after filtering, as in SaveHelper.restore_vars.
    """
    out = dict(params)
    matched = 0
    for k, v in restored.items():
        k = strip_suffix(k)
        if k in out:
            v = np.asarray(v)
            if tuple(v.shape) != tuple(np.shape(out[k])):
                raise ValueError(
                    f"shape mismatch for {k}: ckpt {v.shape} vs model "
                    f"{np.shape(out[k])}")
            out[k] = v
            matched += 1
    if restored and not matched:
        # a checkpoint whose keys match NOTHING is the wrong checkpoint
        # (e.g. a student .npy passed as the teacher): returning the base
        # unchanged would silently run on random init
        sample = sorted(restored)[:3]
        raise ValueError(
            "checkpoint matches none of the model's %d variables "
            "(checkpoint keys look like %s) — wrong checkpoint?"
            % (len(out), sample))
    if restored and matched < len(out):
        # every call site restores a FULL snapshot; a partial overlay
        # (e.g. scope-name drift for a subset of layers) leaves the rest
        # at random init — plausible-looking garbage with no signal
        restored_keys = {strip_suffix(k) for k in restored}
        missing = sorted(k for k in out if k not in restored_keys)
        print("WARNING: checkpoint covers %d/%d model variables; %d keep "
              "their initialization (e.g. %s)"
              % (matched, len(out), len(missing), missing[:3]), flush=True)
    return out
