"""Checkpoint IO for flat TF-named parameter dicts (numpy on the host).

Counterpart of ``save_params``, ``load_params``, ``load_any`` and
``merge_restore`` in ``ams_tpu/utils/checkpoint.py``: the reference's
``.npy`` dict snapshots, the ``.npz`` snapshots that
``save_to_frozen_graph`` writes, and ``load_tf_checkpoint`` for the
reference's TF1 checkpoints (``model.index`` + ``model.data-*``), read by
``utils.tf_bundle`` without TensorFlow, and ``save_orbax``/``load_orbax``
for Orbax checkpoint directories, read and written by ``utils.orbax``
without the orbax package.
"""

from __future__ import annotations

import os

from typing import Callable, Mapping, Optional

import numpy as np

from ams_tpu_torch.utils import tf_bundle
from ams_tpu_torch.utils.orbax import load_orbax, save_orbax  # noqa: F401

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


def load_tf_checkpoint(prefix: str) -> dict:
    """Read a TF checkpoint (``prefix.index`` + ``prefix.data-*``) into a
    flat name -> array dict: every tensor the restore filter keeps, under
    TF's name, with TF's dtype, shape and bytes (the JAX package's
    ``load_tf_checkpoint``, which calls TF's reader).  Each tensor is
    checked against its size and CRC-32C (``utils.tf_bundle``)."""
    return tf_bundle.read_bundle(
        str(prefix), keep=lambda name: default_filter(name) is not None)


def load_any(path: str) -> dict:
    """.npy dict, .npz snapshot, TF checkpoint prefix or Orbax directory,
    in the JAX package's ``load_any`` order: the path itself, then
    ``.npy``, then ``.npz`` (each read through the restore filter,
    suffixes stripped), then a TF prefix (``path.index``), then a
    directory through ``load_orbax`` (no filter, suffixes stripped; one
    without ``_METADATA`` raises ``FileNotFoundError``).  Nothing at the
    path raises ``FileNotFoundError``."""
    path = str(path)
    for cand in (path, path + ".npy", path + ".npz"):
        if cand.endswith((".npz", ".npy")) and os.path.exists(cand):
            return load_params(cand)
    if os.path.exists(path + ".index"):
        return load_tf_checkpoint(path)
    if os.path.isdir(path):
        return load_orbax(path)
    raise FileNotFoundError(path)


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
