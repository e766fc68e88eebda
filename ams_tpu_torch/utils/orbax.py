"""Orbax checkpoints of flat parameter dicts, without the orbax package.

Counterpart of ``save_orbax`` and ``load_orbax`` in
``ams_tpu/utils/checkpoint.py``, which call orbax's
``PyTreeCheckpointer``.  An Orbax checkpoint is a directory:

* ``_METADATA`` (JSON) names each entry of the tree (``tree_metadata``)
  and says where the arrays are: in one OCDBT store at the directory's
  root (``"use_ocdbt": true``, orbax's default; ``utils.ocdbt``), or in
  one zarr directory per array (``"use_ocdbt": false``);
* each array is a zarr v2 array (``"use_zarr3": false``; ``utils.zarr2``)
  under its name, whose ``/`` make nested keys;
* ``_CHECKPOINT_METADATA`` (JSON) records the handler and the times.

``load_orbax`` reads both layouts.  ``save_orbax`` writes the per-array
layout, zstd level 1, which orbax's ``load_orbax`` restores to the same
arrays; the port does not write OCDBT.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, Mapping

import numpy as np

from ams_tpu_torch.utils import ocdbt, zarr2

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
            "PyTreeCheckpointHandler")
# the value types that hold one array; orbax restores a "scalar" as a
# Python number, which numpy then holds at its default width
_VALUE_TYPES = ("np.ndarray", "jax.Array", "scalar")


def _strip_suffix(name: str) -> str:
    return name[:-2] if name.endswith(":0") else name


def _entries(meta: dict, where: str):
    """(name, value type) of each leaf of a flat dict's tree."""
    out = []
    for entry in meta.get("tree_metadata", {}).values():
        keys = entry.get("key_metadata", [])
        if len(keys) != 1:
            raise ValueError("%s: a nested tree (%r) is not a flat "
                             "parameter dict" % (where, keys))
        vtype = entry.get("value_metadata", {}).get("value_type")
        if vtype not in _VALUE_TYPES:
            raise ValueError("%s: %r holds a %r, not an array"
                             % (where, keys[0].get("key"), vtype))
        out.append((str(keys[0]["key"]), vtype))
    return out


def load_orbax(path: str) -> Dict[str, np.ndarray]:
    """``{name: array}`` of the Orbax checkpoint at ``path``, names without
    their ``:0`` suffix and no restore filter, as the JAX package's
    ``load_orbax``.  Without ``_METADATA`` it raises ``FileNotFoundError``;
    a zarr3 checkpoint raises ``ValueError``."""
    path = os.path.abspath(str(path))
    meta_path = os.path.join(path, METADATA)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError("%s: not an Orbax checkpoint (no %s)"
                                % (path, METADATA))
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError("%s: a zarr3 checkpoint; only zarr v2 is read"
                         % path)
    source = ocdbt.Store(path) if meta.get("use_ocdbt") else path
    out = {}
    for name, vtype in _entries(meta, meta_path):
        a = zarr2.read_array(source, name + "/")
        if vtype == "scalar":
            a = np.asarray(a.item())
        out[_strip_suffix(name)] = a
    return out


def _check_name(name: str) -> None:
    parts = name.split("/")
    if not name or any(p in ("", ".", "..") for p in parts) \
            or parts[-1] in (METADATA, CHECKPOINT_METADATA):
        raise ValueError("cannot write an array named %r into an Orbax "
                         "checkpoint" % name)


def save_orbax(path: str, params: Mapping) -> None:
    """Write ``params`` (arrays or tensors) as an Orbax checkpoint at
    ``path``, replacing what is there, as the JAX package's ``save_orbax``
    (``force=True``).  The directory is built beside ``path`` and moved
    into place whole."""
    path = os.path.abspath(str(path))
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    names = sorted(params)
    for name in names:
        _check_name(name)
    start = time.time_ns()
    tmp = tempfile.mkdtemp(dir=parent, prefix=os.path.basename(path)
                           + ".orbax-checkpoint-tmp-")
    try:
        os.chmod(tmp, 0o755)
        tree = {}
        for name in names:
            zarr2.write_array(os.path.join(tmp, *name.split("/")),
                              params[name])
            tree[str((name,))] = {
                "key_metadata": [{"key": name, "key_type": 2}],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": tree, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": start,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        old = None
        if os.path.isdir(path):
            old = tempfile.mkdtemp(dir=parent, prefix=os.path.basename(path)
                                   + ".orbax-checkpoint-old-")
            os.replace(path, os.path.join(old, "c"))
        elif os.path.lexists(path):
            os.remove(path)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
