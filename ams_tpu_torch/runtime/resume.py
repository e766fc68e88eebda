"""Mid-run experiment resume.

Counterpart of ``ams_tpu/runtime/resume.py`` (the reference has none:
experiments restart from scratch after any failure).  After every training
event the server persists a resume bundle: student params, Adam slots, the
frame/label memory, the bandwidth logs and controller state.
``train_model(cfg with resume=True, ...)`` fast-forwards the video to the
saved second and continues from the last completed event.

The bundle captures state at event granularity: the partly filled bucket
since the last send tick and the ASR observation window are not kept, so
a resumed run's sampling may differ from an uninterrupted one by up to one
send period of samples.

The bundle is two files (npz + meta json), each written atomically; a
crash between the two writes leaves a mismatched pair, which
``load_state`` detects through a shared update_count token and refuses.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ams_tpu_torch.convert import adam_state_from_numpy, adam_state_to_numpy


def _state_paths(prefix: str):
    return prefix + "_resume_state.npz", prefix + "_resume_meta.json"


def pack_adam(arrays: dict, opt) -> None:
    """Encode an AdamState into a flat npz dict (opt:/optm:/optv: keys)."""
    step, m, v = adam_state_to_numpy(opt)
    arrays["opt:step"] = np.asarray(step)
    for k, x in m.items():
        arrays["optm:" + k] = x
    for k, x in v.items():
        arrays["optv:" + k] = x


def unpack_adam(arrays: dict, device=None):
    """The AdamState of a bundle on ``device`` (default cuda)."""
    m = {k[len("optm:"):]: v for k, v in arrays.items()
         if k.startswith("optm:")}
    v = {k[len("optv:"):]: x for k, x in arrays.items()
         if k.startswith("optv:")}
    return adam_state_from_numpy(arrays["opt:step"], m, v, device=device)


def pack_params(arrays: dict, params, prefix: str = "param:") -> None:
    for k, v in params.items():
        arrays[prefix + k] = np.asarray(v)


def unpack_params(arrays: dict, prefix: str = "param:"):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def write_bundle(path: str, arrays: dict) -> None:
    """Atomic npz write (tmp + rename)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_state(prefix: str, *, network, memory, second: float, send_rate,
               sample_per_period, up_bw, down_bw, model_save_times,
               save_range, trained_seconds, update_count,
               atr_state: Optional[dict] = None,
               up_codec_exact=()) -> None:
    npz_path, meta_path = _state_paths(prefix)
    arrays: dict = {}
    pack_params(arrays, network.get_vars())
    pack_adam(arrays, network.opt_state)
    frames_n, labels_n = memory.stacked()
    arrays["mem:frames"] = frames_n
    arrays["mem:labels"] = labels_n
    # the same token goes into BOTH files: load_state compares them
    arrays["meta:update_count"] = np.int64(update_count)
    write_bundle(npz_path, arrays)
    meta = {"second": float(second), "send_rate": float(send_rate),
            "sample_per_period": list(map(float, sample_per_period)),
            "up_bw": list(map(float, up_bw)),
            "up_codec_exact": list(map(bool, up_codec_exact)),
            "down_bw": list(map(float, down_bw)),
            "model_save_times": list(map(float, model_save_times)),
            "save_range": list(map(int, save_range)),
            "trained_seconds": sorted(int(s) for s in trained_seconds),
            "update_count": int(update_count),
            "atr": atr_state}
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(meta_path + ".tmp", meta_path)


def load_state(prefix: str):
    """Returns (arrays dict, meta dict), or None if no bundle exists."""
    npz_path, meta_path = _state_paths(prefix)
    if not (os.path.exists(npz_path) and os.path.exists(meta_path)):
        return None
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_path) as f:
        meta = json.load(f)
    token = arrays.pop("meta:update_count", None)
    if token is not None and int(token) != int(meta["update_count"]):
        raise RuntimeError(
            "torn resume bundle: npz is from update %d but meta from %d — "
            "the writer crashed between the two files; delete %s/%s to "
            "restart from scratch" % (int(token), int(meta["update_count"]),
                                      npz_path, meta_path))
    return arrays, meta


def restore_network(network, arrays) -> None:
    """Overlay params + Adam slots from a resume bundle onto a network."""
    network.restore(unpack_params(arrays))
    network.opt_state = unpack_adam(arrays, device=network.device)


def restore_memory(memory, arrays) -> None:
    frames = arrays["mem:frames"]
    labels = arrays["mem:labels"]
    memory.clear()
    memory.extend(list(frames), list(labels))
