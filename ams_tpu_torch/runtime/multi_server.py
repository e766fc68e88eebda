"""Multi-video AMS server: concurrent fine-tuning of many edge clients.

Counterpart of ``ams_tpu/runtime/multi_server.py``.  One server process
drives V students: every per-video state (params, Adam slots, masks)
carries a leading V axis, one multi-video round
(``parallel.make_multi_video_round``) trains every video's current window,
and per-video deltas are encoded from the stacked state.  The videos are
split over the mesh's devices; on one card their rounds run one after
another.

Typical use:

    server = MultiVideoServer(video_ids=[25, 22, 12, 17], height=256,
                              batch_size=10, lr=1e-3,
                              strategy="coord_desc_auto")
    server.ingest(video_idx, frames, labels)     # per-video sample arrivals
    losses = server.train_round(iters=200)       # trains ALL videos
    blob = server.encode_delta(video_idx)        # downlink payload per video
    server.deploy(video_idx, path)               # client model snapshot

The server's key is a uint32 (2,) array, as JAX's ``PRNGKey(seed)`` is,
and each round derives from it, with numpy's ``SeedSequence``
(``split_key``), the next key and one ``torch.Generator`` seed per video.
The draws are not ``jax.random``'s, but a ``save_state`` bundle of either
package loads in the other, key included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.convert import (
    masks_from_numpy,
    masks_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.data.buffers import FrameMemory
from ams_tpu_torch.distill.optimizer import adam_init
from ams_tpu_torch.distill.strategies import build_mask, mask_coverage
from ams_tpu_torch.distill.train_step import (
    DistillSpec,
    all_true_mask,
    split_params,
)
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.models.var_order import STATS_ORDER
from ams_tpu_torch.parallel.mesh import make_mesh
from ams_tpu_torch.parallel.sharded import make_multi_video_round, stack_videos
from ams_tpu_torch.runtime import resume as resume_mod
from ams_tpu_torch.stream.codec import encode_delta
from ams_tpu_torch.utils.platform import resolve_device


def prng_key(seed: int) -> np.ndarray:
    """JAX's ``PRNGKey(seed)`` as a uint32 (2,) array: [0, seed mod
    2^32]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split_key(key, n: int):
    """(next key, ``n`` 64-bit generator seeds) from a uint32 (2,) key, by
    numpy's ``SeedSequence``."""
    words = np.random.SeedSequence(
        [int(w) for w in np.asarray(key, np.uint32)]).generate_state(
            2 + 2 * n, np.uint32)
    seeds = [(int(words[2 + 2 * i]) << 32) | int(words[3 + 2 * i])
             for i in range(n)]
    return words[:2].copy(), seeds


class MultiVideoServer:
    """V students trained concurrently on the devices of a mesh.

    Every video must share the model family and total class count; the
    per-video CLASS SUBSET may differ.  The round's class space is the
    union of the subsets, and each video narrows it with a {0,1} class
    mask row (masked classes get -1e9 logits and zero label validity), so
    every video's loss equals what the single-video loop computes with
    ``configs.class_weights(video)``.  The stacked state lives on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    """

    def __init__(self, video_ids: Sequence[int], height: int,
                 batch_size: int, lr: float,
                 strategy: str = "full_model", coord_frac: float = 0.1,
                 memory_capacity: int = 250, compute_dtype: str = "bfloat16",
                 checkpoint: Optional[str] = None, seed: int = 0,
                 mesh=None, device=None):
        self.device = resolve_device(device)
        self.video_ids = list(video_ids)
        self.V = len(self.video_ids)
        self.height = height
        self.lr = lr
        self.strategy = strategy

        n_classes = {exp_configs.num_classes(v) for v in self.video_ids}
        if len(n_classes) != 1:
            raise ValueError("all videos must share the total class count; "
                             "got %s" % sorted(n_classes))
        self.num_classes = n_classes.pop()
        subsets = [set(exp_configs.class_indices(v).tolist())
                   for v in self.video_ids]
        union = sorted(set().union(*subsets))
        self.class_indices = tuple(union)
        self.class_mask_V = torch.tensor(
            [[1.0 if c in s else 0.0 for c in union] for s in subsets],
            dtype=torch.float32, device=self.device)

        if mesh is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" \
                else 1
            mesh = make_mesh(min(self.V, n), device=self.device)
        self.mesh = mesh
        n_dev = self.mesh.devices.size
        if self.V % n_dev:
            raise ValueError(
                "video count (%d) must be a multiple of the mesh size (%d); "
                "pad with duplicate streams or shrink the mesh"
                % (self.V, n_dev))
        self.videos_per_device = self.V // n_dev
        self.spec = DistillSpec(
            iters=1, batch_size=batch_size, num_classes=self.num_classes,
            class_indices=self.class_indices, strategy=strategy,
            coord_frac=coord_frac, compute_dtype=compute_dtype)
        self._round_cache: Dict[tuple, object] = {}

        if checkpoint:
            from ams_tpu_torch.utils import checkpoint as ckpt
            base = params_to_numpy(init_student_params(
                seed, num_classes=self.num_classes, device="cpu"))
            loaded = ckpt.merge_restore(base, ckpt.load_any(checkpoint))
            per_video = [params_from_numpy(loaded, self.device)
                         for _ in range(self.V)]
        else:
            per_video = [init_student_params(seed + i,
                                             num_classes=self.num_classes,
                                             device=self.device)
                         for i in range(self.V)]
        self.params_V = stack_videos(per_video)
        # each video's pretrained snapshot, for restore-before-round (the
        # single-video loop's no_restore=False default, run.py:309-310)
        self._initial_V = dict(self.params_V)
        self.opt_V = stack_videos(
            [adam_init(split_params(p)[0]) for p in per_video])
        # fixed coord strategies carry their masks from construction, as
        # the single-video loop does; auto selects at iteration 0;
        # full_model trains under all-true
        trainable_shapes = {k: tuple(v.shape) for k, v in
                            split_params(per_video[0])[0].items()}
        masks = []
        for i in range(self.V):
            host_mask = build_mask(strategy, coord_frac, trainable_shapes,
                                   rng=np.random.RandomState(seed + i))
            masks.append(all_true_mask(per_video[i]) if host_mask is None
                         else masks_from_numpy(host_mask, self.device))
        if host_mask is not None:
            total, sel = mask_coverage(masks_to_numpy(masks[0]))
            print("Using %s mode, Training %.3f%% of variables"
                  % (strategy, 100 * sel / total))
        self.mask_V = stack_videos(masks)
        self.memories: List[FrameMemory] = [
            FrameMemory(memory_capacity, height, height * 2)
            for _ in range(self.V)]
        self._rng = prng_key(seed)
        self.last_losses: Optional[np.ndarray] = None

    # ----------------------------------------------------------- data

    def ingest(self, video_idx: int, frames, labels) -> None:
        """Append uplink samples for one video."""
        self.memories[video_idx].extend(frames, labels)

    # ------------------------------------------------------- training

    def _round_fn(self, iters: int, reselect: Optional[bool] = None):
        key = (iters, reselect)
        if key not in self._round_cache:
            spec = dataclasses.replace(self.spec, iters=iters)
            self._round_cache[key] = make_multi_video_round(
                spec, self.mesh, reselect=reselect, with_class_mask=True)
        return self._round_cache[key]

    def _video_device(self, video_idx: int) -> torch.device:
        return self.mesh.device_list()[video_idx // self.videos_per_device]

    def train_round(self, iters: int, keep_mask: bool = False,
                    no_restore: bool = True) -> np.ndarray:
        """One distillation round for EVERY video; the (V, iters) losses.

        ``keep_mask=True`` (coord_desc_auto) reuses the previous round's
        per-video parameter subsets instead of reselecting at iteration 0.
        ``no_restore=False`` resets every video to its pretrained weights
        before training (the single-video loop's default; the Adam slots
        persist through the reset, as in the reference's filtered
        restore).
        """
        if not no_restore:
            self.restore_initial()
        bufs = [m.stacked() for m in self.memories]
        # the joint round trains all V; an empty memory would train on
        # nothing, so it refuses (the single-video server skips the event)
        empty = [i for i, b in enumerate(bufs) if len(b[0]) == 0]
        if empty:
            raise ValueError(
                "train_round with empty frame memory for video indices %s "
                "— ingest samples for every video before training" % empty)
        devs = [self._video_device(i) for i in range(self.V)]
        # the live rows only: the draws stay below n_valid, so JAX's
        # padding to capacity changes nothing
        frames_V = [torch.from_numpy(b[0]).to(d) for b, d in zip(bufs, devs)]
        labels_V = [torch.from_numpy(b[1]).to(d) for b, d in zip(bufs, devs)]
        n_valid_V = [len(b[0]) for b in bufs]
        self._rng, seeds = split_key(self._rng, self.V)
        gens_V = [torch.Generator(device=d).manual_seed(s)
                  for d, s in zip(devs, seeds)]
        reselect = None if not keep_mask else False
        round_fn = self._round_fn(iters, reselect)
        self.params_V, self.opt_V, self.mask_V, losses = round_fn(
            self.params_V, self.opt_V, frames_V, labels_V, n_valid_V, gens_V,
            self.lr, self.mask_V, self.class_mask_V)
        self.last_losses = losses.cpu().numpy()
        return self.last_losses

    def restore_initial(self, video_idx: Optional[int] = None) -> None:
        """Reset one (or all) videos to their OWN pretrained weights
        (optimizer slots persist, like the reference's filtered restore)."""
        if video_idx is None:
            self.params_V = dict(self._initial_V)
            return
        params = {k: v.clone() for k, v in self.params_V.items()}
        for k, v in params.items():
            v[video_idx] = self._initial_V[k][video_idx]
        self.params_V = params

    # ------------------------------------------------------- downlink

    def video_params(self, video_idx: int) -> Dict[str, np.ndarray]:
        return params_to_numpy({k: v[video_idx]
                                for k, v in self.params_V.items()})

    def video_mask(self, video_idx: int) -> Dict[str, np.ndarray]:
        return masks_to_numpy({k: v[video_idx]
                               for k, v in self.mask_V.items()})

    def encode_delta(self, video_idx: int, *, stats_annex: bool = True
                     ) -> bytes:
        params = self.video_params(video_idx)
        masks = self.video_mask(video_idx) \
            if self.strategy.startswith("coord_desc_") else None
        # coord deltas ship the BN moving-stats annex like the other delta
        # producers: the stats advance every round but the mask covers
        # only trainables
        stats = None
        if stats_annex and self.strategy != "full_model":
            stats = {k: params[k] for k in STATS_ORDER if k in params}
        return encode_delta(params, masks, strategy=self.strategy,
                            stats=stats)

    def deploy(self, video_idx: int, path: str, fold: bool = True) -> None:
        """Write one video's deployable client artifact as ``path +
        ".npz"`` (BN-folded by default, like
        SemanticNetwork.save_to_frozen_graph)."""
        params = self.video_params(video_idx)
        if fold:
            from ams_tpu_torch.models.frozen import fold_student

            params = params_to_numpy(fold_student(params))
        np.savez(path + ".npz", **params)

    # ------------------------------------------------------- resume

    def save_state(self, prefix: str) -> None:
        """Persist the whole V-video server state (params, Adam slots,
        masks, frame memories, key) atomically as ``prefix +
        "_mv_resume.npz"``, in the JAX package's bundle keys."""
        arrays: dict = {"video_ids": np.asarray(self.video_ids, np.int64),
                        "height": np.int64(self.height),
                        "rng": np.asarray(self._rng, np.uint32)}
        resume_mod.pack_params(arrays, params_to_numpy(self.params_V))
        resume_mod.pack_adam(arrays, self.opt_V)
        resume_mod.pack_params(arrays, masks_to_numpy(self.mask_V),
                               prefix="mask:")
        for i, m in enumerate(self.memories):
            fbuf, lbuf = m.stacked()  # live rows only, no padded capacity
            arrays["mem%d:frames" % i] = fbuf
            arrays["mem%d:labels" % i] = lbuf
        resume_mod.write_bundle(prefix + "_mv_resume.npz", arrays)

    def load_state(self, prefix: str) -> bool:
        """Restore a save_state bundle; returns False if none exists, raises
        ValueError if the bundle doesn't match this server's configuration."""
        path = prefix + "_mv_resume.npz"
        if not os.path.exists(path):
            return False
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        saved_ids = [int(v) for v in arrays["video_ids"]]
        if saved_ids != list(self.video_ids) or \
                int(arrays["height"]) != self.height:
            raise ValueError(
                "resume bundle %s was saved for video_ids=%s height=%d; "
                "this server has video_ids=%s height=%d"
                % (path, saved_ids, int(arrays["height"]),
                   list(self.video_ids), self.height))
        params = resume_mod.unpack_params(arrays)
        if set(params) != set(self.params_V):
            raise ValueError("resume bundle %s parameter inventory does not "
                             "match this server's model" % path)
        self.params_V = params_from_numpy(params, self.device)
        self.opt_V = resume_mod.unpack_adam(arrays, device=self.device)
        self.mask_V = masks_from_numpy(
            resume_mod.unpack_params(arrays, "mask:"), self.device)
        for i, mem in enumerate(self.memories):
            mem.clear()
            frames = arrays["mem%d:frames" % i]
            labels = arrays["mem%d:labels" % i]
            if len(frames):
                mem.extend(list(frames), list(labels))
        self._rng = np.asarray(arrays["rng"], np.uint32)
        return True
