"""Multi-device training and labeling, in PyTorch.

Counterpart of ``ams_tpu/parallel/sharded.py``, with its names and
signatures; the ``rng`` arguments are ``torch.Generator``s.

1. **The minibatch-parallel round** (``make_sharded_distill_round``): one
   student's round over the ranks of a ``torch.distributed`` process
   group, one process per rank.  Every rank draws the same global
   minibatch and trains on its contiguous share of the rows; BN moments,
   the loss and the gradients are summed over the ranks
   (``parallel.collectives``), so the result is the single-device round's
   to rounding, and parameters, Adam slots and the ``coord_desc_auto``
   selection stay the same on every rank.  JAX's round also partitions the
   activation width over the mesh's ``model`` axis (GSPMD halo exchanges);
   the port refuses that (ROADMAP A6), and has no counterpart of the JAX
   round's ``.lower`` AOT hook (ROADMAP C).

2. **The multi-video round** (``make_multi_video_round``): V independent
   students, one per edge client.  The per-video state carries a leading V
   axis (``stack_videos``); the videos are split in contiguous blocks over
   the mesh's devices, as JAX's ``P(axes)`` splits the leading axis, and
   each device runs its videos' whole rounds one after another, one host
   thread per device.  On one card that is all V, serially.

``make_vmapped_multi_video_round`` has the same signature and computes the
same per-video results serially on the inputs' device: JAX's ``vmap`` over
per-video weights has no counterpart here (ROADMAP C).  Teacher labeling
splits the frame batch over the mesh's devices (``make_sharded_labeler``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from ams_tpu_torch.distill.train_step import DistillSpec, make_distill_round
from ams_tpu_torch.models.layers import as_dtype
from ams_tpu_torch.parallel.collectives import SumReducer
from ams_tpu_torch.parallel.mesh import Mesh


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of dicts and NamedTuples (the
    parameter, mask and ``AdamState`` trees)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[_tree_map(fn, *xs) for xs in zip(*trees)])
    return fn(*trees)


def stack_videos(pytrees):
    """Stack per-video trees (dicts of tensors, ``AdamState``s) along a
    new leading axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *pytrees)


def _video(tree, j, device):
    """Video ``j``'s slice of a stacked tree, on ``device``."""
    return _tree_map(lambda x: x[j].to(device), tree)


def _device_context(device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _per_device(devices, fn):
    """[fn(i) for each device index], one host thread per device when
    there are several; every thread's exception is raised here."""
    if len(devices) == 1:
        return [fn(0)]
    with ThreadPoolExecutor(len(devices)) as pool:
        futures = [pool.submit(fn, i) for i in range(len(devices))]
        return [f.result() for f in futures]


def make_sharded_distill_round(spec: DistillSpec, mesh_or_group=None,
                               data_axis: str = "data",
                               model_axis: str = "model"):
    """This rank's part of one student's minibatch-parallel round.

    ``mesh_or_group``: a ``torch.distributed`` process group, or None or a
    ``Mesh`` for the default group (``init_multi_host``).  A ``Mesh`` has
    no model axis above 1 (width partitioning is not ported).
    Returns the round of ``make_distill_round``:
    fn(params, opt, frames_buf, labels_buf, n_valid, rng, lr, mask,
    reselect=True, class_mask=None, idx_seq=None), with ``batch_size`` the
    GLOBAL minibatch, which must divide over the ranks (``ValueError``).
    Every rank passes the same params, Adam state, buffers and draws: a
    generator seeded alike on every rank, or the same ``idx_seq``.
    """
    group = None if isinstance(mesh_or_group, Mesh) else mesh_or_group
    spec = dataclasses.replace(spec, batch_axis=data_axis)
    return make_distill_round(spec, reduce=SumReducer(group))


def _video_rounds(bases, devices, reselect, with_class_mask):
    """The multi-video round over ``devices`` (None: each video stays on
    the device its state is on), with one round function per device."""

    def fn(params_V, opt_V, frames_V, labels_V, n_valid_V, gens_V, lr,
           mask_V, class_mask_V=None):
        if with_class_mask != (class_mask_V is not None):
            raise ValueError("the round was built with with_class_mask=%s"
                             % with_class_mask)
        V = len(frames_V)
        if V % len(devices):
            raise ValueError("video count (%d) must be a multiple of the "
                             "mesh size (%d)" % (V, len(devices)))
        per = V // len(devices)
        home = next(iter(params_V.values())).device

        def block(i):
            dev = devices[i] or home
            outs = []
            with _device_context(dev):
                for j in range(i * per, (i + 1) * per):
                    outs.append(bases[i](
                        _video(params_V, j, dev), _video(opt_V, j, dev),
                        frames_V[j].to(dev), labels_V[j].to(dev),
                        int(n_valid_V[j]), gens_V[j], lr,
                        _video(mask_V, j, dev), reselect=reselect,
                        class_mask=None if class_mask_V is None
                        else class_mask_V[j].to(dev)))
            return outs

        outs = [o for b in _per_device(devices, block) for o in b]
        params, opt, mask = (
            stack_videos([_tree_map(lambda x: x.to(home), o[k])
                          for o in outs]) for k in range(3))
        losses = torch.stack([o[3].to(home) for o in outs])
        return params, opt, mask, losses

    return fn


def make_multi_video_round(spec: DistillSpec, mesh: Mesh,
                           reselect: bool = None,
                           with_class_mask: bool = False):
    """V per-video rounds, V a multiple of the mesh's device count
    (``ValueError`` otherwise).  Signature:
        fn(params_V, opt_V, frames_V, labels_V, n_valid_V, gens_V, lr,
           mask_V[, class_mask_V]) -> (params_V, opt_V, mask_V, losses_V)

    ``params_V``, ``opt_V`` and ``mask_V`` are stacked trees
    (``stack_videos``); the results are stacked on the device of
    ``params_V``.  ``frames_V``/``labels_V``: the per-video uint8 buffers,
    a stacked tensor or a sequence (memories of different lengths);
    ``n_valid_V`` their live rows; ``gens_V`` one ``torch.Generator`` per
    video, on the device its block runs on.  Video j runs on device
    j // (V / mesh size) of ``mesh.device_list()``.

    ``reselect`` (coord_desc_auto; None means ``spec.strategy ==
    "coord_desc_auto"``): recompute each video's subset at iteration 0;
    False reuses the supplied masks (keep_mask=True).

    ``with_class_mask``: ``spec.class_indices`` is the UNION of the videos'
    subsets, and each video narrows it with its own {0,1} row of
    ``class_mask_V`` (V, len(union)), so its loss is the one of a round
    over its own subset.
    """
    # the parallelism is the V axis; a video's round runs on one device
    spec = dataclasses.replace(spec, batch_axis=None, width_axis=None)
    devices = mesh.device_list()
    if reselect is None:
        reselect = spec.strategy == "coord_desc_auto"
    # one round per device: a round keeps its last selection as state
    bases = [make_distill_round(spec) for _ in devices]
    return _video_rounds(bases, devices, reselect, with_class_mask)


def make_vmapped_multi_video_round(spec: DistillSpec, reselect: bool = None,
                                   with_class_mask: bool = False):
    """``make_multi_video_round``'s signature and per-video results on the
    inputs' one device, the videos' rounds run one after another.

    JAX's version ``vmap``s one program over the videos' weights, which
    its docstring measured slower than serial rounds on a TPU; its
    semantics are the serial rounds' (tests/test_vmapped_round.py), which
    this computes.  A batched-weights version (grouped convolutions) is
    not ported (ROADMAP C).
    """
    if reselect is None:
        reselect = spec.strategy == "coord_desc_auto"
    return _video_rounds([make_distill_round(spec)], [None], reselect,
                         with_class_mask)


def make_sharded_labeler(mesh: Mesh, teacher_params,
                         data_axis: str = "data",
                         model_axis: str = "model",
                         compute_dtype=torch.bfloat16):
    """Teacher labeling with the frame batch split in contiguous chunks
    over the mesh's devices: label(frames (N, H, W, 3)) -> (N, H, W) int32
    ``teacher_predictions`` (the full-resolution argmax, as JAX's route
    through ``teacher_outputs(...)["predictions"]``), concatenated on the
    mesh's first device.  N must divide over the devices."""
    from ams_tpu_torch.models.xception_deeplab import teacher_predictions

    devices = mesh.device_list()
    cd = as_dtype(compute_dtype)
    # the teacher goes to each device ONCE, not on every labeling call
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = {k: v.to(d) for k, v in teacher_params.items()}

    def label(frames):
        frames = torch.as_tensor(frames)
        if frames.shape[0] % len(devices):
            raise ValueError("a batch of %d frames does not divide over %d "
                             "devices" % (frames.shape[0], len(devices)))
        chunks = frames.chunk(len(devices))

        def one(i):
            dev = devices[i]
            with _device_context(dev), torch.inference_mode():
                return teacher_predictions(replicas[dev], chunks[i].to(dev),
                                           compute_dtype=cd)

        return torch.cat([p.to(devices[0])
                          for p in _per_device(devices, one)])

    return label
