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
   selection stay the same on every rank.  Over a mesh with a ``model``
   axis, rank r also partitions the activation width over the devices of
   the mesh's row r, as JAX's GSPMD round does, with the halo exchanges
   made explicit and the shards kept in the rank's process
   (``parallel.spatial``).  The JAX round's ``.lower`` AOT hook has no
   counterpart (ROADMAP C).

2. **The multi-video round** (``make_multi_video_round``): V independent
   students, one per edge client.  The per-video state carries a leading V
   axis (``stack_videos``); the videos are split in contiguous blocks over
   the mesh's devices, as JAX's ``P(axes)`` splits the leading axis, and
   each device runs its videos' whole rounds one after another, one host
   thread per device.  On one card that is all V, serially.

3. **The batched-weights multi-video round**
   (``make_vmapped_multi_video_round``): the same signature and per-video
   results as one program over the V students' stacked weights on one
   device, as JAX's ``jax.vmap`` over the round: the loss and its
   gradients through ``torch.func.vmap(torch.func.grad_and_value(...))``,
   so that every convolution runs once for all V videos (V folded into
   its groups), and the rest of each iteration on the stacked tensors.

Teacher labeling splits the frame batch over the mesh's ``data`` axis and
the width over its ``model`` axis (``make_sharded_labeler``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from ams_tpu_torch.parallel import spatial
from ams_tpu_torch.parallel.collectives import SumReducer
from ams_tpu_torch.parallel.mesh import Mesh

# The round and the models import parallel.spatial, and so this package:
# they are imported where they are used.
if TYPE_CHECKING:
    from ams_tpu_torch.distill.train_step import DistillSpec


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
    """This rank's part of one student's minibatch- and width-parallel
    round.

    ``mesh_or_group``: a ``torch.distributed`` process group, or None for
    the default group (``init_multi_host``): the minibatch over its ranks.
    Or a ``Mesh``: the minibatch over its ``data`` axis, which is the
    default group (its world size must equal the axis's, ``ValueError``
    otherwise; with no group initialized the axis must be 1), and rank r's
    width over the devices of the mesh's row r when the ``model`` axis is
    above 1.  The round then splits the frame and label buffers by
    columns over the row, and params, Adam state and mask go to its first
    device, where the results are.
    Returns the round of ``make_distill_round``:
    fn(params, opt, frames_buf, labels_buf, n_valid, rng, lr, mask,
    reselect=True, class_mask=None, idx_seq=None), with ``batch_size`` the
    GLOBAL minibatch, which must divide over the ranks (``ValueError``).
    Every rank passes the same params, Adam state, buffers and draws: a
    generator seeded alike on every rank, or the same ``idx_seq``.
    """
    from ams_tpu_torch.distill.train_step import make_distill_round

    if not isinstance(mesh_or_group, Mesh):
        spec = dataclasses.replace(spec, batch_axis=data_axis)
        return make_distill_round(spec, reduce=SumReducer(mesh_or_group))
    mesh = mesh_or_group
    rows = mesh.rows(data_axis)
    reduce = None
    if dist.is_initialized():
        reduce = SumReducer()
        if reduce.world != len(rows):
            raise ValueError("the mesh's %r axis is %d but the process "
                             "group has %d ranks"
                             % (data_axis, len(rows), reduce.world))
    elif len(rows) != 1:
        raise ValueError("a mesh with a %r axis of %d needs a process group "
                         "of as many ranks (init_multi_host)"
                         % (data_axis, len(rows)))
    row = rows[0 if reduce is None else reduce.rank]
    width = row if len(row) > 1 else None
    spec = dataclasses.replace(
        spec, batch_axis=data_axis if reduce is not None else None,
        width_axis=model_axis if width else None)
    base = make_distill_round(spec, reduce=reduce, width_devices=width)

    def round_fn(params, opt, frames_buf, labels_buf, n_valid, rng, lr,
                 mask, reselect=True, **kw):
        # JAX's _prepare: the state on the row's first device; the round
        # splits the buffers over the row's columns
        params, opt, mask = (_tree_map(lambda x: x.to(row[0]), t)
                             for t in (params, opt, mask))
        return base(params, opt, frames_buf, labels_buf, n_valid, rng, lr,
                    mask, reselect=reselect, **kw)

    return round_fn


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
    j // (V / mesh size) of ``mesh.device_list()``, over both axes of the
    mesh (JAX's ``P(axes)``).

    ``reselect`` (coord_desc_auto; None means ``spec.strategy ==
    "coord_desc_auto"``): recompute each video's subset at iteration 0;
    False reuses the supplied masks (keep_mask=True).

    ``with_class_mask``: ``spec.class_indices`` is the UNION of the videos'
    subsets, and each video narrows it with its own {0,1} row of
    ``class_mask_V`` (V, len(union)), so its loss is the one of a round
    over its own subset.
    """
    from ams_tpu_torch.distill.train_step import make_distill_round

    # the parallelism is the V axis; a video's round runs on one device
    spec = dataclasses.replace(spec, batch_axis=None, width_axis=None)
    devices = mesh.device_list()
    if reselect is None:
        reselect = spec.strategy == "coord_desc_auto"
    # one round per device: a round keeps its last selection as state
    bases = [make_distill_round(spec) for _ in devices]
    return _video_rounds(bases, devices, reselect, with_class_mask)


def row_quantiles(x: torch.Tensor, q: float) -> torch.Tensor:
    """``torch.quantile(x[v], q, interpolation="linear")`` for every row
    of a 2-D ``x``, row by row: the single round's call on each video's
    |delta|, under the same input limit (2**24 entries), which a whole
    (V, N) ``x`` flattened would pass first."""
    return torch.stack([torch.quantile(r, q, interpolation="linear")
                        for r in x])


def _select(stepped, before, frac):
    """The peeled coord_desc_auto selection of V videos at once: each
    video's top ``frac`` of |stepped - before| over all its trainables,
    by its own threshold -> (masks, thresholds (V,), ties (V,))."""
    keys = sorted(stepped)
    delta = {k: torch.abs(stepped[k] - before[k]) for k in keys}
    v = delta[keys[0]].shape[0]
    flat = torch.cat([delta[k].reshape(v, -1) for k in keys], dim=1)
    thr = row_quantiles(flat, 1.0 - frac)
    mask = {k: delta[k] > thr.view(-1, *(1,) * (delta[k].dim() - 1))
            for k in stepped}
    return mask, thr, torch.sum(flat == thr[:, None], dim=1)


def make_vmapped_multi_video_round(spec: DistillSpec, reselect: bool = None,
                                   with_class_mask: bool = False):
    """``make_multi_video_round``'s signature and per-video results as one
    program over the V students' stacked weights on the inputs' one
    device:
        fn(params_V, opt_V, frames_V, labels_V, n_valid_V, gens_V, lr,
           mask_V[, class_mask_V]) -> (params_V, opt_V, mask_V, losses_V)

    Each iteration draws every video's minibatch from its own generator
    as its serial round draws it; takes the V losses and their gradients
    as ``torch.func.vmap`` of ``torch.func.grad_and_value`` of the round's
    loss, the BN batch moments its aux output; then the stacked Adam step,
    the BN moving averages, the peeled ``coord_desc_auto`` selection (each
    video's quantile over its own row of |delta|) and the masks' ``where``
    on the stacked tensors, one launch per op for all videos.  With
    ``spec.fused_loss`` K2 runs once per iteration over the V x B images
    (``ops.fused_resize_ce``).  Batched convolutions sum in another order
    than V single ones, so the results are the serial rounds' to rounding,
    not to the bit.

    A spec with ``width_axis`` or ``batch_axis`` raises ``ValueError``, as
    do a video count that differs between the inputs and videos' frames
    or labels of different shapes.  After a selecting
    call, ``fn.last_selection`` holds each video's threshold and the count
    of |delta| values equal to it, (V,) device tensors.
    """
    from ams_tpu_torch.distill.optimizer import adam_apply
    from ams_tpu_torch.distill.train_step import (
        _bn_update,
        _round_loss,
        _tree_where,
        split_params,
    )
    from ams_tpu_torch.models.layers import video_batched
    from ams_tpu_torch.utils.platform import conv_precision

    if spec.width_axis or spec.batch_axis:
        raise ValueError("the batched multi-video round runs on one device: "
                         "no width_axis (%r) or batch_axis (%r)"
                         % (spec.width_axis, spec.batch_axis))
    spec.check_supported()
    if reselect is None:
        reselect = spec.strategy == "coord_desc_auto"

    def batched_grads(cdtype):
        """(params_t, bn_state, frames, labels, class_mask), each with a
        leading V axis (no class mask: None) -> (grads, (losses, BN
        moments))."""
        def loss_fn(p, bn, f, lab, cm):
            return _round_loss(spec, p, bn, f, lab, cm, cdtype)
        return torch.func.vmap(
            torch.func.grad_and_value(loss_fn, has_aux=True),
            in_dims=(0, 0, 0, 0, 0 if with_class_mask else None))

    grad_fns = {cd: batched_grads(cd)
                for cd in {spec.cdtype, spec.select_cdtype}}

    @torch.no_grad()
    def fn(params_V, opt_V, frames_V, labels_V, n_valid_V, gens_V, lr,
           mask_V, class_mask_V=None):
        if with_class_mask != (class_mask_V is not None):
            raise ValueError("the round was built with with_class_mask=%s"
                             % with_class_mask)
        V = len(gens_V)
        counts = {len(frames_V), len(labels_V), len(n_valid_V)}
        counts |= {int(x.shape[0]) for t in (params_V, opt_V, mask_V)
                   for x in _leaves(t)}
        if class_mask_V is not None:
            counts.add(len(class_mask_V))
        if counts != {V}:
            raise ValueError("the inputs hold different video counts: %s"
                             % sorted(counts))
        with conv_precision(spec.conv_precision):
            return run(params_V, opt_V, frames_V, labels_V, n_valid_V,
                       gens_V, lr, mask_V, class_mask_V)

    def run(params_V, opt_V, frames_V, labels_V, n_valid_V, gens_V, lr,
            mask_V, class_mask_V):
        V = len(gens_V)
        params_t, bn_state = split_params(params_V)
        dev = next(iter(params_t.values())).device
        before = params_t
        his = [max(int(n), 1) for n in n_valid_V]
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        if class_mask_V is not None:
            class_mask_V = torch.as_tensor(class_mask_V).to(dev)
        frames_V, labels_V = (_stacked(b, dev)
                              for b in (frames_V, labels_V))
        videos = torch.arange(V, device=dev)[:, None]

        def draw():
            idx = torch.stack([
                torch.randint(0, hi, (spec.batch_size,), generator=g,
                              device=dev) for hi, g in zip(his, gens_V)])
            return frames_V[videos, idx].float(), labels_V[videos, idx]

        def step(params_t, bn_state, opt, cdtype):
            frames, labels = draw()
            with video_batched():
                grads, (loss, stats) = grad_fns[cdtype](
                    params_t, bn_state, frames, labels, class_mask_V)
            stepped, opt = adam_apply(params_t, grads, opt, lr)
            if spec.bn_train:
                bn_state = _bn_update(bn_state, stats)
            return loss, stepped, bn_state, opt

        opt, mask, losses = opt_V, mask_V, []
        first_iter = 0
        if reselect and spec.strategy == "coord_desc_auto" and spec.iters:
            loss0, stepped, bn_state, opt = step(params_t, bn_state, opt,
                                                 spec.select_cdtype)
            mask, thr, ties = _select(stepped, before, spec.coord_frac)
            fn.last_selection = {"threshold": thr, "ties": ties}
            params_t = _tree_where(mask, stepped, before)
            first_iter = 1
            losses.append(loss0)
        for _ in range(first_iter, spec.iters):
            loss, stepped, bn_state, opt = step(params_t, bn_state, opt,
                                                spec.cdtype)
            params_t = _tree_where(mask, stepped, params_t)
            losses.append(loss)

        out = dict(params_t)
        out.update(bn_state)
        losses = torch.stack(losses, dim=1) if losses else \
            torch.zeros((V, 0), dtype=torch.float32, device=dev)
        return out, opt, mask, losses

    fn.last_selection = None
    return fn


def _stacked(bufs, dev):
    """Per-video buffers as one (V, ...) tensor on ``dev``, from which one
    gather draws every video's minibatch."""
    if isinstance(bufs, torch.Tensor):
        return bufs.to(dev)
    shapes = {tuple(b.shape) for b in bufs}
    if len(shapes) != 1:
        raise ValueError("the batched round takes the videos' buffers at "
                         "one shape, got %s" % sorted(shapes))
    return torch.stack([b.to(dev) for b in bufs])


def _leaves(tree):
    """The tensor leaves of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def make_sharded_labeler(mesh: Mesh, teacher_params,
                         data_axis: str = "data",
                         model_axis: str = "model",
                         compute_dtype=torch.bfloat16):
    """Teacher labeling with the frame batch split in contiguous chunks
    over the mesh's ``data`` axis and each chunk's width over the devices
    of its row (the ``model`` axis): label(frames (N, H, W, 3)) -> (N, H,
    W) int32 ``teacher_predictions`` (the full-resolution argmax of the
    gathered logits, as JAX's route through
    ``teacher_outputs(...)["predictions"]``), concatenated on the mesh's
    first device.  N must divide over the rows.  The teacher goes to each
    row's first device once; a row's other devices take each weight from
    there at every call."""
    from ams_tpu_torch.models.layers import as_dtype
    from ams_tpu_torch.models.xception_deeplab import teacher_predictions

    rows = mesh.rows(data_axis)
    cd = as_dtype(compute_dtype)
    # the teacher goes to each device ONCE, not on every labeling call
    replicas = {}
    for row in rows:
        if row[0] not in replicas:
            replicas[row[0]] = {k: v.to(row[0])
                                for k, v in teacher_params.items()}

    def label(frames):
        frames = torch.as_tensor(frames)
        if frames.shape[0] % len(rows):
            raise ValueError("a batch of %d frames does not divide over %d "
                             "mesh rows" % (frames.shape[0], len(rows)))
        chunks = frames.chunk(len(rows))

        def one(i):
            row = rows[i]
            x = chunks[i].to(row[0])
            if len(row) > 1:
                x = spatial.shard_width(x, row, dim=2)
            with _device_context(row[0]), torch.inference_mode():
                return teacher_predictions(replicas[row[0]], x,
                                           compute_dtype=cd)

        home = rows[0][0]
        return torch.cat([p.to(home) for p in _per_device(rows, one)])

    return label
