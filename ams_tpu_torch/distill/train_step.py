"""The online-distillation round and the scoring functions, in PyTorch.

Counterpart of ``ams_tpu/distill/train_step.py``.  The JAX package runs
the whole round as one ``lax.scan`` inside one XLA program; eager PyTorch
runs it as a Python loop over iterations, with every tensor on the device
and no host round trip inside the loop.  Each iteration:

- draws its minibatch on the device from the uint8 frame and label
  buffers, by a row of ``idx_seq`` or from a seeded ``torch.Generator``
  (whose numbers are not ``jax.random``'s; parity runs through
  ``idx_seq``);
- runs the forward and backward with autograd over the trainable leaves;
- takes the unmasked Adam step, then keeps the old value where the mask is
  False (``torch.where``): masked coordinates stay bitwise put while the
  Adam slots advance, as in the reference's ``train_coord``;
- advances the BN moving averages every step, whatever the mask (they are
  frozen under ``bn_train=False``).

``coord_desc_auto`` with ``reselect`` peels iteration 0: one full step,
then the top ``coord_frac`` of |delta| over all trainables (concatenated in
sorted-key order, ``torch.quantile`` with linear interpolation, a strict
``>``) is kept and the rest reverted.

``compute_dtype="bfloat16"`` is the mixed-precision round of the JAX
package: each convolution casts its input and weight to bf16, while the
parameters, the Adam slots, the BN moving statistics, the BN moments and
the loss stay float32.  The peeled selection iteration runs at
``select_dtype`` (float32 by default), the others at the compute type, and
a bf16 round resizes the loss's logits by the matmul form.  Float32
convolutions and products run at ``conv_precision`` for the whole round:
full f32 by default, TF32 on the card with ``"default"``.

The losses stay on the device and are stacked at the end.

With a ``parallel.collectives.SumReducer`` (``parallel.sharded.
make_sharded_distill_round`` passes one) the round is one rank's part of
the minibatch-parallel round: every rank draws the same global minibatch
and takes its contiguous share of the rows; BN moments and the loss are
summed over the ranks in the forward, the parameter gradients after the
backward, so the parameters, the Adam slots and the selection stay the
same on every rank.

With the devices of a mesh row (``width_devices``, which
``make_sharded_distill_round`` passes for a mesh with a ``model`` axis)
the activation width is partitioned over them, as JAX's round does under
``width_axis``: the frame and label buffers are split by columns
(``parallel.spatial``), each draw indexes every shard on its device, the
forward runs on the shards, and the loss sums over them.  The parameters
stay on the row's first device; autograd brings their gradients there
from every shard.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from ams_tpu_torch.distill.loss import (
    distill_loss,
    masked_mean,
    reduce_labels,
    softmax_xent_with_soft_labels,
)
from ams_tpu_torch.distill.optimizer import AdamState, adam_apply, adam_init  # noqa: F401
from ams_tpu_torch.models import layers
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    student_forward,
    trainable_names,
)
from ams_tpu_torch.parallel import spatial
from ams_tpu_torch.utils.metrics import (
    confusion_matrix,
    confusion_matrix_per_frame,
)
from ams_tpu_torch.utils.platform import CONV_PRECISIONS, conv_precision


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    """Static configuration of a distillation round; the fields of
    ``ams_tpu``'s ``DistillSpec``.  ``batch_axis`` names the minibatch-
    parallel round over a process group and ``width_axis`` the
    partitioning of the width over a mesh row; both rounds are built by
    ``parallel.sharded.make_sharded_distill_round``."""

    iters: int = 200                 # run.py 'iter' flag default
    batch_size: int = 10             # run.py 'batch_size'
    num_classes: int = 19
    class_indices: Tuple[int, ...] = tuple(range(19))
    strategy: str = "full_model"
    coord_frac: float = 0.1
    compute_dtype: str = "float32"   # or "bfloat16" (mixed precision)
    batch_axis: Optional[str] = None     # minibatch over ranks
    width_axis: Optional[str] = None     # width over a mesh row's devices
    # "auto"/"highest": full f32 (TF32 off); "default": TF32 convolutions
    # and products on the card for the whole round (utils.platform.
    # conv_precision), the JAX package's single-pass lax.Precision.DEFAULT
    conv_precision: str = "auto"
    # Fused upsample+CE loss kernel (ops.fused_resize_ce): the same loss
    # to f32 rounding without the full-resolution logits.  Off by default,
    # as in the JAX package; PERF.md has the card's times for both paths.
    fused_loss: bool = False
    # the peeled selection iteration's type: "float32", or "compute"
    select_dtype: str = "float32"
    # "auto" = the gather resize for f32 rounds, the matmul form for bf16
    loss_resize: str = "auto"
    bn_train: bool = True

    @property
    def cdtype(self) -> torch.dtype:
        return layers.as_dtype(self.compute_dtype)

    def resize_via(self, cdtype) -> str:
        if self.loss_resize != "auto":
            return self.loss_resize
        return "gather" if layers.as_dtype(cdtype) == torch.float32 \
            else "matmul"

    @property
    def select_cdtype(self) -> torch.dtype:
        if self.select_dtype == "compute":
            return self.cdtype
        return layers.as_dtype(self.select_dtype)

    def check_supported(self, sharded: bool = False,
                        width_split: bool = False) -> None:
        """Raises for a spec the port cannot run; ``sharded``: the round
        is built with a process group (``batch_axis`` needs one);
        ``width_split``: with a mesh row of several devices (``width_axis``
        needs one, and one needs it)."""
        layers.as_dtype(self.compute_dtype)  # ValueError if unknown
        if self.select_dtype not in ("float32", "compute"):
            raise ValueError("select_dtype must be 'float32' or 'compute'")
        if bool(self.width_axis) != width_split:
            raise ValueError(
                "width_axis %r needs a mesh with a model axis, and a mesh "
                "row needs width_axis: build the round with "
                "parallel.make_sharded_distill_round" % (self.width_axis,))
        if self.batch_axis and not sharded:
            raise ValueError(
                "batch_axis %r needs a process group: build the round with "
                "parallel.make_sharded_distill_round" % (self.batch_axis,))
        if self.conv_precision not in CONV_PRECISIONS:
            raise ValueError("conv_precision must be one of %s, got %r"
                             % (CONV_PRECISIONS, self.conv_precision))
        if self.loss_resize not in ("auto", "gather", "matmul"):
            raise ValueError("loss_resize must be auto, gather or matmul")


def split_params(params):
    """-> (trainable, bn_state) by TF trainable-collection rules."""
    tnames = set(trainable_names(params))
    train = {k: v for k, v in params.items() if k in tnames}
    state = {k: v for k, v in params.items() if k not in tnames}
    return train, state


def all_true_mask(params):
    train, _ = split_params(params)
    return {k: torch.ones(v.shape, dtype=torch.bool, device=v.device)
            for k, v in train.items()}


def _tree_where(mask, a, b):
    return {k: torch.where(mask[k], a[k], b[k]) for k in a}


def _flat_abs_delta(a, b):
    return torch.cat([torch.abs(a[k] - b[k]).reshape(-1) for k in sorted(a)])


def _round_loss(spec, params_t, bn_state, frames, labels, class_mask,
                cdtype, reduce=None):
    """The round's loss on one minibatch, of the trainables ``params_t``
    beside the BN state -> (loss, the BN batch moments that the moving
    averages take; empty without ``spec.bn_train``)."""
    merged = dict(params_t)
    merged.update(bn_state)
    stats = {}
    loss, _aux = distill_loss(
        merged, frames, labels, tuple(int(c) for c in spec.class_indices),
        spec.num_classes, train=spec.bn_train, compute_dtype=cdtype,
        stats_out=stats if spec.bn_train else None, fused=spec.fused_loss,
        class_mask=class_mask, resize_via=spec.resize_via(cdtype),
        reduce=reduce)
    return loss, stats


def _bn_update(bn_state, stats):
    """The BN moving averages after one step; the recorded variance is
    already Bessel-corrected."""
    keys = list(bn_state)
    moving = [bn_state[k] for k in keys]
    diff = torch._foreach_mul(
        torch._foreach_sub(moving, [stats[k] for k in keys]),
        1.0 - layers.BN_DECAY)
    return dict(zip(keys, torch._foreach_sub(moving, diff)))


def make_distill_round(spec: DistillSpec, reduce=None, width_devices=None):
    """Build the round function; with ``reduce`` (a
    ``parallel.collectives.SumReducer``), this rank's part of the
    minibatch-parallel round; with ``width_devices`` (a mesh row of two
    or more devices, and ``spec.width_axis``), the round with its width
    partitioned over them (module docstring).

    Returned signature:
        round_fn(params, opt_state, frames_buf, labels_buf, n_valid, gen,
                 lr, mask, reselect=True, class_mask=None, idx_seq=None)
            -> (params, opt_state, mask, losses)

    - params: flat dict (trainable + BN moving stats), on one device.
    - frames_buf: (capacity, H, W, 3) uint8 device buffer; labels_buf:
      (capacity, H, W) uint8 or int32; with ``width_devices`` either may
      also be split already (``spatial.shard_width(buf, devices, dim=2)``).
    - n_valid: number of live entries in the buffers (an int).
    - gen: a ``torch.Generator`` on the buffers' device for the draws
      (unused with ``idx_seq``).
    - mask: bool dict over trainable params; see ``ams_tpu``'s round for
      the strategies' use of it and of ``reselect``.
    - losses: (iters,) f32 on the device, the per-iteration loss trace.

    After a selecting call, ``round_fn.last_selection`` holds the
    threshold and the count of |delta| values equal to it (0-dim device
    tensors), for checks of the selected fraction.
    """
    width = list(width_devices or ())
    spec.check_supported(sharded=reduce is not None,
                         width_split=len(width) > 1)
    auto = spec.strategy == "coord_desc_auto"
    rows = slice(None)           # this rank's rows of the minibatch
    if reduce is not None:
        if spec.batch_size % reduce.world:
            raise ValueError(
                "batch_size %d does not divide over %d ranks"
                % (spec.batch_size, reduce.world))
        share = spec.batch_size // reduce.world
        rows = slice(reduce.rank * share, (reduce.rank + 1) * share)

    def loss_and_grads(params_t, bn_state, frames, labels, class_mask,
                       cdtype):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params_t.items()}
        with torch.enable_grad():
            loss, stats = _round_loss(spec, leaves, bn_state, frames, labels,
                                      class_mask, cdtype, reduce)
            keys = list(leaves)
            if reduce is None:
                grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
            else:
                # every rank seeds its copy of the replicated loss with
                # 1/world: the all-reduces' backward sums the seeds back
                # to 1, and each rank gets the gradient for its replica
                seed = torch.full_like(loss, 1.0 / reduce.world)
                grads = reduce.sum_tensors(torch.autograd.grad(
                    loss, [leaves[k] for k in keys], grad_outputs=seed))
        return loss.detach(), dict(zip(keys, grads)), stats

    @torch.no_grad()
    def round_fn(params, opt_state, frames_buf, labels_buf, n_valid, gen,
                 lr, mask, reselect: bool = True, class_mask=None,
                 idx_seq=None):
        # every iteration at the spec's precision, the peeled selection
        # step included, as JAX passes spec.precision to every loss
        with conv_precision(spec.conv_precision):
            return run(params, opt_state, frames_buf, labels_buf, n_valid,
                       gen, lr, mask, reselect, class_mask, idx_seq)

    def run(params, opt_state, frames_buf, labels_buf, n_valid, gen, lr,
            mask, reselect, class_mask, idx_seq):
        if width:
            frames_buf, labels_buf = (spatial.shard_width(b, width, dim=2)
                                      for b in (frames_buf, labels_buf))
        dev = frames_buf.device
        if idx_seq is not None:
            idx_seq = torch.as_tensor(idx_seq, device=dev).long()
            if idx_seq.dim() != 2 or idx_seq.shape[1] != spec.batch_size:
                raise ValueError(
                    "idx_seq must be (iters, batch_size=%d); got %r"
                    % (spec.batch_size, tuple(idx_seq.shape)))
            if idx_seq.shape[0] < spec.iters:
                raise ValueError(
                    "idx_seq has %d rows but the round runs %d iterations"
                    % (idx_seq.shape[0], spec.iters))
        params_t, bn_state = split_params(params)
        before = params_t   # round-start snapshot (auto reverts to this)
        hi = max(int(n_valid), 1)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)

        def draw(it):
            if idx_seq is not None:
                idx = idx_seq[it]
            else:
                idx = torch.randint(0, hi, (spec.batch_size,),
                                    generator=gen, device=dev)
            idx = idx[rows]
            if width:
                return (frames_buf.map(lambda b: b[idx.to(b.device)].float()),
                        labels_buf.map(lambda b: b[idx.to(b.device)]))
            return frames_buf[idx].float(), labels_buf[idx]

        def step(params_t, bn_state, opt_state, it, cdtype):
            frames, labels = draw(it)
            loss, grads, stats = loss_and_grads(params_t, bn_state, frames,
                                                labels, class_mask, cdtype)
            stepped, opt_state = adam_apply(params_t, grads, opt_state, lr)
            if spec.bn_train:
                # every step, for every BN, whatever the mask
                bn_state = _bn_update(bn_state, stats)
            return loss, stepped, bn_state, opt_state

        first_iter = 0
        losses = []
        if auto and reselect and spec.iters > 0:
            loss0, stepped, bn_state, opt_state = step(
                params_t, bn_state, opt_state, 0, spec.select_cdtype)
            delta = _flat_abs_delta(stepped, before)
            thr = torch.quantile(delta, 1.0 - spec.coord_frac,
                                 interpolation="linear")
            round_fn.last_selection = {"threshold": thr,
                                       "ties": torch.sum(delta == thr)}
            mask = {k: torch.abs(stepped[k] - before[k]) > thr
                    for k in stepped}
            params_t = _tree_where(mask, stepped, before)
            first_iter = 1
            losses.append(loss0)

        for it in range(first_iter, spec.iters):
            loss, stepped, bn_state, opt_state = step(
                params_t, bn_state, opt_state, it, spec.cdtype)
            params_t = _tree_where(mask, stepped, params_t)
            losses.append(loss)

        out = dict(params_t)
        out.update(bn_state)
        losses = torch.stack(losses) if losses else \
            torch.zeros((0,), dtype=torch.float32, device=dev)
        return out, opt_state, mask, losses

    round_fn.last_selection = None
    return round_fn


def _scoring(reduced_logits, labels, class_indices, num_classes):
    red_labels, weights, filtered_onehot = reduce_labels(
        labels, class_indices, num_classes)
    pixel_loss = softmax_xent_with_soft_labels(reduced_logits,
                                               filtered_onehot)
    return red_labels, weights, pixel_loss


@functools.lru_cache(maxsize=None)
def make_predict_fn(num_classes, class_indices, *, train_bn: bool,
                    compute_dtype=torch.float32):
    """predict(params, frames, labels) -> (preds in reduced ids, confusion
    matrix over the selected classes with invalid-label weights zeroed,
    mean CE over valid pixels).  ``train_bn=True`` normalizes with the
    batch statistics, as the reference's server-side (non-frozen) graph
    does; the deployed client uses the moving statistics.  Either runs in
    float32 or bfloat16."""
    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict(params, frames, labels):
        reduced_logits, preds = student_forward(
            params, frames, class_indices, train=train_bn,
            compute_dtype=compute_dtype)
        red_labels, weights, pixel_loss = _scoring(
            reduced_logits, labels, class_indices, num_classes)
        cm = confusion_matrix(red_labels, preds, n_sel, weights)
        return preds, cm, masked_mean(pixel_loss, weights)

    return predict


@functools.lru_cache(maxsize=None)
def make_predict_seq_fn(num_classes, class_indices, *, train_bn: bool,
                        compute_dtype=torch.float32):
    """Per-frame metrics over a frame batch: predict_seq(params, frames,
    labels) -> (preds (B,H,W), confusion matrices (B,C,C), losses (B,))."""
    class_indices = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)

    @torch.no_grad()
    def predict_seq(params, frames, labels):
        reduced_logits, preds = student_forward(
            params, frames, class_indices, train=train_bn,
            compute_dtype=compute_dtype)
        red_labels, weights, pixel_loss = _scoring(
            reduced_logits, labels, class_indices, num_classes)
        cm_f = confusion_matrix_per_frame(red_labels, preds, n_sel, weights)
        wsum_f = torch.clamp(torch.sum(weights, dim=(1, 2)), min=1.0)
        loss_f = torch.sum(pixel_loss * weights, dim=(1, 2)) / wsum_f
        return preds, cm_f, loss_f

    return predict_seq
