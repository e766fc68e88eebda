"""The reference's graph-builder API (graph_utils.py), in PyTorch.

Counterpart of ``ams_tpu/compat.py``: the builders ``create_student_v3``,
the legacy ``create_student_v2`` and ``create_student``, ``create_teacher``,
``create_teacher_v2``, ``create_client`` and ``create_client_temp`` return
dicts under the reference's handle names, whose values are params (flat
dicts of tensors on ``device``) and callables, so call sites translate
mechanically:

    sess.run(student['predictions'], feed...)  ->  student['predictions'](params, frames)

The callables run eagerly (the JAX package jits them) and take numpy
arrays or tensors; they return tensors on ``device``, except
``create_client``'s, which return numpy as JAX's do.  Every builder takes
``device`` (``cuda`` unless the caller passes ``"cpu"``).  A ``meta_dir``
is a .npy/.npz dict or a TF checkpoint prefix (``utils.checkpoint.
load_any``); ``None`` opts into a seeded init, and a missing path raises
``FileNotFoundError``.  The seeded init draws from a ``torch.Generator``,
so its values differ from ``jax.random``'s.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ams_tpu_torch.distill.loss import (
    distill_loss,
    masked_mean,
    reduce_labels,
    selective_loss,
    softmax_xent_with_soft_labels,
)
from ams_tpu_torch.distill.optimizer import adam_apply, adam_init
from ams_tpu_torch.distill.train_step import split_params
from ams_tpu_torch.models import layers
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    init_student_params,
    student_logits,
    trainable_names,
)
from ams_tpu_torch.models.xception_deeplab import (
    init_teacher_params,
    teacher_outputs,
)
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.colormap import colormap
from ams_tpu_torch.utils.metrics import confusion_matrix
from ams_tpu_torch.utils.platform import resolve_device


def _tensor(x, dev):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=dev)


def _on(params, dev):
    """Params as tensors on ``dev``; float64 arrays become float32, as
    ``jnp.asarray`` makes them without x64."""
    out = {k: _tensor(v, dev) for k, v in params.items()}
    return {k: v.float() if v.dtype == torch.float64 else v
            for k, v in out.items()}


def _load_student(meta_dir, num_classes, dev, seed=0):
    # meta_dir=None is the explicit random-init opt-in; a missing PATH must
    # raise: a typo'd checkpoint must never hand back a fresh init
    base = init_student_params(seed, num_classes=num_classes, device="cpu")
    if meta_dir is not None:
        base = ckpt.merge_restore({k: v.numpy() for k, v in base.items()},
                                  ckpt.load_any(str(meta_dir)))
    return _on(base, dev)


def _class_indices(class_weights):
    return np.where(np.asarray(class_weights).reshape(-1) == 1)[0]


# --- the reference's trainable-variable filters --------------------------
# create_student_v3 narrows tf.trainable_variables() (graph_utils.py:420-430):
# drop expanded_conv_4..12 by SUBSTRING ("conv_4" also catches
# "expanded_conv_4/..."), then any variable with >= 1e4 elements.  These
# names feed the drift loss, the optional regularizer and the returned
# 'training_var_names'.
_V3_EXCLUDED_LAYERS = tuple("conv_%d" % i for i in range(4, 13))
_V3_SIZE_CAP = 1e4


def _v3_tvar_names(params, train_biases_only=False):
    names = [k for k in trainable_names(params)
             if not any(x in k for x in _V3_EXCLUDED_LAYERS)]
    names = [k for k in names if params[k].numel() < _V3_SIZE_CAP]
    if train_biases_only:
        names = [k for k in names if "weight" not in k]
    return names


def _l2_loss(v):
    """tf.nn.l2_loss: sum(v^2) / 2."""
    return torch.sum(torch.square(v)) / 2.0


def _grads(loss_of, sub):
    """(loss, {name: gradient}) of ``loss_of(leaves)`` over the tensors of
    ``sub``, as ``jax.value_and_grad`` (zeros where a leaf is unused)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in sub.items()}
    with torch.enable_grad():
        out = loss_of(leaves)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, grads)}
    return out, grads


def create_student_v3(meta_dir, class_weights=None, threshold=None,
                      map_misc=0, test_mode=False, train_biases_only=False,
                      regularize=False, soft_teacher=False,
                      masked_gradients=False, num_classes=19,
                      device=None) -> Dict:
    """The live student builder (graph_utils.py:338-533).

    Kwarg semantics, the reference's:
    - ``regularize``: loss += 0.01 * mean(l2_loss(v) for v in tvars), over
      the size-filtered subset (after the biases-only filter when set).
    - ``train_biases_only``: narrows only the returned
      'training_var_names' and the regularizer's support; the train op
      steps ALL trainables (the reference's var_list call is commented
      out, graph_utils.py:462-470).  v1/v2 honor it in their train op.
    - ``drift_loss``: the L2 distance over tvars to the weights as loaded
      (graph_utils.py:436-441), a callable.
    - ``train`` steps every trainable and advances the BN moving
      statistics; ``train_coord`` then reverts the coordinates its masks
      leave False, while the Adam slots advance.
    """
    dev = resolve_device(device)
    if class_weights is not None:
        class_indices = _class_indices(class_weights)
    else:
        class_indices = np.arange(num_classes)
    ci_t = torch.as_tensor(class_indices, dtype=torch.long, device=dev)
    ci = tuple(int(c) for c in class_indices)
    n_sel = len(class_indices)
    params = _load_student(meta_dir, num_classes, dev)
    chk0 = {k: v.clone() for k, v in params.items()}   # drift anchor

    drift_names = _v3_tvar_names(params)                # pre-biases filter
    tvar_names = _v3_tvar_names(params, train_biases_only)

    def _teacher(teacher_logits):
        if soft_teacher and teacher_logits is not None:
            return _tensor(teacher_logits, dev).float()
        return None

    def _reg(p):
        return 0.01 * torch.mean(torch.stack([_l2_loss(p[k])
                                              for k in tvar_names]))

    @torch.no_grad()
    def logits_fn(params, frames):
        return student_logits(params, _tensor(frames, dev).float(),
                              train=True)

    def predictions_fn(params, frames):
        return torch.argmax(logits_fn(params, frames).index_select(-1, ci_t),
                            -1).to(torch.int32)

    @torch.no_grad()
    def loss_fn(params, frames, labels, teacher_logits=None):
        loss, _ = distill_loss(params, _tensor(frames, dev), _tensor(
            labels, dev), ci, num_classes, train=True,
            teacher_logits=_teacher(teacher_logits))
        return loss + _reg(params) if regularize else loss

    def loss_sel_fn(params, frames, labels):
        lg = logits_fn(params, frames).index_select(-1, ci_t)
        red, w, _ = reduce_labels(_tensor(labels, dev), ci, num_classes)
        return selective_loss(lg, red, w, n_sel)

    @torch.no_grad()
    def drift_fn(params):
        return sum(torch.sum(torch.square(params[k] - chk0[k]))
                   for k in drift_names)

    def miou_update_fn(params, frames, labels):
        preds = predictions_fn(params, frames)
        red, w, _ = reduce_labels(_tensor(labels, dev), ci, num_classes)
        return confusion_matrix(red, preds, n_sel, w)

    def opt_init():
        return adam_init(split_params(params)[0])

    def _step(params_all, opt_state, frames, labels, lr, masks,
              teacher_logits):
        sub, bn_state = split_params(params_all)
        frames, labels = _tensor(frames, dev), _tensor(labels, dev)

        def f(s):
            merged = dict(s)
            merged.update(bn_state)
            stats_cap = {}
            loss, _ = distill_loss(merged, frames, labels, ci, num_classes,
                                   train=True,
                                   teacher_logits=_teacher(teacher_logits),
                                   stats_out=stats_cap)
            return (loss + _reg(merged) if regularize else loss), stats_cap

        (loss, stats_cap), grads = _grads(f, sub)
        with torch.no_grad():
            stepped, opt_state = adam_apply(sub, grads, opt_state, lr)
            if masks is not None:
                stepped = {k: torch.where(_tensor(masks[k], dev), stepped[k],
                                          sub[k]) for k in stepped}
            out = {k: layers.moving_average_update(
                bn_state[k], stats_cap[k], n_elems=1,
                decay=layers.BN_DECAY, bessel=False) for k in bn_state}
        out.update(stepped)
        return out, opt_state, loss.detach()

    def train_fn(params, opt_state, frames, labels, lr, teacher_logits=None):
        return _step(params, opt_state, frames, labels, lr, None,
                     teacher_logits)

    def train_coord_fn(params, opt_state, frames, labels, lr, masks,
                       teacher_logits=None):
        return _step(params, opt_state, frames, labels, lr, masks,
                     teacher_logits)

    def _max_softmax(lg):
        return torch.amax(torch.softmax(lg, -1), -1)

    return {
        "params": params,
        "class_indices": class_indices,
        "logits": logits_fn,
        "logits_reduced": lambda p, f: logits_fn(p, f).index_select(-1,
                                                                    ci_t),
        "predictions": predictions_fn,
        "probabilities": lambda p, f: _max_softmax(logits_fn(p, f)),
        "probabilities_reduced": lambda p, f: _max_softmax(
            logits_fn(p, f).index_select(-1, ci_t)),
        "loss": loss_fn,
        "loss_sel": loss_sel_fn,
        "drift_loss": drift_fn,
        "update_op": miou_update_fn,   # returns the confusion-matrix delta
        "train": train_fn,
        "train_coord": train_coord_fn,  # masked step; slots still advance
        "opt_init": opt_init,
        "training_var_names": tvar_names,
        "soft_teacher": soft_teacher,
        "masked_gradients": masked_gradients,
        "prepend": "",
    }


def _legacy_student(meta_dir, class_weights, threshold, map_misc,
                    train_biases_only, regularize, num_classes,
                    reg_coeff, reg_sum, dev):
    """Shared v1/v2 machinery: threshold-gated predictions, the legacy loss
    (full-space CE masked by labels < num_classes when class_weights is
    None), and a train op that HONORS train_biases_only via var_list
    (graph_utils.py:616-622, 740-745)."""
    class_indices = None
    if class_weights is not None:
        class_indices = _class_indices(class_weights)
        ci_t = torch.as_tensor(class_indices, dtype=torch.long, device=dev)
        ci = tuple(int(c) for c in class_indices)
    params = _load_student(meta_dir, num_classes, dev)

    tvar_names = trainable_names(params)
    if train_biases_only:
        tvar_names = [k for k in tvar_names if "weight" not in k]

    def logits_fn(params, frames):
        return student_logits(params, _tensor(frames, dev).float(),
                              train=True)

    @torch.no_grad()
    def predictions_fn(params, frames):
        lg = logits_fn(params, frames)
        if class_indices is not None:
            red = lg.index_select(-1, ci_t)
            if threshold is not None:
                probs = torch.softmax(red, -1)
                preds = torch.argmax(probs, -1).to(torch.int32)
                return torch.where(torch.amax(probs, -1) > threshold, preds,
                                   torch.full_like(preds, map_misc))
            return torch.argmax(red, -1).to(torch.int32)
        preds = torch.argmax(lg, -1).to(torch.int32)
        if threshold is not None:
            # the unreduced branch gates on raw logits, not probabilities
            # (graph_utils.py:575-579)
            return torch.where(torch.amax(lg, -1) > threshold, preds,
                               torch.full_like(preds, map_misc))
        return preds

    def base_loss(params, frames, labels):
        lg = logits_fn(params, frames)
        labels = _tensor(labels, dev).long()
        if class_indices is not None:
            red = lg.index_select(-1, ci_t)
            _, w, filtered = reduce_labels(labels, ci, num_classes)
            return masked_mean(softmax_xent_with_soft_labels(red, filtered),
                               w > 0)
        # jax.nn.one_hot: an id outside [0, C) gets an all-zero row
        onehot = (labels[..., None] == torch.arange(
            num_classes, device=dev)).float()
        pixel = softmax_xent_with_soft_labels(lg, onehot)
        return masked_mean(pixel, labels < num_classes)

    def loss_of(params, frames, labels):
        loss = base_loss(params, frames, labels)
        if regularize:
            stack = torch.stack([_l2_loss(params[k]) for k in tvar_names])
            loss = loss + reg_coeff * (torch.sum(stack) if reg_sum
                                       else torch.mean(stack))
        return loss

    @torch.no_grad()
    def loss_fn(params, frames, labels):
        return loss_of(params, frames, labels)

    def opt_init():
        return adam_init({k: params[k] for k in tvar_names})

    def train_fn(params, opt_state, frames, labels, lr):
        """minimize(loss, var_list=tvars): only tvars move or carry slots.

        Deliberately does NOT advance BN moving statistics: the reference's
        v1/v2 train ops are plain minimize() calls with no UPDATE_OPS
        control deps (graph_utils.py:620,742), unlike v3's (:487-496)."""
        def f(sub):
            merged = dict(params)
            merged.update(sub)
            return loss_of(merged, frames, labels)

        loss, grads = _grads(f, {k: params[k] for k in tvar_names})
        new_sub, opt_state = adam_apply({k: params[k] for k in tvar_names},
                                        grads, opt_state, lr)
        out = dict(params)
        out.update(new_sub)
        return out, opt_state, loss.detach()

    def miou_update_fn(params, frames, labels):
        preds = predictions_fn(params, frames)
        labels = _tensor(labels, dev)
        if class_indices is not None:
            red, w, _ = reduce_labels(labels, ci, num_classes)
            return confusion_matrix(red, preds, len(class_indices), w)
        return confusion_matrix(labels.to(torch.int32), preds, num_classes)

    handles = {
        "params": params,
        "logits": torch.no_grad()(logits_fn),
        "predictions": predictions_fn,
        "loss": loss_fn,
        "train": train_fn,
        "opt_init": opt_init,
        "update_op": miou_update_fn,
        "training_var_names": tvar_names,
        "prepend": "",
    }
    if class_indices is not None:
        handles["class_indices"] = class_indices
        handles["logits_reduced"] = lambda p, f: handles["logits"](
            p, f).index_select(-1, ci_t)
    return handles


def create_student_v2(meta_dir, class_weights=None, threshold=None,
                      map_misc=0, test_mode=False, train_biases_only=False,
                      regularize=False, num_classes=19, device=None) -> Dict:
    """Legacy v2 builder (graph_utils.py:535-640): threshold/map_misc
    prediction gate, train op over var_list=tvars (train_biases_only
    honored), regularizer 1e-4 * SUM(l2_loss)."""
    return _legacy_student(meta_dir, class_weights, threshold, map_misc,
                           train_biases_only, regularize, num_classes,
                           reg_coeff=1e-4, reg_sum=True,
                           dev=resolve_device(device))


def create_student(meta_dir, class_weights=None, threshold=None, map_misc=0,
                   test_mode=False, train_biases_only=False,
                   num_classes=19, device=None) -> Dict:
    """Legacy v1 builder (graph_utils.py:643-750): v2 without the
    ``regularize`` kwarg; the in-graph image/label cache variables and the
    ``is_inference`` cond are host-side caches: ``load_image``/``load_label``
    stash arrays, and ``train_cached`` trains on them."""
    handles = _legacy_student(meta_dir, class_weights, threshold, map_misc,
                              train_biases_only, regularize=False,
                              num_classes=num_classes, reg_coeff=0.0,
                              reg_sum=False, dev=resolve_device(device))
    cache = {}

    def load_image(arr):
        cache["image"] = np.asarray(arr)

    def load_label(arr):
        cache["label"] = np.asarray(arr)

    def train_cached(params, opt_state, lr):
        if "image" not in cache or "label" not in cache:
            raise ValueError("load_image/load_label before training "
                             "(is_inference=False path)")
        return handles["train"](params, opt_state, cache["image"],
                                cache["label"], lr)

    handles.update({"load_image": load_image, "load_label": load_label,
                    "train_cached": train_cached, "is_inference": True})
    return handles


def _load_teacher(meta_dir, dev, seed=0):
    # same rule as _load_student: None opts into a seeded init, a missing
    # path raises
    base = init_teacher_params(seed, device="cpu")
    if meta_dir is not None:
        loaded = ckpt.load_any(str(meta_dir))
        loaded = {k.removeprefix("teacher/"): v for k, v in loaded.items()}
        base = ckpt.merge_restore({k: v.numpy() for k, v in base.items()},
                                  loaded)
    return _on(base, dev)


def create_teacher(meta_dir, class_weights=None, test_mode=False,
                   device=None) -> Dict:
    """Teacher bundle (graph_utils.py:129-188): each handle maps padded
    frames (B, H, W, 3) to one output of ``teacher_outputs``."""
    dev = resolve_device(device)
    class_indices = None
    if class_weights is not None:
        class_indices = _class_indices(class_weights)
    params = _load_teacher(meta_dir, dev)

    def run(key):
        @torch.no_grad()
        def f(frames, params=params):
            return teacher_outputs(params, _tensor(frames, dev).float(),
                                   class_indices=class_indices)[key]
        return f

    handles = {"params": params, "predictions": run("predictions"),
               "logits": run("logits"), "probabilities": run("probabilities"),
               "logits_sml": run("logits_sml")}
    if class_indices is not None:
        handles["predictions_reduced"] = run("predictions_reduced")
        handles["weights"] = run("weights")
        handles["predictions_one_hot_reduced"] = run(
            "predictions_one_hot_reduced")
    return handles


def create_teacher_v2(meta_dir, class_weights=False, test_mode=False,
                      device=None) -> Dict:
    """v2 adds a runtime class-index argument (graph_utils.py:191-262)."""
    base = create_teacher(meta_dir, class_weights=None, test_mode=test_mode,
                          device=device)
    params = base["params"]
    dev = next(iter(params.values())).device

    @torch.no_grad()
    def predictions_reduced(frames, class_indices):
        out = teacher_outputs(params, _tensor(frames, dev).float(),
                              class_indices=np.asarray(class_indices))
        return out["predictions_reduced"]

    base["predictions_reduced_fn"] = predictions_reduced
    return base


def create_client(meta_dir_or_params, class_weights=None, threshold=None,
                  map_misc=0, device=None) -> Dict:
    """Inference-only client with colorized output (graph_utils.py:753-805).

    ``threshold``: predictions whose max softmax over the selected classes
    is not above it map to class ``map_misc`` (the reference's confidence
    gate).  ``predictions`` and ``output_colored`` return numpy.
    """
    dev = resolve_device(device)
    cmap = colormap()
    if class_weights is not None:
        class_indices = _class_indices(class_weights)
        cmap = np.take(cmap, class_indices, axis=0)
    else:
        class_indices = np.arange(19)
    ci_t = torch.as_tensor(class_indices, dtype=torch.long, device=dev)
    if isinstance(meta_dir_or_params, dict):
        params = _on(meta_dir_or_params, dev)
    else:
        params = _load_student(meta_dir_or_params, 19, dev)

    @torch.no_grad()
    def predictions_fn(frames):
        lg = student_logits(params, _tensor(frames, dev).float(),
                            train=False)
        red = lg.index_select(-1, ci_t)
        preds = torch.argmax(red, -1).to(torch.int32)
        if threshold is not None:
            conf = torch.amax(torch.softmax(red, -1), -1)
            preds = torch.where(conf > threshold, preds,
                                torch.full_like(preds, map_misc))
        return preds.cpu().numpy()

    def output_colored(frames):
        return cmap[predictions_fn(frames)]

    return {"params": params, "predictions": predictions_fn,
            "output_colored": output_colored}


create_client_temp = create_client
