"""SemanticNetwork for the deployed edge client, in PyTorch.

Counterpart of ``ams_tpu/runtime/network.py`` restricted to the deployed
client (``frozen=True``): the same constructor arguments and the client's
methods -- ``predict_input``, ``predict_with_metric(_seq)``,
``apply_downlink``, ``get_vars``, ``save_to_frozen_graph``, ``close_model``,
``colorize``, ``colorize_teacher`` and ``cross_ignore``.  The server side
(training, cross-mIoU, restores) belongs to later slices of the port and
raises ``NotImplementedError``.

Parameters live on the device as a flat dict of TF-named, TF-shaped
tensors.  A client that consumes deltas stays unfolded (the wire is keyed
on the raw variable names); a BN-folded ``.npz`` artifact loads as a
folded client, inference only.  ``predict_input`` ends in the fused
resize+argmax kernel on either form.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ams_tpu_torch.convert import params_to_numpy
from ams_tpu_torch.distill.train_step import (
    make_predict_fn,
    make_predict_seq_fn,
)
from ams_tpu_torch.models.frozen import (
    fold_student,
    is_folded,
    make_predict_fn_folded,
    make_predict_seq_fn_folded,
    student_predict_fast_folded,
)
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    init_student_params,
    student_predict_fast,
)
from ams_tpu_torch.stream.codec import apply_delta, decode_delta
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.colormap import colormap
from ams_tpu_torch.utils.metrics import calculate_miou
from ams_tpu_torch.utils.platform import resolve_device

_SERVER_SLICE = ("belongs to the server side, a later slice of the port "
                 "(ROADMAP queue A, items 5 and 7); this SemanticNetwork is "
                 "the deployed client (frozen=True)")


def _load_checkpoint(path: str) -> dict:
    """.npy dict or .npz snapshot, with or without its extension."""
    for cand in (path, path + ".npz", path + ".npy"):
        if cand.endswith((".npz", ".npy")) and os.path.exists(cand):
            return ckpt.load_params(cand)
    if os.path.exists(path + ".index") or os.path.isdir(path):
        raise NotImplementedError(
            "TF1 and Orbax checkpoints are a later slice of the port; "
            "convert %r to .npz or .npy" % path)
    raise FileNotFoundError(path)


class SemanticNetwork:
    """One deployed student client."""

    TOTAL_CLASSES = 19
    WHITE = np.array([255, 255, 255], dtype=np.uint8)
    BLACK = np.array([0, 0, 0], dtype=np.uint8)

    def __init__(self, meta_dir, class_weights_exp=None, height=None,
                 frozen=False, scale=None, mini_batch_size=None, lr=None,
                 coord_frac=0.1, cross_miou_compat=False,
                 over_ride_total_classes=None, compute_dtype="float32",
                 conv_precision="auto", seed=0, device=None, **_unused):
        if height is None:
            raise ValueError("No height is given")
        if class_weights_exp is None:
            raise ValueError("No class weights specified")
        if not frozen:
            raise NotImplementedError("a trainable network " + _SERVER_SLICE)
        if cross_miou_compat:
            raise NotImplementedError("calc_cross_miou " + _SERVER_SLICE)
        if str(compute_dtype) != "float32":
            raise NotImplementedError(
                "compute_dtype %r: the port computes in float32; the bf16 "
                "path is a later slice" % (compute_dtype,))
        if over_ride_total_classes is not None:
            self.TOTAL_CLASSES = over_ride_total_classes

        # the training arguments (scale, mini_batch_size, lr, coord_frac,
        # conv_precision) are accepted for signature parity and unused by
        # a deployed client
        self.height = int(height)
        self.frozen = frozen
        self.meta_dir = meta_dir
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

        cw = np.asarray(class_weights_exp).reshape(-1)
        if cw.shape != (self.TOTAL_CLASSES,):
            raise ValueError("class weights of shape %s for %d classes"
                             % (cw.shape, self.TOTAL_CLASSES))
        self.class_weights_graph = cw
        self.class_indices_graph = np.where(cw == 1)[0]
        self.class_count = len(self.class_indices_graph)
        if self.class_count == 0:
            raise ValueError("class weights select no class")

        self.color_map_reduced_ = np.take(colormap(), self.class_indices_graph,
                                          axis=0)
        # full-id -> reduced-id lookup, 0 for unselected (cross_ignore path,
        # reference SemanticNetwork.py:58-61)
        take = np.cumsum(cw) * cw
        self.take_array = np.where(take != 0, take - 1, take).astype(int)

        self.process_lock = threading.Lock()

        # --- parameters -------------------------------------------------
        if isinstance(meta_dir, dict):
            self.params = self._to_device(meta_dir)
        elif str(meta_dir) == "synthetic":
            # seeded random init by NAME only: a missing file path raises
            self.params = init_student_params(
                seed, num_classes=self.TOTAL_CLASSES, device=self.device)
        else:
            loaded = _load_checkpoint(str(meta_dir))
            if is_folded(loaded):
                # BN-folded deployment artifact: its key set intentionally
                # differs from the trainable inventory
                self.params = self._to_device(loaded)
            else:
                base = params_to_numpy(init_student_params(
                    seed, num_classes=self.TOTAL_CLASSES, device="cpu"))
                self.params = self._to_device(
                    ckpt.merge_restore(base, loaded))
        self._folded = is_folded(self.params)
        self._initial_params = dict(self.params)

        ci = tuple(int(c) for c in self.class_indices_graph)
        self._class_indices = ci
        if self._folded:
            self._predict = make_predict_fn_folded(self.TOTAL_CLASSES, ci)
            self._predict_seq = make_predict_seq_fn_folded(
                self.TOTAL_CLASSES, ci)
            self._fast = student_predict_fast_folded
        else:
            self._predict = make_predict_fn(self.TOTAL_CLASSES, ci,
                                            train_bn=False)
            self._predict_seq = make_predict_seq_fn(self.TOTAL_CLASSES, ci,
                                                    train_bn=False)
            self._fast = student_predict_fast

    def _to_device(self, d) -> dict:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v))).to(self.device)
                for k, v in d.items()}

    def _stage_frames(self, frames: np.ndarray) -> torch.Tensor:
        """uint8 frames travel to the device as uint8 (4x less traffic; the
        forward casts there), anything else as f32."""
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if t.dtype != torch.uint8:
            t = t.float()
        return t.to(self.device)

    def _stage_labels(self, labels) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(labels).astype(np.int64)).to(self.device)

    # ------------------------------------------------------------------ API

    def predict_input(self, frames):
        """(B, H, W, 3) frames -> (B, H, W) int32 ids in the reduced space."""
        frames = np.asarray(frames)
        with self.process_lock, torch.inference_mode():
            preds = self._fast(self.params, self._stage_frames(frames),
                               self._class_indices)
            labels_ = preds.cpu().numpy()
        if labels_.shape != frames.shape[:-1]:
            raise RuntimeError("prediction shape %s for frames %s"
                               % (labels_.shape, frames.shape))
        return labels_

    def predict_with_metric(self, frames, labels_teacher):
        frames = np.asarray(frames)
        with self.process_lock, torch.inference_mode():
            preds, cm, loss = self._predict(
                self.params, self._stage_frames(frames),
                self._stage_labels(labels_teacher))
            labels_student = preds.cpu().numpy()
            conf_mat_ = cm.cpu().numpy()
            loss = float(loss)
        iou_ = calculate_miou(conf_mat_, nan=True)
        miou_ = np.nanmean(iou_)
        return labels_student, conf_mat_, iou_, miou_, loss

    def predict_with_metric_seq(self, frames, labels_teacher):
        """Per-frame scoring for a batch of frames in one call: returns
        (labels (B,H,W), confusion matrices (B,C,C), per-frame mIoUs (B,),
        per-frame losses (B,)).  Frozen batch norm keeps frames
        independent, so no frame's numbers depend on the batch.  (The JAX
        package pads the batch to a power of two to bound retracing; eager
        PyTorch has nothing to retrace, so the batch runs as given.)"""
        frames = np.asarray(frames)
        labels_teacher = np.asarray(labels_teacher)
        n = frames.shape[0]
        if n < 1 or labels_teacher.shape[0] != n:
            raise ValueError("%d frames with %d label maps"
                             % (n, labels_teacher.shape[0]))
        with self.process_lock, torch.inference_mode():
            preds, cm_f, loss_f = self._predict_seq(
                self.params, self._stage_frames(frames),
                self._stage_labels(labels_teacher))
            labels_student = preds.cpu().numpy()
            conf_mats = cm_f.cpu().numpy()
            losses = loss_f.cpu().numpy()
        mious = np.array([np.nanmean(calculate_miou(c, nan=True))
                          for c in conf_mats])
        return labels_student, conf_mats, mious, losses

    def get_vars(self):
        return params_to_numpy(self.params)

    def apply_downlink(self, blob: bytes, strategy: str = "full_model",
                       wire_dtype: str = "float16",
                       base_initial: bool = False):
        """Edge-device update path: decode a delta payload on the host and
        overlay the masked values onto the weights.

        ``base_initial=True`` overlays onto the INITIAL deployment snapshot
        instead of the current weights, mirroring the server's
        restore_initial before every round (run.py:309-310); ``int8d``
        requires it, since its values are relative to that snapshot."""
        if self._folded:
            raise ValueError(
                "downlink deltas are keyed on raw variable names; the "
                "delta-consuming client must be deployed with fold=False")
        with self.process_lock:
            if base_initial:
                host = params_to_numpy(self._initial_params)
            else:
                host = self.get_vars()
            shapes = {k: v.shape for k, v in host.items()}
            kw = {}
            if wire_dtype == "int8d":
                if not base_initial:
                    raise ValueError(
                        "wire_dtype 'int8d' is delta-vs-initial: only valid "
                        "for restore-mode sessions (base_initial=True)")
                kw["base"] = host
            masks, values = decode_delta(blob, shapes, strategy=strategy,
                                         wire_dtype=wire_dtype, **kw)
            self.params = self._to_device(apply_delta(host, masks, values))

    def save_to_frozen_graph(self, save_dir, fold: bool = True):
        """Write the deployable client model as ``save_dir + ".npz"``; BNs
        folded into their convs unless ``fold=False``."""
        host = self.get_vars()
        if fold and not self._folded:
            host = params_to_numpy(fold_student(host))
        np.savez(save_dir + ".npz", **host)

    def close_model(self):
        """Drop the device parameters; the object cannot predict after."""
        self.params = {}
        self._initial_params = {}

    # -------------------------------------------------- later slices

    def train_with_deque(self, *args, **kwargs):
        raise NotImplementedError("train_with_deque " + _SERVER_SLICE)

    def calc_cross_miou(self, *args, **kwargs):
        raise NotImplementedError("calc_cross_miou " + _SERVER_SLICE)

    def calc_cross_miou_seq(self, *args, **kwargs):
        raise NotImplementedError("calc_cross_miou_seq " + _SERVER_SLICE)

    def restore(self, *args, **kwargs):
        raise NotImplementedError("restore " + _SERVER_SLICE)

    # ------------------------------------------------------- visualization

    def colorize(self, frame=None, label=None):
        assert frame is not None or label is not None
        assert frame is None or frame.shape == (self.height, self.height * 2, 3)
        if label is None:
            label = self.predict_input(np.expand_dims(frame, axis=0))[0]
        assert label.shape == (self.height, self.height * 2)
        label_colored = self.color_map_reduced_[label]
        if frame is not None:
            blend = (frame.astype(np.uint16) + label_colored.astype(np.uint16))
            return label_colored, (blend // 2).astype(np.uint8)
        return label_colored

    def colorize_teacher(self, label, frame=None):
        assert frame is None or frame.shape == (self.height, self.height * 2, 3)
        assert label.shape == (self.height, self.height * 2)
        label_colored = colormap()[label]
        if frame is not None:
            blend = (frame.astype(np.uint16) + label_colored.astype(np.uint16))
            return label_colored, (blend // 2).astype(np.uint8)
        return label_colored

    def cross_ignore(self, label_teacher, label_student=None,
                     frame_student=None):
        assert label_student is not None or frame_student is not None
        assert label_teacher.shape == (self.height, self.height * 2)
        label_teacher_reduced = self.take_array[label_teacher]
        if label_student is None:
            label_student = self.predict_input(
                np.expand_dims(frame_student, axis=0))[0]
        assert label_student.shape == (self.height, self.height * 2)
        ignore_mask = np.where(
            np.expand_dims(label_teacher_reduced, -1) == 0, self.WHITE,
            self.BLACK)
        colorized = self.colorize(label=label_teacher_reduced)
        cross_cond = np.logical_and(
            np.logical_not(ignore_mask[:, :, :1]),
            np.expand_dims(np.not_equal(label_teacher_reduced, label_student),
                           -1))
        cross_mask = np.where(cross_cond, colorized, self.BLACK)
        assert ignore_mask.shape == cross_mask.shape
        return cross_mask, ignore_mask
