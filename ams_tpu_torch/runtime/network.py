"""SemanticNetwork, the model-runtime facade, in PyTorch.

Counterpart of ``ams_tpu/runtime/network.py`` with the same constructor
arguments and public methods:

- the deployed client (``frozen=True``): ``predict_input``,
  ``predict_with_metric(_seq)``, ``apply_downlink``, ``get_vars``,
  ``save_to_frozen_graph``, ``close_model``, ``colorize``,
  ``colorize_teacher`` and ``cross_ignore``.  A client that consumes deltas
  stays unfolded (the wire is keyed on the raw variable names); a BN-folded
  ``.npz`` artifact loads as a folded client, inference only.
  ``predict_input`` ends in the fused resize+argmax kernel on either form;
- the server (``frozen=False``): ``train_with_deque`` (one distillation
  round over the frame memory, ``distill.train_step``), with the post-round
  ``curr_mask``/``train_params`` delta pieces, ``restore_initial``,
  ``restore``, ``initial_vars``, ``stats_vars``, ``set_restore_target`` and
  ``calc_cross_miou(_seq)``.  Its predictions run training-mode batch norm,
  as the reference's server graph does.

``compute_dtype="bfloat16"`` runs a frozen client (folded or not) in bf16
storage with f32 accumulation, and a server's round and predictions in
mixed precision (bf16 convolutions; f32 weights, Adam slots, BN
statistics and loss), as the JAX facade does.  As in JAX, the facade has no
``fused_blocks`` knob: the fused MBConv variants are reached through
``models.frozen.student_predict_fast_folded``.

Parameters live on the device as a flat dict of TF-named, TF-shaped
tensors.  ``fused_loss=True`` runs the round's loss through the fused
upsample+CE kernel (``ops.fused_resize_ce``); the JAX facade accepts the
keyword and ignores it.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ams_tpu_torch.convert import masks_from_numpy, masks_to_numpy, params_to_numpy
from ams_tpu_torch.distill.loss import reduce_labels
from ams_tpu_torch.distill.strategies import build_mask, mask_coverage
from ams_tpu_torch.distill.train_step import (
    DistillSpec,
    adam_init,
    all_true_mask,
    make_distill_round,
    make_predict_fn,
    make_predict_seq_fn,
    split_params,
)
from ams_tpu_torch.models.frozen import (
    fold_student,
    is_folded,
    make_predict_fn_folded,
    make_predict_seq_fn_folded,
    student_predict_fast_folded,
)
from ams_tpu_torch.models.layers import as_dtype
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    init_student_params,
    student_predict_fast,
)
from ams_tpu_torch.models.var_order import STATS_ORDER
from ams_tpu_torch.stream.codec import apply_delta, decode_delta, delta_order
from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.colormap import colormap
from ams_tpu_torch.utils.metrics import (
    calculate_miou,
    confusion_matrix,
    confusion_matrix_per_frame,
)
from ams_tpu_torch.utils.platform import resolve_device
from ams_tpu_torch.utils.trace import GLOBAL_TIMER


class SemanticNetwork:
    """One student model instance (trainable server copy or frozen
    client)."""

    TOTAL_CLASSES = 19
    WHITE = np.array([255, 255, 255], dtype=np.uint8)
    BLACK = np.array([0, 0, 0], dtype=np.uint8)

    def __init__(self, meta_dir, class_weights_exp=None, height=None,
                 frozen=False, scale=None, mini_batch_size=None, lr=None,
                 coord_frac=0.1, cross_miou_compat=False,
                 over_ride_total_classes=None, compute_dtype="float32",
                 conv_precision="auto", seed=0, fused_loss=False,
                 device=None, **_unused):
        if height is None:
            raise ValueError("No height is given")
        if class_weights_exp is None:
            raise ValueError("No class weights specified")
        if not frozen and None in (scale, mini_batch_size, lr):
            raise ValueError("Training parameters must be specified for "
                             "non-frozen graph")
        cd = as_dtype(compute_dtype)
        if over_ride_total_classes is not None:
            self.TOTAL_CLASSES = over_ride_total_classes

        self.lr = lr
        self.mini_batch_size = mini_batch_size
        self.scale = scale
        self.coord_frac = float(coord_frac)
        self.height = int(height)
        self.frozen = frozen
        self.meta_dir = meta_dir
        self.compute_dtype = compute_dtype
        self.conv_precision = conv_precision
        self.fused_loss = bool(fused_loss)
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
        self._round_cache = {}
        self._pinned_blocks = set()     # host blocks _download_ids was handed

        # --- parameters -------------------------------------------------
        if isinstance(meta_dir, dict):
            self.params = self._to_device(meta_dir)
        elif str(meta_dir) == "synthetic":
            # seeded random init by NAME only: a missing file path raises
            self.params = init_student_params(
                seed, num_classes=self.TOTAL_CLASSES, device=self.device)
        else:
            loaded = ckpt.load_any(str(meta_dir))
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
        if self._folded and not frozen:
            raise ValueError("BN-folded artifacts are inference-only "
                             "(deployed client)")
        self._initial_params = dict(self.params)

        ci = tuple(int(c) for c in self.class_indices_graph)
        self._class_indices = ci
        if self._folded:
            self._predict = make_predict_fn_folded(self.TOTAL_CLASSES, ci,
                                                   compute_dtype=cd)
            self._predict_seq = make_predict_seq_fn_folded(
                self.TOTAL_CLASSES, ci, compute_dtype=cd)
            self._fast = functools.partial(student_predict_fast_folded,
                                           compute_dtype=cd)
        else:
            # a server (non-frozen) network predicts with training-mode
            # batch norm, as the reference's imported graph does
            self._predict = make_predict_fn(self.TOTAL_CLASSES, ci,
                                            train_bn=not frozen,
                                            compute_dtype=cd)
            self._predict_seq = make_predict_seq_fn(
                self.TOTAL_CLASSES, ci, train_bn=not frozen,
                compute_dtype=cd)
            self._fast = functools.partial(student_predict_fast,
                                           compute_dtype=cd)

        if not frozen:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(seed))
            self.opt_state = adam_init(split_params(self.params)[0])
            self.mask = None
            self.curr_mask = None
            self.train_params = None
            self.last_losses = None
        self.cross_miou_compat = cross_miou_compat

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

    def _download_ids(self, preds: torch.Tensor) -> np.ndarray:
        """The ids home, as a numpy array that owns its memory.

        From a CUDA device they land in a page-locked block of PyTorch's
        caching host allocator, filled by one blocking copy.  The array
        holds the block for as long as the caller keeps it; dropped, the
        block goes back to the allocator, which hands it, resident and
        registered with CUDA, to the next request of its size.  A
        blocking copy records no event on the block, so it is free as
        soon as the array dies.  One buffer reused for every answer
        would overwrite the answers callers keep.

        Counts ``network/pinned_download`` for each such download and
        ``network/pinned_fresh`` for each block this network had not been
        handed before (a new ``cudaHostAlloc``).  On the CPU the answer is
        ``preds``' own memory.  Call under ``process_lock``."""
        if preds.device.type != "cuda":
            return preds.cpu().numpy()
        host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
        host.copy_(preds)
        GLOBAL_TIMER.count("network/pinned_download")
        if host.data_ptr() not in self._pinned_blocks:
            self._pinned_blocks.add(host.data_ptr())
            GLOBAL_TIMER.count("network/pinned_fresh")
        return host.numpy()

    # ------------------------------------------------------------------ API

    def predict_input(self, frames):
        """(B, H, W, 3) frames -> (B, H, W) int32 ids in the reduced space.

        Spans: ``network/predict_input`` (the request), inside it
        ``network/stage`` (the upload), ``network/forward`` (the forward
        and K1 enqueued) and ``network/download`` (the wait for the
        device and the copy of the ids, ``_download_ids``)."""
        frames = np.asarray(frames)
        with GLOBAL_TIMER.span("network/predict_input"), \
                self.process_lock, torch.inference_mode():
            with GLOBAL_TIMER.span("network/stage"):
                staged = self._stage_frames(frames)
            with GLOBAL_TIMER.span("network/forward"):
                if self.frozen:
                    preds = self._fast(self.params, staged,
                                       self._class_indices)
                else:
                    preds, _, _ = self._predict(
                        self.params, staged,
                        torch.zeros(frames.shape[:-1], dtype=torch.long,
                                    device=self.device))
            with GLOBAL_TIMER.span("network/download"):
                labels_ = self._download_ids(preds)
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
            labels_student = self._download_ids(preds)
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
        if not self.frozen:
            raise ValueError(
                "predict_with_metric_seq requires a frozen network "
                "(batch-stat BN couples frames); score per frame on "
                "training-mode graphs")
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
            labels_student = self._download_ids(preds)
            conf_mats = cm_f.cpu().numpy()
            losses = loss_f.cpu().numpy()
        mious = np.array([np.nanmean(calculate_miou(c, nan=True))
                          for c in conf_mats])
        return labels_student, conf_mats, mious, losses

    def get_vars(self):
        return params_to_numpy(self.params)

    def get_frozen_graph(self):
        return self.get_vars()

    # ------------------------------------------------------------ restores

    def restore_initial(self):
        """Reset to the pretrained weights (optimizer slots persist, like
        the reference's Adam-filtered restore)."""
        self.params = dict(self._initial_params)

    def restore(self, chk):
        """Overlay a checkpoint (.npz/.npy path, or a name -> array dict)
        onto the current weights."""
        loaded = ckpt.load_any(chk) if isinstance(chk, str) else chk
        self.params = self._to_device(
            ckpt.merge_restore(self.get_vars(), loaded))

    def initial_vars(self):
        """Host copy of the restore_initial target, what every per-round
        delta is relative to when the run trains with restore."""
        return params_to_numpy(self._initial_params)

    def stats_vars(self):
        """Host copy of only the BN moving statistics (the stats-annex
        payload of the delta codec)."""
        return params_to_numpy({k: self.params[k] for k in STATS_ORDER
                                if k in self.params})

    def set_restore_target(self, params) -> None:
        """Override the restore_initial target (the live resume protocol's
        delta base)."""
        self._initial_params = self._to_device(params)

    # ---------------------------------------------------------- cross-mIoU

    def _cross_cms(self, before, after):
        """Confusion matrices of consecutive teacher label maps in the
        reduced space, weighted by both maps' validity: (n, C, C)."""
        if self.frozen and not self.cross_miou_compat:
            raise ValueError("calc_cross_miou needs a server network or "
                             "cross_miou_compat=True")
        ci = self._class_indices
        with torch.inference_mode():
            br, bw, _ = reduce_labels(self._stage_labels(before), ci,
                                      self.TOTAL_CLASSES)
            ar, aw, _ = reduce_labels(self._stage_labels(after), ci,
                                      self.TOTAL_CLASSES)
            return confusion_matrix_per_frame(br, ar, self.class_count,
                                              bw * aw).cpu().numpy()

    def calc_cross_miou(self, labels):
        """Temporal cross-mIoU between two consecutive teacher label maps
        (the ASR phi score)."""
        labels = np.asarray(labels)
        if labels.shape != (2, self.height, 2 * self.height):
            raise ValueError("labels of shape %s" % (labels.shape,))
        with self.process_lock:
            cm = self._cross_cms(labels[:1], labels[1:])[0]
        iou_ = calculate_miou(cm, nan=True)
        return cm, iou_, np.nanmean(iou_)

    def calc_cross_miou_seq(self, labels_seq):
        """Cross-mIoU phi scores for every consecutive pair of a label
        sequence (n, height, 2*height) -> list of n-1 floats."""
        labels_seq = np.asarray(labels_seq)
        if labels_seq.shape[1:] != (self.height, 2 * self.height):
            raise ValueError("labels of shape %s" % (labels_seq.shape,))
        if labels_seq.shape[0] < 2:
            return []
        with self.process_lock:
            cms = self._cross_cms(labels_seq[:-1], labels_seq[1:])
        return [float(np.nanmean(calculate_miou(c, nan=True))) for c in cms]

    # ------------------------------------------------------------ training

    def _round_fn(self, iters, strategy):
        key = (iters, strategy, self.mini_batch_size, self.class_count,
               self.fused_loss)
        if key not in self._round_cache:
            spec = DistillSpec(
                iters=iters, batch_size=self.mini_batch_size,
                num_classes=self.TOTAL_CLASSES,
                class_indices=self._class_indices,
                strategy=strategy, coord_frac=self.coord_frac,
                compute_dtype=self.compute_dtype,
                conv_precision=self.conv_precision,
                fused_loss=self.fused_loss)
            self._round_cache[key] = make_distill_round(spec)
        return self._round_cache[key]

    def train_with_deque(self, frame_deque, label_deque, num_of_iterations,
                         train_strategy="full_model", keep_mask=False):
        """One distillation round over the frame memory; returns the
        per-iteration losses and leaves the delta pieces in ``curr_mask``
        and ``train_params`` (wire order, ``stream.codec.delta_order``)."""
        if self.frozen:
            raise ValueError("Can't train frozen graph!!!")
        # the round samples uniform frame picks: the only configuration of
        # the reference's run.py (scale=[1], no flip)
        if list(self.scale or [1]) != [1]:
            raise NotImplementedError(
                "train_with_deque implements the reference run.py's "
                "scale=[1] sampling; got scale=%r" % (self.scale,))
        with self.process_lock:
            if not keep_mask:
                self.mask = None
            fbuf, lbuf, n_valid = self._to_device_buffers(frame_deque,
                                                          label_deque)
            round_fn = self._round_fn(num_of_iterations, train_strategy)

            if train_strategy == "coord_desc_auto":
                reselect = self.mask is None
                mask = self.mask if self.mask is not None \
                    else all_true_mask(self.params)
            elif train_strategy == "full_model":
                reselect = False
                mask = all_true_mask(self.params)
            else:
                reselect = False
                if self.mask is None:
                    shapes = {k: tuple(v.shape) for k, v in
                              split_params(self.params)[0].items()}
                    host_mask = build_mask(train_strategy, self.coord_frac,
                                           shapes)
                    total, sel = mask_coverage(host_mask)
                    print("Using %s mode, Training %.3f%% of variables"
                          % (train_strategy, 100 * sel / total))
                    self.mask = masks_from_numpy(host_mask, self.device)
                mask = self.mask

            new_params, self.opt_state, out_mask, losses = round_fn(
                self.params, self.opt_state, fbuf, lbuf, n_valid, self._gen,
                self.lr, mask, reselect=reselect)
            self.params = new_params
            self.last_losses = losses.cpu().numpy()
            host_mask = masks_to_numpy(out_mask)

            if train_strategy == "coord_desc_auto":
                self.mask = out_mask
                total = sum(v.size for v in host_mask.values())
                sel = sum(int(v.sum()) for v in host_mask.values())
                print("Using auto mode, Training %.3f%% of variables"
                      % (100 * sel / total))

            # delta payload pieces in wire order: coord strategies ship the
            # trainable vars under their masks; full_model ships every
            # saveable var with all-ones masks
            host = self.get_vars()
            order = delta_order(train_strategy, present=host)
            if train_strategy.startswith("coord_desc_"):
                self.curr_mask = [host_mask[k] for k in order]
            else:
                self.curr_mask = [np.ones_like(host[k], dtype=bool)
                                  for k in order]
            self.train_params = [host[k] for k in order]
            return self.last_losses

    def _to_device_buffers(self, frame_deque, label_deque):
        """Stage the frame memory as uint8 device buffers -> (frames,
        labels, n).  Lossy uplink codecs can decode one frame more or less
        than the label count, so the memory aligns on the common prefix."""
        frames = list(frame_deque)
        labels = list(label_deque)
        n = min(len(frames), len(labels))
        if n == 0:
            raise ValueError("empty frame memory")
        fbuf = np.zeros((n, self.height, 2 * self.height, 3), np.uint8)
        lbuf = np.zeros((n, self.height, 2 * self.height), np.uint8)
        for i, (f, l) in enumerate(zip(frames[:n], labels[:n])):
            f = np.asarray(f)
            if np.issubdtype(f.dtype, np.floating):
                # a silent uint8 cast would truncate [0,1]-normalized float
                # frames to all-zeros and train on black images
                raise TypeError(
                    "train memory expects uint8 frames (0-255); got dtype "
                    "%s — scale and cast before training" % f.dtype)
            fbuf[i] = f.astype(np.uint8, casting="same_kind")
            lbuf[i] = np.asarray(l, np.uint8)
        return (torch.from_numpy(fbuf).to(self.device),
                torch.from_numpy(lbuf).to(self.device), n)

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
        """Nothing to close (there is no TF graph): drop the cached rounds,
        as the JAX package drops its jit caches.  The weights stay; a
        closed network still predicts, and ``get_vars`` still returns
        them."""
        self._round_cache.clear()

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
