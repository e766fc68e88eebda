"""Client-side inference emulation (reference infer_output, run.py:364-461).

Counterpart of ``ams_tpu/runtime/client.py``, line for line.  Replays the
clip, swaps in the newly deployed student at each load_range point, scores
every frame against the teacher's labels (per-frame loss, confusion
matrices, rolling 10 s-window mIoU) and optionally writes pictures.  Its
artifacts (_loss/_mioucats/_mious/_mioumems .npy) are the JAX package's.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.data.image import bgr_to_rgb, png_write
from ams_tpu_torch.data.video import (
    PrefetchingVideoReader,
    frame_to_rgb,
    load_gt_label,
)
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir, print_process
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.utils.metrics import calculate_miou, string_class_iou
from ams_tpu_torch.utils.trace import GLOBAL_TIMER


def infer_output(cfg: RunConfig, inf_start: int, inf_end: int,
                 run_label: str, gt_path: str, exp_num: int,
                 load_range: List[int]) -> None:
    if inf_end - inf_start == 0:
        raise ValueError("There should be at least one set of data points")
    size = cfg.size
    reader = PrefetchingVideoReader(cfg.input_video)
    fps = reader.fps
    # the loop is second-aligned: a non-integer fps would skip every
    # deploy, and fps < 1 divides by zero in batch_cap_frames
    if not (float(fps).is_integer() and fps >= 1):
        reader.release()
        raise ValueError(
            "infer_output requires an integer fps >= 1 (got %r); re-encode "
            "the clip or fix its fps metadata" % (fps,))
    fps = int(fps)
    inf_end_frame = inf_end * fps
    i = inf_start * fps
    reader.seek_frame(i)

    network = None
    confusion_matrix_memory = deque(maxlen=10 * fps)
    loss_s, miou_cats, miou_s, miou_mem_s = [], [], [], []
    final_save_dir = get_save_dir(cfg, run_label + "_results")

    map_coco = exp_configs.coco_class_converter() \
        if exp_configs.is_coco(exp_num) else None

    # Batched scoring: deploys and load points are second-aligned, and
    # predict_with_metric_seq gives the per-frame numbers of frame-by-frame
    # scoring, so the client scores whole seconds up to the next deploy
    # (at most ~64 frames) in one call.
    batch_cap_frames = max(int(fps), (64 // int(fps)) * int(fps))
    with GLOBAL_TIMER.span("client/loop"):
        while i < inf_end_frame:
            if i / fps in load_range:
                with GLOBAL_TIMER.span("client/load_model"):
                    save_dir = get_save_dir(cfg,
                                            run_label + "_%d" % (i // fps))
                    if network is not None:
                        network.close_model()
                    network = SemanticNetwork(
                        meta_dir=save_dir + "_final",
                        class_weights_exp=exp_configs.class_weights(exp_num),
                        height=cfg.height, frozen=True,
                        compute_dtype=cfg.compute_dtype,
                        over_ride_total_classes=exp_configs.num_classes(
                            exp_num),
                        device=cfg.device)

            stop = min([inf_end_frame] + [int(s * fps) for s in load_range
                                          if s * fps > i])
            n_batch = int(min(stop - i, batch_cap_frames))
            with GLOBAL_TIMER.span("client/decode"):
                frames, gt_frames = [], []
                for j in range(n_batch):
                    frame = reader.read_or_die()
                    frames.append(frame_to_rgb(frame, (size[0], size[1])))
                    gt_frames.append(load_gt_label(
                        gt_path, i + j, size_hw=(size[0], size[1]),
                        coco_map=map_coco))
            with GLOBAL_TIMER.span("client/infer"):
                labels_, conf_mats, mious, losses = \
                    network.predict_with_metric_seq(np.stack(frames),
                                                    np.stack(gt_frames))
            for j in range(n_batch):
                loss_s.append(float(losses[j]))
                miou_cats.append(conf_mats[j])
                miou_s.append(mious[j])
                confusion_matrix_memory.append(conf_mats[j])
                miou_mem_s.append(np.nanmean(calculate_miou(
                    np.sum(list(confusion_matrix_memory), axis=0), nan=True)))
                k = i + j + 1  # 1-based frame counter, as the reference prints
                if k % fps == 0:
                    miou = np.nanmean(calculate_miou(
                        np.sum(miou_cats[-fps:], axis=0), nan=True))
                    print_process("miou at %03d secs: %.1f%%"
                                  % (k / fps, float(miou) * 100), k / fps)
                    iou_class, pop_class, false_neg, false_pos = \
                        calculate_miou(np.sum(miou_cats[-fps:], axis=0),
                                       population=True, detailed=True)
                    print_process("\n\n%s" % string_class_iou(
                        [iou_class, false_neg, false_pos],
                        population=pop_class,
                        headers=["Class IoU", "False Negative",
                                 "False Positive"],
                        class_weights=exp_configs.class_weights(exp_num),
                        labels=exp_configs.class_labels(exp_num)), k / fps)
            i += n_batch

            if cfg.save_pic:
                for j in range(n_batch):
                    frame, gt_frame = frames[j], gt_frames[j]
                    # reference path naming: the truncated second of the
                    # 1-based frame counter
                    save_dir_pic = final_save_dir + \
                        ("_%d_" % ((i - n_batch + j + 1) / fps))
                    # the JAX package swaps RGB->BGR before cv2.imwrite, which
                    # writes BGR arrays as RGB: the same swap gives its bytes
                    cross_mask, ignore_mask = network.cross_ignore(
                        label_teacher=gt_frame, label_student=labels_[j])
                    png_write(save_dir_pic + "cross_mask.png",
                              bgr_to_rgb(cross_mask))
                    png_write(save_dir_pic + "ignore_mask.png",
                              bgr_to_rgb(ignore_mask))
                    overlay_t, output_t = network.colorize_teacher(
                        label=gt_frame, frame=frame)
                    png_write(save_dir_pic + "overlay_teacher.png",
                              bgr_to_rgb(overlay_t))
                    png_write(save_dir_pic + "output_teacher.png",
                              bgr_to_rgb(output_t))
                    overlay_s, output_s = network.colorize(label=labels_[j],
                                                           frame=frame)
                    png_write(save_dir_pic + "output_student.png",
                              bgr_to_rgb(output_s))
                    png_write(save_dir_pic + "overlay_student.png",
                              bgr_to_rgb(overlay_s))
                    png_write(save_dir_pic + "frame.png", bgr_to_rgb(frame))
                    png_write(save_dir_pic + "label_student.png",
                              np.asarray(labels_[j]).astype(np.uint8))

    np.save("%s_loss.npy" % final_save_dir, loss_s)
    np.save("%s_mioucats.npy" % final_save_dir, miou_cats)
    np.save("%s_mious.npy" % final_save_dir, miou_s)
    np.save("%s_mioumems.npy" % final_save_dir, miou_mem_s)
    reader.release()
    if network is not None:
        network.close_model()
