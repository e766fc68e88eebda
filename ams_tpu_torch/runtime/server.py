"""Server-side training emulation (reference train_model, run.py:78-361).

Counterpart of ``ams_tpu/runtime/server.py``, line for line.  Replays the
clip at its fps, buckets frames, samples every send_period seconds through
choose_frames, feeds the (optionally H.264-degraded) samples into the
frame memory, and at each scheduled event runs a distillation round,
encodes the model delta (downlink accounting) and exports the deployable
client model.  ASR/ATR controllers adapt the sampling/training rates when
enabled.

It writes the JAX package's artifacts under the same names:
*_fps_client/_bw_uplink/_uplink_exact/_bw_downlink/_model_update_times
.npy, the *_update.txt bandwidth summary, *_mask.dat.gz delta payloads,
per-event deployable models (.npz) and the resume bundle.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.data.buffers import FrameMemory, choose_frames
from ams_tpu_torch.data.image import resize_linear_u8, resize_nearest
from ams_tpu_torch.data.video import (
    PrefetchingVideoReader,
    frame_to_rgb,
    load_gt_label,
)
from ams_tpu_torch.runtime import resume as resume_mod
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir, print_process
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.stream import uplink as uplink_codec
from ams_tpu_torch.stream.codec import delta_order, encode_delta
from ams_tpu_torch.stream.controllers import ASRController, ATRController
from ams_tpu_torch.utils.trace import GLOBAL_TIMER


def train_model(cfg: RunConfig, train_start: int, train_end: int,
                sampling_period: int, run_label: str, gt_path: str,
                exp_num: int, save_range: List[int],
                sample_send_period: int) -> None:
    """Emulate the server over [train_start, train_end) seconds of video."""
    if train_end - train_start == 0:
        raise ValueError("There should be at least one set of data points")
    size = cfg.size
    # decode ahead on a worker thread so decode overlaps device compute
    reader = PrefetchingVideoReader(cfg.input_video)
    fps = reader.fps
    train_end_frame = train_end * fps
    i = train_start * fps
    reader.seek_frame(i)

    update_count = 0
    trained_seconds = set()  # the reference re-enters its training branch
    # for every FRAME of an event second (run.py:278); the JAX package and
    # the port train once per scheduled second
    send_rate = sampling_period / fps
    sample_per_period: List[int] = []
    up_bw_per_period: List[float] = []
    up_codec_exact: List[bool] = []
    down_bw_per_period: List[float] = []
    frame_label_bucket = []
    num_unseen_frames = 0
    model_save_times = [0.0]
    save_range = list(save_range)

    asr = ASRController(send_rate) if cfg.enable_ASR else None
    atr = None
    if cfg.enable_ATR:
        base_period = save_range[2] - save_range[1]
        if base_period != cfg.train_period or any(
                save_range[j] - save_range[j - 1] != base_period
                for j in range(2, len(save_range))):
            raise ValueError("ATR needs a schedule of one train_period")
        atr = ATRController(base_period)

    map_coco = exp_configs.coco_class_converter() \
        if exp_configs.is_coco(exp_num) else None

    capacity = int(cfg.memory_len / sampling_period * fps)
    memory = FrameMemory(capacity, size[0], size[1])
    to_compress: List[np.ndarray] = []
    labels_pending: List[np.ndarray] = []  # staged until the codec returns
    # this period's decoded frames, so only matched pairs enter the memory
    label_memory = memory.labels

    with GLOBAL_TIMER.span("server/load_model"):
        network = SemanticNetwork(
            meta_dir=cfg.student_checkpoint,
            class_weights_exp=exp_configs.class_weights(exp_num),
            height=cfg.height, scale=[1], mini_batch_size=cfg.batch_size,
            lr=cfg.lr, coord_frac=cfg.coord_fraction,
            cross_miou_compat=cfg.enable_ASR,
            compute_dtype=cfg.compute_dtype,
            conv_precision=cfg.conv_precision,
            over_ride_total_classes=exp_configs.num_classes(exp_num),
            device=cfg.device)

    resume_prefix = get_save_dir(cfg, run_label)
    bundle = resume_mod.load_state(resume_prefix) if cfg.resume else None

    save_dir = get_save_dir(cfg, run_label + "_%d" % train_start)
    if bundle is None:
        # only on a fresh run: a resumed run never revisits its first event
        network.save_to_frozen_graph(save_dir + "_final",
                                     fold=cfg.fold_deploy)
        print_process("Saved model to %s_final.npz" % save_dir, 0)
    else:
        arrays, meta = bundle
        resume_mod.restore_network(network, arrays)
        resume_mod.restore_memory(memory, arrays)
        i = int(meta["second"])
        reader.seek_frame(i)
        send_rate = meta["send_rate"]
        if asr is not None:
            asr.send_rate = send_rate  # the controller continues
        sample_per_period = list(meta["sample_per_period"])
        up_bw_per_period = list(meta["up_bw"])
        up_codec_exact = list(meta.get("up_codec_exact",
                                       [True] * len(up_bw_per_period)))
        down_bw_per_period = list(meta["down_bw"])
        model_save_times = list(meta["model_save_times"])
        save_range = list(meta["save_range"])
        trained_seconds = set(meta["trained_seconds"])
        update_count = int(meta["update_count"])
        if atr is not None and meta.get("atr"):
            atr.hibernating = meta["atr"]["hibernating"]
            atr.current = meta["atr"]["current"]
            for r in meta["atr"]["history"]:
                atr.send_rate_history.append(r)
        save_dir = get_save_dir(cfg, run_label + "_%d" % (i // fps))
        print_process("Resumed from frame %d" % i, i / fps)

    with GLOBAL_TIMER.span("server/loop"):
        while i < train_end_frame:
            with GLOBAL_TIMER.span("server/decode"):
                frame = reader.read_or_die()
                gt = load_gt_label(gt_path, i)
            frame_label_bucket.append((frame, gt))

            i += 1
            if i % (5 * fps) == 0:
                print_process("%d seconds elapsed" % (i / fps), i / fps)

            if i // fps % sample_send_period == 0 and frame_label_bucket:
                frames_chosen, labels_chosen = choose_frames(
                    frame_label_bucket, send_rate)
                for frame_c, label_c in zip(frames_chosen, labels_chosen):
                    if cfg.compress_uplink:
                        # higher-res BGR send for the lossy uplink (run.py:179)
                        frame_r = resize_linear_u8(frame_c,
                                                   (size[0] * 2, size[1] * 2))
                    else:
                        frame_r = frame_to_rgb(frame_c, (size[0], size[1]))
                    label_r = resize_nearest(label_c, (size[0], size[1]))
                    if map_coco is not None:
                        label_r = map_coco[label_r].astype(np.uint8)
                    to_compress.append(frame_r)
                    labels_pending.append(
                        np.ascontiguousarray(label_r, np.uint8))
                frame_label_bucket.clear()

                num_frames = len(to_compress)
                sample_per_period.append(num_frames)

                if not to_compress:
                    # an empty draw still ticks the period artifacts
                    up_bw_per_period.append(0.0)
                    up_codec_exact.append(True)
                    decoded: List[np.ndarray] = []
                elif cfg.compress_uplink:
                    with GLOBAL_TIMER.span("server/uplink_codec"):
                        res = uplink_codec.encode_decode_h264(
                            to_compress,
                            bitrate_kbps=cfg.uplink_bw * sample_send_period,
                            out_hw=(size[0], size[1]), fps=10,
                            work_dir=cfg.output_dir or None)
                    up_bw_per_period.append(res.bits)
                    up_codec_exact.append(bool(res.exact_reference_codec))
                    decoded = [np.ascontiguousarray(f, np.uint8)
                               for f in res.frames]
                    print_process("Uplink video: %.2fKb (%.2fKb/frame)"
                                  % (res.bits, res.bits / max(num_frames, 1)),
                                  i / fps)
                else:
                    with GLOBAL_TIMER.span("server/uplink_png"):
                        bits = uplink_codec.png_size_probe(to_compress)
                    up_bw_per_period.append(bits)
                    up_codec_exact.append(True)
                    decoded = [np.ascontiguousarray(f, np.uint8)
                               for f in to_compress]
                to_compress.clear()
                # ingest only MATCHED pairs: a lossy codec may decode one frame
                # more or less than the labels staged this period
                k = min(len(decoded), len(labels_pending))
                if k < max(len(decoded), len(labels_pending)):
                    print_process("Uplink codec returned %d frames for %d "
                                  "labels; keeping %d matched pairs"
                                  % (len(decoded), len(labels_pending), k),
                                  i / fps)
                memory.extend(decoded[:k], labels_pending[:k])
                labels_pending.clear()
                num_unseen_frames += k

            if i // fps in save_range and i // fps not in trained_seconds:
                trained_seconds.add(i // fps)
                if cfg.enable_ASR:
                    i_start = max(0, len(label_memory) - num_unseen_frames - 1)
                    recent = list(label_memory)[i_start:]
                    phis = network.calc_cross_miou_seq(np.array(recent)) \
                        if len(recent) >= 2 else []
                    if phis:
                        send_rate = asr.update(phis)
                        print_process("Send rate updated to %.2f" % send_rate,
                                      i / fps)
                    num_unseen_frames = 0
                    if atr is not None:
                        atr.observe_send_rate(send_rate)

                if cfg.enable_ATR:
                    period = atr.update()
                    save_range = atr.rewrite_schedule(save_range, i // fps,
                                                      train_end)
                    print_process("Train period now %d" % period, i / fps)

                if len(memory.frames) == 0 or len(memory.labels) == 0:
                    # an event can land before any sample arrived: skip the
                    # round, keep the schedule
                    print_process("No samples in memory, skipping training "
                                  "event",
                                  i / fps)
                    continue
                if not cfg.no_restore:
                    network.restore_initial()
                t1 = time.time()
                with GLOBAL_TIMER.span("server/train_round"):
                    network.train_with_deque(memory.frames, memory.labels,
                                             cfg.iter, cfg.train_strategy)
                print("Training for %d iterations took %d ms!!!"
                      % (cfg.iter, 1000 * (time.time() - t1)))

                # Downlink: encode the delta payload and account its bits.
                names = delta_order(cfg.train_strategy,
                                    present=network.params.keys())
                params_by_name = dict(zip(names, network.train_params))
                masks_by_name = dict(zip(names, network.curr_mask))
                # coord deltas append the BN moving-statistics annex by default
                stats = None
                if cfg.stats_annex and cfg.train_strategy != "full_model":
                    stats = network.stats_vars()
                with GLOBAL_TIMER.span("server/delta_encode"):
                    base = (network.initial_vars()
                            if cfg.wire_dtype == "int8d" else None)
                    blob = encode_delta(params_by_name, masks_by_name,
                                        strategy=cfg.train_strategy,
                                        stats=stats,
                                        wire_dtype=cfg.wire_dtype, base=base)
                with open(save_dir + "_mask.dat.gz", "wb") as f:
                    f.write(blob)
                curr_update = len(blob) * 8
                down_bw_per_period.append(curr_update)
                update_count += 1
                print("Using %.1fKbps for updating params"
                      % (curr_update // 1024))

                save_dir = get_save_dir(cfg, run_label + "_%d" % (i // fps))
                with GLOBAL_TIMER.span("server/deploy"):
                    network.save_to_frozen_graph(save_dir + "_final",
                                                 fold=cfg.fold_deploy)
                print_process("Saved model to %s_final.npz" % save_dir,
                              i / fps)
                model_save_times.append(i / fps)

                if cfg.resume_every_event:
                    with GLOBAL_TIMER.span("server/resume_save"):
                        resume_mod.save_state(
                            resume_prefix, network=network, memory=memory,
                            second=i, send_rate=send_rate,
                            sample_per_period=sample_per_period,
                            up_bw=up_bw_per_period, down_bw=down_bw_per_period,
                            up_codec_exact=up_codec_exact,
                            model_save_times=model_save_times,
                            save_range=save_range,
                            trained_seconds=trained_seconds,
                            update_count=update_count,
                            atr_state=None if atr is None else {
                                "hibernating": atr.hibernating,
                                "current": atr.current,
                                "history": list(atr.send_rate_history)})

    network.close_model()
    final_save_dir = get_save_dir(cfg, run_label + "_results")
    np.save(final_save_dir + "_fps_client.npy", sample_per_period)
    np.save(final_save_dir + "_bw_uplink.npy", up_bw_per_period)
    np.save(final_save_dir + "_uplink_exact.npy",
            np.asarray(up_codec_exact, bool))
    np.save(final_save_dir + "_bw_downlink.npy", down_bw_per_period)
    np.save(final_save_dir + "_model_update_times.npy", model_save_times)
    with open(final_save_dir + "_update.txt", "w") as f:
        interval = train_end - train_start
        if update_count == 0 and down_bw_per_period:
            raise RuntimeError("downlink bits logged without an update")
        f.write("%d\n%d\n%d\n%d\n%d" % (sum(down_bw_per_period),
                                        sum(up_bw_per_period), update_count,
                                        interval, sum(sample_per_period)))
    reader.release()
    memory.clear()
