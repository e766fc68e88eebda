"""Experiment mode dispatch (reference main(), run.py:585-659).

Counterpart of ``ams_tpu/runtime/modes.py`` on the port's modules."""

from __future__ import annotations

import os
import time

import numpy as np

from ams_tpu_torch import configs as exp_configs
from ams_tpu_torch.runtime.analytics import k1k2_plot, plot_miou_mean
from ams_tpu_torch.runtime.client import infer_output
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir
from ams_tpu_torch.runtime.server import train_model
from ams_tpu_torch.utils.platform import resolve_device
from ams_tpu_torch.utils.trace import GLOBAL_TIMER, profile_trace


def run_experiment(cfg: RunConfig) -> None:
    cfg.validate()
    resolve_device(cfg.device)    # no card: raise before any work
    os.makedirs(cfg.output_dir, exist_ok=True)
    with profile_trace(cfg.trace_dir or None):
        with GLOBAL_TIMER.span("experiment"):
            _run_experiment(cfg)
    if GLOBAL_TIMER.counts:
        print(GLOBAL_TIMER.summary())


def _run_experiment(cfg: RunConfig) -> None:
    vid_num = exp_configs.video_exp_num(cfg.input_video)
    length = exp_configs.test_length(vid_num)

    if cfg.mode == "simple":
        run_label = "%d__%d_tp%d_f%d" % (0, length, cfg.train_period,
                                         cfg.send_period)
        event_list = [0]
        first_train = int(np.ceil(100 / cfg.train_period) * cfg.train_period)
        event_list.extend(
            i for i in range(first_train, length, cfg.train_period)
            if i == 0 or i >= cfg.memory_len or not cfg.initial_fill)
        if not cfg.only_results:
            train_model(cfg, 0, length, cfg.send_period, run_label,
                        cfg.gt_video, vid_num, event_list, cfg.train_period)
            if cfg.enable_ATR:
                event_list = np.load(
                    get_save_dir(cfg, run_label + "_results")
                    + "_model_update_times.npy").tolist()
            infer_output(cfg, 0, length, run_label, cfg.gt_video, vid_num,
                         event_list)
        plot_miou_mean(cfg, cfg.train_period, cfg.send_period, run_label)

    elif cfg.mode == "horizon":
        k1s = list(cfg.horizon_k1s)
        k2 = cfg.horizon_k2s[-1]
        number_of_points = cfg.horizon_points
        # horizon_points=1 profiles a single time point (short clips)
        step = 0 if number_of_points <= 1 else \
            (length - k2 - k1s[-1]) // (number_of_points - 1)
        if not cfg.only_results:
            run_label = "pretrained"
            train_model(cfg, 0, 1, cfg.send_period, run_label, cfg.gt_video,
                        vid_num, [0], cfg.train_period)
            infer_output(cfg, 0, length, run_label, cfg.gt_video, vid_num,
                         [0])
            done, total, t0 = 0, number_of_points * len(k1s), time.time()
            for i in range(number_of_points):
                t = k1s[-1] + i * step
                for k1 in k1s:
                    run_label = "%d__%d__%d_f%d" % (t - k1, t, t + k2,
                                                    cfg.send_period)
                    print("t: %d, k1: %d" % (t, k1))
                    train_model(cfg, t - k1, t, cfg.send_period, run_label,
                                cfg.gt_video, vid_num, [t], cfg.train_period)
                    infer_output(cfg, t, t + k2, run_label, cfg.gt_video,
                                 vid_num, [t])
                    done += 1
                    etf = (time.time() - t0) / done * (total - done)
                    print("ETF %02d:%02d.%02d" % (etf // 60, etf % 60,
                                                  (etf * 100) % 100))
        k2s = list(cfg.horizon_k2s)
        ts = [k1s[-1] + i * step for i in range(number_of_points)]
        k1k2_plot(cfg, ts, k1s, k2s)

    elif cfg.mode == "early":
        run_label = "early%d_f%d" % (cfg.early_cutoff_time, cfg.send_period)
        event_list = [0, cfg.early_cutoff_time]
        if not cfg.only_results:
            train_model(cfg, 0, cfg.early_cutoff_time, cfg.send_period,
                        run_label, cfg.gt_video, vid_num, event_list,
                        cfg.train_period)
            infer_output(cfg, 0, length, run_label, cfg.gt_video, vid_num,
                         event_list)
        plot_miou_mean(cfg, -1, cfg.send_period, run_label)

    elif cfg.mode == "pretrained":
        run_label = "pretrained"
        train_model(cfg, 0, 1, cfg.send_period, run_label, cfg.gt_video,
                    vid_num, [0], cfg.train_period)
        infer_output(cfg, 0, length, run_label, cfg.gt_video, vid_num, [0])
        plot_miou_mean(cfg, -1, -1, run_label)
    else:
        raise ValueError("unknown mode %r" % cfg.mode)

    print("Process [Main]: Done!!!")
