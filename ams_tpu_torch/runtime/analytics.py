"""Result analytics (reference k1k2_plot / plot_miou_mean, run.py:464-560).

A copy of ``ams_tpu/runtime/analytics.py`` on the port's modules.

Three mIoU aggregation conventions (documented at reference run.py:482-491):
1. sum all per-frame confusion matrices, then mIoU;
2. mean of per-frame mIoUs;
3. per-frame mIoU of the summed confusion matrices over the trailing 10 s
   window ("miou_mem" — the paper's convention).
The horizon profiler reports the trained-vs-pretrained delta under all
three.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ams_tpu_torch.data.video import VideoReader
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir
from ams_tpu_torch.utils.metrics import calculate_miou


def k1k2_plot(cfg: RunConfig, ts: List[int], k1s: List[int],
              k2s: List[int]) -> dict:
    reader = VideoReader(cfg.input_video)
    fps = reader.fps
    reader.release()

    pre_conf = np.load(get_save_dir(cfg, "pretrained_results")
                       + "_mioucats.npy")
    pre_miou = np.load(get_save_dir(cfg, "pretrained_results") + "_mious.npy")
    pre_mem = np.load(get_save_dir(cfg, "pretrained_results")
                      + "_mioumems.npy")

    res_conf = np.empty((len(k1s), len(k2s)))
    res_avg = np.empty((len(k1s), len(k2s)))
    res_mem = np.empty((len(k1s), len(k2s)))
    # the artifact tag depends on (k1, t) but NOT the inner-loop k2 (the
    # trained run always covers k2s[-1] seconds): cache the three loads so
    # each file is read once instead of len(k2s) times
    _loads: dict = {}

    def _arts(tag):
        if tag not in _loads:
            base = get_save_dir(cfg, tag)
            _loads[tag] = (np.load(base + "_mioucats.npy"),
                           np.load(base + "_mious.npy"),
                           np.load(base + "_mioumems.npy"))
        return _loads[tag]

    for i_k1, k1 in enumerate(k1s):
        for i_k2, k2 in enumerate(k2s):
            d_conf, d_avg, d_mem = [], [], []
            for t in ts:
                tag = "%d__%d__%d_f%d_results" % (t - k1, t, t + k2s[-1],
                                                  cfg.send_period)
                tr_conf, tr_miou, tr_mem = _arts(tag)
                if tr_conf[:k2 * fps].shape != \
                        pre_conf[t * fps:(t + k2) * fps].shape:
                    raise ValueError("horizon %s: %s frames against the "
                                     "pretrained run's %s"
                                     % (tag, tr_conf[:k2 * fps].shape,
                                        pre_conf[t * fps:(t + k2)
                                                 * fps].shape))
                pre = np.nanmean(calculate_miou(
                    np.sum(pre_conf[t * fps:(t + k2) * fps], axis=0),
                    nan=True))
                tr = np.nanmean(calculate_miou(
                    np.sum(tr_conf[:k2 * fps], axis=0), nan=True))
                d_conf.append(tr - pre)

                d_avg.append(np.mean(tr_miou[:k2 * fps]) -
                             np.mean(pre_miou[t * fps:(t + k2) * fps]))

                d_mem.append(np.mean(tr_mem[:k2 * fps]) -
                             np.mean(pre_mem[t * fps:(t + k2) * fps]))
            res_conf[i_k1, i_k2] = np.mean(d_conf)
            res_avg[i_k1, i_k2] = np.mean(d_avg)
            res_mem[i_k1, i_k2] = np.mean(d_mem)

    for name, mat in (("Confusions Matrix-Based mIoUs", res_conf),
                      ("Average mIoUs", res_avg),
                      ("Average mIoU memories", res_mem)):
        print("%s:" % name)
        for i_k1, k1 in enumerate(k1s):
            for i_k2, k2 in enumerate(k2s):
                print(f"({k1}, {k2}, {mat[i_k1, i_k2] * 100})")
    return {"conf": res_conf, "avg": res_avg, "mem": res_mem}


def plot_miou_mean(cfg: RunConfig, period: int, sampling_period: int,
                   run_label: str, summary_from_frame: int = 7500) -> dict:
    final_save_dir = get_save_dir(cfg, run_label + "_results")
    with open(final_save_dir + "_update.txt") as f:
        downlink, uplink, update_count, interval, samples_sent = (
            int(k.rstrip("\n")) for k in f.readlines())
    miou_s = np.load("%s_mioumems.npy" % final_save_dir)
    start = summary_from_frame if len(miou_s) > summary_from_frame else 0
    summary = float(np.mean(miou_s[start:]) * 100)
    print(f"({period}, {sampling_period}, {summary})")
    print(f"Uplink: {uplink / interval / 1024}, "
          f"Downlink: {downlink / interval / 1024}, "
          f"Sampling rate: {samples_sent / interval}, "
          f"Update rate: {update_count / interval}")
    return {"miou_mean": summary, "uplink_kbps": uplink / interval / 1024,
            "downlink_kbps": downlink / interval / 1024,
            "sampling_rate": samples_sent / interval,
            "update_rate": update_count / interval}
