#!/usr/bin/env python
"""The real-data validation gate (BASELINE.json north star) on the port.

The counterpart of ``tools/validate_reference.py`` for ``ams_tpu_torch``:
the same stages, flags and verdicts, on the port's own code, with no JAX,
TensorFlow, OpenCV or orbax.  The day the reference's weights and a
video are at hand:

    python tools/torch_frames_from_video.py /data/25-frankfurt.mp4 \
        /data/25-frankfurt                      # a frame directory (cv2)
    python tools/torch_validate_reference.py \
        --checkpoint /data/ckpt/model           # TF prefix (with .data!) \
        --video /data/25-frankfurt \
        --gt_dir /data/frankfurt_gt             # gt_%06d.png teacher labels \
        --reference_miou 0.684                  # TF1 run's number

Stages (each independently skippable via --stages):
  inventory  name->shape equality between the checkpoint's index (read by
             ``utils.tf_bundle``, no TensorFlow) and the port's
             ``init_student_params``;
  convert    TF checkpoint -> flat params dict -> <workdir>/student.npy
             (``utils.checkpoint.load_tf_checkpoint`` + ``merge_restore``);
  simple     the full experiment through ``runtime.modes.run_experiment``:
             --mode pretrained, then --mode simple at the reference's
             cadence (send 30 / train 10 / iters 200 / lr 1e-3) with the
             converted checkpoint, each run's rolling-window mIoU (the mean
             of ``_mioumems.npy`` past frame 7500), and the 0.5 gate
             against --reference_miou.
  bitmatch   is not ported: it runs the reference's .meta graph under
             TensorFlow, which the card's machine lacks.  Asking for it
             prints so and exits 1; run it with tools/validate_reference.py
             on a host with TensorFlow.

--video is a frame directory (``tools/torch_frames_from_video.py`` makes
one from an mp4).  --device picks where the experiment runs (the GPU by
default); inventory and convert run on the host.  Exit code 0 = all
requested stages passed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from ams_tpu_torch import configs as exp_configs  # noqa: E402
from ams_tpu_torch.convert import params_to_numpy  # noqa: E402
from ams_tpu_torch.models.mobilenetv2_deeplab import (  # noqa: E402
    init_student_params,
)
from ams_tpu_torch.runtime.config import RunConfig, get_save_dir  # noqa: E402
from ams_tpu_torch.runtime.modes import run_experiment  # noqa: E402
from ams_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from ams_tpu_torch.utils import tf_bundle  # noqa: E402

BITMATCH_MESSAGE = (
    "[bitmatch] not ported: it runs the reference's .meta graph under "
    "TensorFlow, which the port does not use; run it with "
    "tools/validate_reference.py on a host with TensorFlow")


def _base_params(num_classes):
    """The port's seeded init on the host, as numpy."""
    return params_to_numpy(init_student_params(
        0, num_classes=num_classes, device="cpu"))


def stage_inventory(a) -> bool:
    shipped = {name: tuple(e["shape"])
               for name, e in tf_bundle.read_index(a.checkpoint)[1]}
    shipped = {k: v for k, v in shipped.items()
               if "Adam" not in k and not k.endswith("power")
               and k not in ("global_step",)}
    ours = _base_params(a.num_classes)
    missing = set(shipped) - set(ours)
    extra = set(ours) - set(shipped)
    ok = not missing and not extra
    for k in sorted(missing):
        print("  MISSING from ours:", k)
    for k in sorted(extra):
        print("  EXTRA in ours:", k)
    for k in shipped:
        if k in ours and tuple(ours[k].shape) != tuple(shipped[k]):
            ok = False
            print("  SHAPE mismatch %s: ours %s vs shipped %s"
                  % (k, tuple(ours[k].shape), tuple(shipped[k])))
    print("[inventory] %s (%d vars)" % ("OK" if ok else "FAILED",
                                        len(shipped)))
    return ok


def stage_convert(a) -> bool:
    loaded = ckpt.load_tf_checkpoint(a.checkpoint)
    merged = ckpt.merge_restore(_base_params(a.num_classes), loaded)
    n_real = sum(1 for k in merged if k in loaded)
    out = os.path.join(a.workdir, "student.npy")
    np.save(out, {k: np.asarray(v) for k, v in merged.items()})
    ok = n_real == len(merged)
    print("[convert] %s: %d/%d params from the checkpoint -> %s"
          % ("OK" if ok else "PARTIAL (synthetic fill-ins!)",
             n_real, len(merged), out))
    return ok


def stage_simple(a) -> bool:
    converted = os.path.join(a.workdir, "student.npy")
    if not os.path.exists(converted):
        print("[simple] run the convert stage first")
        return False

    results = {}
    for mode in ("pretrained", "simple"):
        out_dir = os.path.join(a.workdir, mode) + "/"
        os.makedirs(out_dir, exist_ok=True)
        cfg = RunConfig(input_video=a.video, gt_video=a.gt_dir.rstrip("/")
                        + "/", student_checkpoint=converted,
                        output_dir=out_dir, height=a.height,
                        train_strategy=a.train_strategy,
                        coord_fraction=a.coord_fraction, mode=mode,
                        compute_dtype=a.compute_dtype, device=a.device)
        print("[simple] running --mode %s ..." % mode)
        t0 = time.perf_counter()
        run_experiment(cfg)
        vid_num = exp_configs.video_exp_num(a.video)
        length = exp_configs.test_length(vid_num)
        label = ("%d__%d_tp%d_f%d" % (0, length, cfg.train_period,
                                      cfg.send_period)
                 if mode == "simple" else "pretrained")
        mems = np.load(get_save_dir(cfg, label + "_results")
                       + "_mioumems.npy")
        # paper convention: rolling 10 s window, mean over frames > 7500
        tail = mems[7500:] if len(mems) > 7500 else mems
        results[mode] = float(np.nanmean(tail))
        print("[simple] %s rolling-window mIoU = %.4f (%.1f s)"
              % (mode, results[mode], time.perf_counter() - t0))

    delta_pre = results["simple"] - results["pretrained"]
    print("[simple] trained - pretrained = %+.4f" % delta_pre)
    ok = True
    if a.reference_miou is not None:
        delta_ref = abs(results["simple"] - a.reference_miou)
        ok = delta_ref <= 0.5
        print("[simple] |ours - TF1 reference| = %.4f (gate: <= 0.5) -> %s"
              % (delta_ref, "OK" if ok else "FAILED"))
    else:
        print("[simple] no --reference_miou given; gate not evaluated")
    return ok


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="TF checkpoint prefix with .data blobs")
    p.add_argument("--meta", default=None,
                   help=".meta path (bitmatch only, which is not ported)")
    p.add_argument("--video", default=None,
                   help="real experiment clip, as a frame directory")
    p.add_argument("--gt_dir", default=None,
                   help="teacher labels directory (gt_%%06d.png)")
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--train_strategy", default="coord_desc_auto")
    p.add_argument("--coord_fraction", type=float, default=0.1)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--reference_miou", type=float, default=None,
                   help="the TF1 reference run's rolling-window mIoU on "
                        "this video (gate: ours within 0.5)")
    p.add_argument("--workdir", default="validate_out")
    p.add_argument("--stages", default="inventory,convert,simple")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the experiment runs (default: the GPU); "
                        "inventory and convert run on the host")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    requested = [s.strip() for s in a.stages.split(",") if s.strip()]
    stages = {"inventory": stage_inventory, "convert": stage_convert,
              "simple": stage_simple}
    unknown = [s for s in requested if s not in stages and s != "bitmatch"]
    if unknown:
        print("unknown stages: %s" % ", ".join(unknown))
        return 1
    if "bitmatch" in requested:
        print(BITMATCH_MESSAGE)
        return 1
    os.makedirs(a.workdir, exist_ok=True)

    failed = []
    for name in requested:
        if name == "simple" and not a.video:
            print("[simple] skipped: --video not given")
            continue
        if name == "simple" and not a.gt_dir:
            print("[simple] skipped: --gt_dir not given")
            continue
        if not stages[name](a):
            failed.append(name)
    if failed:
        print("FAILED stages: %s" % ", ".join(failed))
        return 1
    print("all requested stages passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
