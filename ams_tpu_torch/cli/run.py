#!/usr/bin/env python
"""AMS experiment driver CLI, flag-compatible with ``ams_tpu/cli/run.py``.

Example (on the card; add ``--device cpu`` to run on the host):
    python -m ams_tpu_torch.cli.run --mode simple \
        --input_video data/25-frankfurt --gt_video data/gt/ \
        --student_checkpoint ckpt/model.npz --output_dir out/ \
        --train_strategy coord_desc_auto

``--input_video`` names a frame directory (``ams_tpu_torch/data/video.py``;
``tools/torch_frames_from_video.py`` makes one from an mp4).  ``--gpu N``
selects ``cuda:N``; ``--device cpu`` runs on the host.
"""

import argparse

from ams_tpu_torch.runtime.config import RunConfig
from ams_tpu_torch.runtime.modes import run_experiment

STRATEGIES = ["full_model", "coord_desc_auto", "coord_desc_last",
              "coord_desc_first", "coord_desc_both", "coord_desc_rand"]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_video", required=True,
                   help="Frame directory of the video")
    p.add_argument("--gt_video", required=True,
                   help="Directory for the ground truth labels of video")
    p.add_argument("--student_checkpoint", required=True,
                   help="Student checkpoint (.npz/.npy)")
    p.add_argument("--output_dir", required=True,
                   help="Directory for the output figure")
    p.add_argument("--gpu", default="0",
                   help="CUDA device index (--device cuda)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the student runs (default: the GPU)")
    p.add_argument("--initial_fill", action="store_true",
                   help="When true, doesn't train until memory is full")
    p.add_argument("--memory_len", type=int, default=250)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--iter", type=int, default=200)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--send_period", type=int, default=30)
    p.add_argument("--train_period", type=int, default=10)
    p.add_argument("--only_results", action="store_true")
    p.add_argument("--compress_uplink", action="store_true")
    p.add_argument("--uplink_bw", type=float, default=1000.0)
    p.add_argument("--no_restore", action="store_true")
    p.add_argument("--save_pic", action="store_true")
    p.add_argument("--enable_ASR", action="store_true")
    p.add_argument("--enable_ATR", action="store_true")
    p.add_argument("--train_strategy", choices=STRATEGIES,
                   default="full_model")
    p.add_argument("--coord_fraction", choices=["0.1", "0.05", "0.2", "0.01"],
                   default="0.1")
    p.add_argument("--mode", required=True,
                   choices=["simple", "pretrained", "horizon", "early"])
    p.add_argument("--early_cutoff_time", type=int, default=60)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16 is not ported yet (ROADMAP A7)")
    p.add_argument("--conv_precision", choices=["auto", "default", "highest"],
                   default="auto",
                   help="default is not ported yet (ROADMAP A7)")
    p.add_argument("--resume", action="store_true",
                   help="Continue a crashed run from its last saved event")
    p.add_argument("--no_resume_state", action="store_true",
                   help="Don't persist per-event resume bundles")
    p.add_argument("--trace_dir", default="",
                   help="Write a torch.profiler Chrome trace here")
    p.add_argument("--wire_dtype", choices=["float16", "int8", "int8d"],
                   default="float16",
                   help="Delta payload values: float16 = reference wire; "
                        "int8 = per-var symmetric quantization; int8d = "
                        "int8 over value-minus-initial")
    p.add_argument("--no_stats_annex", action="store_true",
                   help="Omit the BN moving-stats annex from coord-descent "
                        "delta payloads (the reference's wire)")
    return p


def config_from_args(args) -> RunConfig:
    """Flag -> RunConfig mapping (separate from main, so the plumbing is
    testable without running an experiment)."""
    device = "cpu" if args.device == "cpu" else "cuda:%d" % int(args.gpu)
    return RunConfig(
        input_video=args.input_video, gt_video=args.gt_video,
        student_checkpoint=args.student_checkpoint,
        output_dir=args.output_dir, initial_fill=args.initial_fill,
        memory_len=args.memory_len, batch_size=args.batch_size,
        iter=args.iter, height=args.height, lr=args.lr,
        send_period=args.send_period, train_period=args.train_period,
        only_results=args.only_results, compress_uplink=args.compress_uplink,
        uplink_bw=args.uplink_bw, no_restore=args.no_restore,
        save_pic=args.save_pic, enable_ASR=args.enable_ASR,
        enable_ATR=args.enable_ATR, train_strategy=args.train_strategy,
        coord_fraction=float(args.coord_fraction), mode=args.mode,
        early_cutoff_time=args.early_cutoff_time,
        compute_dtype=args.compute_dtype, conv_precision=args.conv_precision,
        resume=args.resume,
        resume_every_event=not args.no_resume_state,
        trace_dir=args.trace_dir,
        stats_annex=not args.no_stats_annex,
        wire_dtype=args.wire_dtype,
        device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_experiment(config_from_args(args))


if __name__ == "__main__":
    main()
