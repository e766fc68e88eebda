#!/usr/bin/env python
"""Teacher label extraction CLI, flag-compatible with
``ams_tpu/cli/extract_labels.py``.

Example (on the card; add ``--device cpu`` to run on the host):
    python -m ams_tpu_torch.cli.extract_labels \
        --input_video data/25-frankfurt --dump_path data/gt/ --height 256

``--input_video`` names a frame directory (``ams_tpu_torch/data/video.py``;
``tools/torch_frames_from_video.py`` makes one from an mp4).  Without
``--teacher_checkpoint`` the teacher's weights are seeded random.
``--gpu N`` selects ``cuda:N``; ``--device cpu`` runs on the host.
``--output_stride`` and ``--decoder_output_stride`` are DeepLab's flags:
omitted, the AMS teacher (output stride 16, no decoder); ``--output_stride
8 --decoder_output_stride 4`` is DeepLabV3+ as the DeepLab model zoo
evaluates its Cityscapes Xception-65 (``models.xception_deeplab``).
"""

import argparse

from ams_tpu_torch.models.xception_deeplab import deeplab_teacher
from ams_tpu_torch.runtime.labeler import extract_labels
from ams_tpu_torch.utils.trace import GLOBAL_TIMER


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dump_path", required=True,
                   help="Directory of the path data")
    p.add_argument("--teacher_checkpoint", default=None,
                   help="Teacher checkpoint (.npz/.npy)")
    p.add_argument("--gpu", default="0",
                   help="CUDA device index (--device cuda)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the teacher runs (default: the GPU)")
    p.add_argument("--input_video", required=True,
                   help="Frame directory of the video used in the test")
    p.add_argument("--height", type=int, default=None,
                   help="height to extract labels")
    p.add_argument("--batch", type=int, default=None,
                   help="frames per teacher call; default scales with the "
                        "frame height: 32 up to 320 rows, 16 up to 640, "
                        "8 beyond")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--output_stride", type=int, choices=[8, 16], default=16,
                   help="the teacher's output stride (DeepLab's flag)")
    p.add_argument("--decoder_output_stride", type=int, choices=[4],
                   default=None,
                   help="the decoder's output stride; omitted, no decoder")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = "cpu" if args.device == "cpu" else "cuda:%d" % int(args.gpu)
    print("Extracting labels...")
    n = extract_labels(args.input_video, args.dump_path,
                       teacher_checkpoint=args.teacher_checkpoint,
                       height=args.height, batch=args.batch,
                       max_frames=args.max_frames, device=device,
                       teacher_config=deeplab_teacher(
                           args.output_stride, args.decoder_output_stride))
    print("There were %d frames extracted" % n)
    if GLOBAL_TIMER.counts:
        print(GLOBAL_TIMER.summary())


if __name__ == "__main__":
    main()
