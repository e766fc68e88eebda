#!/usr/bin/env python
"""Turn a video file into the frame directory that ams_tpu_torch reads.

    python tools/torch_frames_from_video.py data/25-frankfurt.mp4 \
        data/25-frankfurt

Decodes with OpenCV (run it where OpenCV is installed) and writes each
decoded BGR frame as ``frame_%06d.png`` plus ``clip.json`` with the fps
OpenCV reports, rounded as the JAX package's reader rounds it
(``ams_tpu/data/video.py``), and the frame count.  Name the output after
the clip (``25-frankfurt`` or ``25-frankfurt.mp4``): the experiment
number and the artifact names come from its base name.
"""

import argparse
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ams_tpu_torch.data.image import png_write  # noqa: E402
from ams_tpu_torch.data.video import frame_path, write_clip_meta  # noqa: E402


def frames_from_video(src: str, dst: str) -> int:
    """Decode ``src`` into the frame directory ``dst``; returns the frame
    count."""
    import cv2

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise IOError("Error opening video stream or file: %s" % src)
    fps = int(round(cap.get(cv2.CAP_PROP_FPS)))
    if fps <= 0:
        warnings.warn("no fps metadata in %s; assuming 30" % src)
        fps = 30
    os.makedirs(dst, exist_ok=True)
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            png_write(frame_path(dst, n), frame)
            n += 1
    finally:
        cap.release()
    write_clip_meta(dst, fps, n)
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("video", help="input video file (mp4, avi, ...)")
    p.add_argument("out_dir", help="frame directory to write")
    a = p.parse_args(argv)
    n = frames_from_video(a.video, a.out_dir)
    print("wrote %d frames to %s" % (n, a.out_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
