"""Uplink frame-codec emulation (edge -> server).

Counterpart of ``ams_tpu/stream/uplink.py``.  The reference measures
uplink bandwidth by really encoding the sampled frames (run.py:195-276):

- ``compress_uplink``: two-pass H.264 at bitrate uplink_bw * send_period
  kbps through an ffmpeg subprocess, then decodes the result back so
  training sees the compression artifacts;
- otherwise: PNG-encode each frame only to count its bytes.

PNG bytes come from ``data/image.py::png_encode``, which writes what
OpenCV writes, so the accounted bits equal the JAX package's.  H.264 needs
the ffmpeg binary, both ways: it encodes from raw bgr24 on its stdin and
decodes to raw bgr24 on its stdout, and the frames are then resized with
cv2's bilinear arithmetic and converted to RGB.  The JAX package falls
back to OpenCV's mp4v encoder without ffmpeg; the port has no OpenCV, so
without ffmpeg ``encode_h264_bytes`` raises a ``RuntimeError`` naming the
missing binary.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import subprocess as sp
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ams_tpu_torch.data.image import bgr_to_rgb, png_encode, resize_linear_u8

# AMS_FFMPEG overrides binary resolution (tests inject an instrumented
# double; deployments can pin a specific build)
FFMPEG = (os.environ.get("AMS_FFMPEG") or shutil.which("ffmpeg")
          or "/usr/bin/ffmpeg")


def _ffmpeg_binary() -> str:
    """The resolved ffmpeg path; raises when there is none."""
    pinned = os.environ.get("AMS_FFMPEG")
    if pinned:
        resolved = pinned if os.path.exists(pinned) else shutil.which(pinned)
        if not resolved:
            raise FileNotFoundError(
                "AMS_FFMPEG=%r is neither an existing file nor on PATH"
                % pinned)
        # absolutize: the encoder is spawned with cwd=<scratch dir>
        return os.path.abspath(resolved)
    if FFMPEG and os.path.exists(FFMPEG):
        return FFMPEG
    raise RuntimeError(
        "--compress_uplink needs the ffmpeg binary (looked for %r; set "
        "AMS_FFMPEG or put ffmpeg on PATH); the port has no fallback "
        "encoder" % (FFMPEG,))


@dataclasses.dataclass
class UplinkResult:
    frames: List[np.ndarray]     # decoded (possibly degraded) RGB frames
    bits: float                  # payload size in KBITS (the reference's
    # accounting unit, run.py:255-257)
    exact_reference_codec: bool  # True: the ffmpeg 2-pass path ran


def png_size_probe(frames_bgr: List[np.ndarray],
                   tmp_dir: Optional[str] = None) -> float:
    """Uncompressed-uplink accounting: PNG-encode each frame only to count
    its bytes (run.py:267-276).  Returns the total size in Kbits."""
    total_kb = 0.0
    for f in frames_bgr:
        total_kb += len(png_encode(np.asarray(f))) / 1024
    return total_kb * 8


def _scratch_file(work_dir: Optional[str], prefix: str):
    """-> (file path, cleanup fn).  A caller-provided work_dir keeps only
    its stray ffmpeg pass logs removed; an implicit one is removed whole."""
    own = work_dir is None
    work_dir = work_dir or tempfile.mkdtemp(prefix="ams_uplink_")
    # a unique name per call: concurrent experiments may share a directory
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=".mp4", dir=work_dir)
    os.close(fd)

    def cleanup():
        if own:
            shutil.rmtree(work_dir, ignore_errors=True)
        else:
            for p in glob.glob(path + "*"):  # the .mp4 + 2-pass logs
                try:
                    os.remove(p)
                except OSError:
                    pass

    return path, cleanup


def encode_h264_bytes(frames_bgr: List[np.ndarray], bitrate_kbps: float,
                      fps: int = 10, work_dir: Optional[str] = None
                      ) -> Tuple[bytes, bool]:
    """Encode the sample buffer by ffmpeg's two-pass H.264 and return the
    video bytes -> (blob, True)."""
    ffmpeg = _ffmpeg_binary()
    out_file, cleanup = _scratch_file(work_dir, "uplink_tx_")
    try:
        h_in, w_in = frames_bgr[0].shape[:2]
        _ffmpeg_two_pass(frames_bgr, bitrate_kbps, (w_in, h_in), fps,
                         out_file, binary=ffmpeg)
        with open(out_file, "rb") as f:
            blob = f.read()
        if not blob:
            raise IOError("uplink encoder produced an empty payload (ffmpeg)")
        return blob, True
    finally:
        cleanup()


def decode_video_bytes(blob: bytes, out_hw: Tuple[int, int],
                       in_hw: Tuple[int, int],
                       work_dir: Optional[str] = None) -> List[np.ndarray]:
    """Decode an uplink video of ``in_hw`` frames by ffmpeg to raw bgr24,
    then resize to the training size and convert to RGB."""
    ffmpeg = _ffmpeg_binary()
    in_file, cleanup = _scratch_file(work_dir, "uplink_rx_")
    try:
        with open(in_file, "wb") as f:
            f.write(blob)
        proc = sp.run([ffmpeg, "-v", "error", "-i", in_file, "-f", "rawvideo",
                       "-pix_fmt", "bgr24", "pipe:"],
                      stdout=sp.PIPE, stderr=sp.PIPE,
                      cwd=os.path.dirname(in_file), check=False)
        if proc.returncode != 0:
            raise RuntimeError("ffmpeg decode exited rc=%d: %s"
                               % (proc.returncode,
                                  proc.stderr.decode(errors="replace")[-500:]))
        h, w = in_hw
        frame_bytes = h * w * 3
        if len(proc.stdout) % frame_bytes:
            raise IOError("ffmpeg decoded %d bytes, not a whole number of "
                          "%dx%d frames" % (len(proc.stdout), w, h))
        raw = np.frombuffer(proc.stdout, np.uint8).reshape(-1, h, w, 3)
        return [bgr_to_rgb(resize_linear_u8(f, out_hw)) for f in raw]
    finally:
        cleanup()


def encode_decode_h264(frames_bgr: List[np.ndarray], bitrate_kbps: float,
                       out_hw: Tuple[int, int], fps: int = 10,
                       work_dir: Optional[str] = None) -> UplinkResult:
    """Encode the sample buffer at a target bitrate, decode it back, resize
    to the training size and convert to RGB (run.py:195-266)."""
    blob, exact = encode_h264_bytes(frames_bgr, bitrate_kbps, fps=fps,
                                    work_dir=work_dir)
    size_bits = len(blob) / 1024 * 8  # Kbits, run.py:255-257
    decoded = decode_video_bytes(blob, out_hw, frames_bgr[0].shape[:2],
                                 work_dir=work_dir)
    return UplinkResult(frames=decoded, bits=size_bits,
                        exact_reference_codec=exact)


_MAX_PIPE_RETRIES = 5


def _ffmpeg_two_pass(frames_bgr, bitrate_kbps, size_wh, fps, out_file,
                     binary=None):
    """The reference's ffmpeg invocation: raw bgr24 on stdin, libx264 2-pass
    at the target bitrate, retrying on BrokenPipeError (run.py:200-252),
    a bounded number of times; a non-zero exit of a pass raises."""
    w, h = size_wh
    binary = binary or FFMPEG
    base = [binary, "-y", "-s", "%dx%d" % (w, h), "-pixel_format", "bgr24",
            "-f", "rawvideo", "-r", str(fps), "-i", "pipe:",
            "-vcodec", "libx264", "-pix_fmt", "yuv420p", "-preset", "medium",
            "-b:v", "%dk" % int(bitrate_kbps),
            # a unique 2-pass stats file so concurrent runs don't collide
            "-passlogfile", out_file + ".passlog"]
    passes = [base + ["-pass", "1", "-f", "mp4", "/dev/null"],
              base + ["-pass", "2", out_file]]
    attempts = 0
    while True:
        proc = cmd = None
        try:
            with open(os.devnull, "w") as devnull:
                for cmd in passes:
                    proc = sp.Popen(cmd, stdin=sp.PIPE, stderr=devnull,
                                    stdout=devnull,
                                    cwd=os.path.dirname(out_file))
                    for f in frames_bgr:
                        proc.stdin.write(f.tobytes())
                    proc.stdin.close()
                    rc = proc.wait()
                    if rc != 0:
                        raise RuntimeError(
                            "ffmpeg pass exited rc=%d: %s"
                            % (rc, " ".join(cmd)))
            return
        except BrokenPipeError as e:
            rc = proc.wait() if proc is not None else None
            attempts += 1
            if attempts >= _MAX_PIPE_RETRIES:
                raise RuntimeError(
                    "ffmpeg stdin pipe broke %d times in a row (last exit "
                    "rc=%s): %s" % (attempts, rc,
                                    " ".join(cmd) if cmd else binary)) from e
            continue
