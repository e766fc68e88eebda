"""Experiment configuration (the reference's tf.app.flags surface,
run.py:18-69, as a dataclass).

Counterpart of ``ams_tpu/runtime/config.py`` with one field of the port's
own, ``device``: ``None`` runs on ``cuda`` (``utils.platform.
resolve_device``), ``"cpu"`` on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    input_video: str = ""              # frame directory (data/video.py)
    gt_video: str = ""                 # directory of gt_%06d.png labels
    student_checkpoint: str = ""
    output_dir: str = ""

    initial_fill: bool = False         # don't train until memory is full
    memory_len: int = 250              # seconds of frame memory
    batch_size: int = 10
    iter: int = 200
    height: int = 256
    lr: float = 1e-3

    send_period: int = 30              # seconds between sample arrivals
    train_period: int = 10             # training cadence grid (seconds)

    only_results: bool = False
    compress_uplink: bool = False
    uplink_bw: float = 1000.0          # kbps budget for the H.264 uplink
    no_restore: bool = False
    save_pic: bool = False

    enable_ASR: bool = False
    enable_ATR: bool = False

    train_strategy: str = "full_model"
    coord_fraction: float = 0.1

    mode: str = "simple"               # simple | pretrained | horizon | early
    early_cutoff_time: int = 60
    # Horizon-study grid (the reference hardcodes these, run.py:612-615)
    horizon_k1s: tuple = (16, 32, 64, 128, 256, 512)
    horizon_k2s: tuple = (16, 32, 64, 128, 256)
    horizon_points: int = 3

    compute_dtype: str = "float32"     # or "bfloat16" (mixed precision)
    conv_precision: str = "auto"       # auto|default|highest (DistillSpec)
    fold_deploy: bool = True           # BN-fold the deployed client artifact
    resume: bool = False               # continue from the last saved event
    resume_every_event: bool = True    # persist a resume bundle per event
    stats_annex: bool = True           # append BN moving stats to coord
    # deltas (wire extension; stream/codec.py STATS_MAGIC)
    wire_dtype: str = "float16"        # delta values: float16 | int8 | int8d
    trace_dir: str = ""                # torch.profiler Chrome trace output
    device: Optional[str] = None       # None -> cuda; "cpu" on the host

    def validate(self):
        if self.wire_dtype not in ("float16", "int8", "int8d"):
            raise ValueError("wire_dtype %r" % (self.wire_dtype,))
        if self.wire_dtype == "int8d" and self.no_restore:
            raise ValueError(
                "wire_dtype 'int8d' quantizes value-minus-initial: it "
                "requires restore-mode training (drop --no_restore)")
        if self.enable_ATR and not self.enable_ASR:
            raise ValueError("ASR must be enabled for ATR to work")
        if self.enable_ASR and self.mode != "simple":
            raise ValueError("ASR can only be used in simple mode")
        if self.enable_ATR and self.mode != "simple":
            raise ValueError("ATR can only be used in simple mode")
        return self

    @property
    def size(self):
        return [self.height, self.height * 2]


def get_save_dir(cfg: RunConfig, prepend: str) -> str:
    """Experiment-unique artifact prefix (reference run.py:563-573)."""
    video = cfg.input_video.split("/")[-1]
    ckpt_tag = (cfg.student_checkpoint.split("/")[-2]
                if "/" in cfg.student_checkpoint else cfg.student_checkpoint)
    return cfg.output_dir + "%s_%s_%s_%d" % (prepend, video, ckpt_tag,
                                             cfg.height)


def print_process(msg: str, curr_time) -> None:
    try:
        from termcolor import colored
        prefix = colored("Process [current time: %d]: " % curr_time, "cyan")
    except Exception:
        prefix = "Process [current time: %d]: " % curr_time
    print(prefix, msg)
