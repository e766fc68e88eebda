"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a quiet fall to the CPU.  Selecting a CUDA device
also turns TF32 off for matmuls and cuDNN convolutions: the port computes
in float32 throughout, matching the JAX package's f32/``HIGHEST`` contract.
``conv_precision("default")`` turns it on for the span of a distillation
round, the JAX package's single-pass ``lax.Precision.DEFAULT``; while such
a span is open, selecting a device on another thread leaves it on.

Selecting a CUDA device also turns cuDNN's deterministic mode on: with its
default algorithms, two runs of the same round differ in their last bits
(tools/torch_round_determinism.py).  The other source of that, the
atomics of ``index_select``'s backward, has a deterministic formulation in
``models/resize.py``.  ``torch.use_deterministic_algorithms`` stays off.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

CONV_PRECISIONS = ("auto", "default", "highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        _TF32.turn_off()
        torch.backends.cudnn.deterministic = True
    elif dev.type != "cpu":
        raise ValueError("unsupported device %s (cuda or cpu)" % dev)
    return dev


class _TF32Span:
    """Who is inside a TF32 span.  The legacy flags are process-wide (the
    same API as ``resolve_device``): the first thread in saves them and
    turns TF32 on, the last one out restores them.  The count keeps TF32
    on until the last "default" round exits; any f32 work on another
    thread in that time (a "highest" round, a labeler, a client) runs in
    TF32 too (ROADMAP §C).  ``resolve_device`` turns TF32 off through
    ``turn_off``, which leaves an open span's flags alone."""

    def __init__(self):
        self.lock = threading.Lock()
        self.users = 0
        self.saved = None

    def turn_off(self) -> None:
        """Both flags off, unless a span is open: then its round keeps
        TF32, and the last one out restores what it saved."""
        with self.lock:
            if self.users == 0:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False

    def enter(self) -> None:
        with self.lock:
            if self.users == 0:
                self.saved = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            self.users += 1

    def exit(self) -> None:
        with self.lock:
            self.users -= 1
            if self.users == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = self.saved


_TF32 = _TF32Span()


@contextlib.contextmanager
def conv_precision(precision: str):
    """The float32 convolutions and products inside run at ``precision``:
    "auto" and "highest" in full f32, "default" in TF32 on the card (cuDNN
    convolutions and cuBLAS products; the CPU has no TF32, so there it is
    full f32 too).  The flags are restored on the way out, also when the
    body raises.  They are process-wide: f32 work of other threads during
    the span runs in TF32 as well."""
    if precision not in CONV_PRECISIONS:
        raise ValueError("conv_precision must be one of %s, got %r"
                         % (CONV_PRECISIONS, precision))
    if precision != "default":
        yield
        return
    _TF32.enter()
    try:
        yield
    finally:
        _TF32.exit()
