"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; a missing
card is an error, never a quiet fall to the CPU.  Selecting a CUDA device
also turns TF32 off for matmuls and cuDNN convolutions: the port computes
in float32 throughout, matching the JAX package's f32/``HIGHEST`` contract.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError("unsupported device %s (cuda or cpu)" % dev)
    return dev
