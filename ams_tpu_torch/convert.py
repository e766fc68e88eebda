"""Parameter dicts between the JAX package's numpy form and the port's.

Both packages key parameters by the exact TF variable names and keep TF
shapes (HWIO convolutions, ``(kh, kw, C, 1)`` depthwise), so conversion is
a per-array copy with names, shapes and dtypes unchanged, and the same
weights compute the same thing in both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ams_tpu_torch.utils.platform import resolve_device


def params_from_numpy(d: Mapping[str, np.ndarray], device=None
                      ) -> Dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: tensor on ``device``} (default cuda)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in d.items()}


def params_to_numpy(p: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: numpy array} on the host."""
    return {k: np.array(v.detach().cpu().numpy()) for k, v in p.items()}
