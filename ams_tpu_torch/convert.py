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


def masks_from_numpy(d: Mapping[str, np.ndarray], device=None
                     ) -> Dict[str, torch.Tensor]:
    """{name: numpy mask} -> {name: bool tensor on ``device``}."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(v, bool).copy()).to(dev)
            for k, v in d.items()}


def masks_to_numpy(m: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: mask tensor} -> {name: numpy bool array} on the host."""
    return {k: np.asarray(v.detach().cpu().numpy(), bool)
            for k, v in m.items()}


def adam_state_from_numpy(step, m: Mapping[str, np.ndarray],
                          v: Mapping[str, np.ndarray], device=None):
    """Adam step and slots in numpy (as ``ams_tpu``'s ``AdamState`` holds
    them) -> the port's ``AdamState`` on ``device``."""
    from ams_tpu_torch.distill.optimizer import AdamState

    dev = resolve_device(device)
    return AdamState(
        step=torch.from_numpy(np.array(step, np.int32)).to(dev),
        m=params_from_numpy(m, dev), v=params_from_numpy(v, dev))


def adam_state_to_numpy(state):
    """The port's ``AdamState`` -> (step int32, m dict, v dict) in numpy;
    the step keeps its shape ((V,) for stacked per-video states)."""
    step = state.step.detach().cpu().numpy().astype(np.int32)
    return (step[()] if step.ndim == 0 else step, params_to_numpy(state.m),
            params_to_numpy(state.v))
