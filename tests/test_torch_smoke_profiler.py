"""chip_smoke.py when torch.profiler records no device time.

On the card torch.profiler has come back without device time, in one run
for every profile of the process.  The smoke run then reports the
profiler's device times as not measured, and its launch-order check on
the client's forwards (no cast, gather or copy between the forward and K1)
reads the dispatched aten ops in place of the device's kernels.  These
tests drive both on the CPU with a stand-in profiler and a stand-in K1
whose launch ``ops.build.launch`` counts, as it counts the wrapper's on
the card, with a stand-in kernel library.
"""
import contextlib
import os
import re
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from ams_tpu_torch.ops import build  # noqa: E402
from ams_tpu_torch.ops import fused_resize_argmax as fra  # noqa: E402
from test_torch_ops_build import install_stand_in  # noqa: E402


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture
def profiles(monkeypatch):
    """A stand-in torch.profiler.profile whose profiles hold the device
    times queued in ``profiles.device_us`` (none: an empty profile); the
    number of profiles taken is ``profiles.taken``."""
    state = types.SimpleNamespace(device_us=[], taken=0)

    class Profile:
        def __init__(self, us):
            self.rows = [types.SimpleNamespace(self_device_time_total=us,
                                               key="kernel", count=1)] \
                if us else []

        def key_averages(self):
            return self.rows

        def events(self):
            return []

    @contextlib.contextmanager
    def profile(activities=None):
        state.taken += 1
        yield Profile(state.device_us.pop(0) if state.device_us else 0)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "_PROFILER_EMPTY", [])
    return state


@pytest.fixture
def k1(monkeypatch):
    """A stand-in K1 wrapper: an int32 id map, one launch counted."""
    install_stand_in(monkeypatch, "resize_argmax")

    def launch(grid, out_hw, class_index=None):
        out = torch.empty((grid.shape[0],) + tuple(out_hw),
                          dtype=torch.int32)
        build.launch("resize_argmax", "resize_argmax", 0, (),
                     lambda: "stand-in")
        return out

    monkeypatch.setattr(fra, "fused_resize_argmax", launch)
    return launch


def test_device_times_are_not_measured_after_empty_profiles(profiles):
    x = torch.ones(4)
    assert chip_smoke.device_ms(lambda: x + 1, 5) is None
    assert profiles.taken == 3
    # later profiles of the process are taken once
    assert chip_smoke.device_ms(lambda: x + 1, 5) is None
    assert profiles.taken == 4
    assert chip_smoke.device_breakdown(lambda: x + 1) == [
        "torch.profiler recorded no device time: not measured"]
    wall, busy, k1_s = chip_smoke.device_busy(lambda: x + 1)
    assert wall > 0 and busy is None and k1_s is None
    assert chip_smoke.ms_text(None) == "not measured"
    assert chip_smoke.event_device((0.5, None)) == (0.5, "not measured")


def test_an_empty_profile_is_taken_again(profiles):
    x = torch.ones(4)
    profiles.device_us = [0, 0, 2000.0]
    assert chip_smoke.device_ms(lambda: x + 1, 4) == pytest.approx(0.5)
    assert profiles.taken == 3 and not chip_smoke._PROFILER_EMPTY
    profiles.device_us = [3000.0]
    assert chip_smoke.device_ms(lambda: x + 1, 2) == pytest.approx(1.5)
    assert profiles.taken == 4


def test_launch_order_falls_back_to_dispatched_ops(profiles, k1):
    x = torch.ones(1, 2, 4, 4)
    names, record = chip_smoke.kernels_in_order(
        lambda: k1(x + 1, (8, 8)))
    # the CPU tensors touch no card: only K1's launch is left
    assert record == "dispatch" and names == ["resize_argmax"]


HANDOVERS = {
    "none": (lambda y: y, None),
    "cast": (lambda y: y.to(torch.bfloat16), "aten.to.dtype"),
    "channels_last": (
        lambda y: y.contiguous(memory_format=torch.channels_last),
        "aten.contiguous.default"),
    "gather": (lambda y: y[:, [0, 2]], "aten.index.Tensor"),
    "copy_": (lambda y: y.copy_(y * 2), "aten.copy_.default"),
}


@pytest.mark.parametrize("handover", sorted(HANDOVERS))
def test_dispatched_ops_show_a_copy_before_k1(k1, handover):
    step, flagged = HANDOVERS[handover]
    x = torch.randn(2, 3, 8, 8)

    def forward():
        # a bias add, then a view and a .to/.contiguous with nothing to do
        y = (x + 1).permute(0, 1, 3, 2).to(torch.float32)
        return k1(step(y), (16, 16))

    with torch.inference_mode():
        names = chip_smoke.ops_in_order(forward, device="cpu")
    assert names[-1] == "resize_argmax" and names.count("resize_argmax") == 1
    prev = names[-2]
    hit = re.search(chip_smoke.HANDOVER_COPY["dispatch"], prev)
    if flagged is None:
        assert prev == "aten.add.Tensor" and not hit
    else:
        assert prev == flagged and hit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_student_forward_hands_its_grid_to_k1_without_a_copy(k1, dtype):
    """The fast forward's record as the fallback reads it: K1 last, a bias
    add before it (as the card's kernels show)."""
    from ams_tpu_torch.models.mobilenetv2_deeplab import (
        init_student_params,
        student_predict_fast,
    )

    params = init_student_params(0, device="cpu")
    frames = torch.from_numpy(chip_smoke.synthetic_frames(2, 64, 128, 0))
    with torch.inference_mode():
        names = chip_smoke.ops_in_order(
            lambda: student_predict_fast(params, frames, (0, 1, 2, 5, 8),
                                         compute_dtype=dtype),
            device="cpu")
    assert names[-1] == "resize_argmax" and names.count("resize_argmax") == 1
    assert names[-2] == "aten.add.Tensor"
    assert not re.search(chip_smoke.HANDOVER_COPY["dispatch"], names[-2])
