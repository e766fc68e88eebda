"""The edge client's ids brought home into page-locked blocks of PyTorch's
caching host allocator (``SemanticNetwork._download_ids``), on the card:
each answer owns its block, equals the device's ids bit for bit, and a
client whose answers are dropped reuses its blocks instead of allocating.

Card only; imports no JAX, so it runs on a card machine with
``pytest --noconftest -m cuda tests/test_torch_pinned_download.py``."""

import numpy as np
import pytest
import torch

from ams_tpu_torch.models.frozen import fold_student
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.runtime.network import SemanticNetwork
from ams_tpu_torch.utils.trace import GLOBAL_TIMER

B, H, W = 4, 512, 1024
CLASSES = (0, 1, 2, 5, 7, 8, 10, 11, 13)


def frozen_bf16_client():
    """The deployed client at full size, with every ids tensor it
    downloads kept in ``preds`` (device tensors, in request order)."""
    cw = np.zeros(19, np.float32)
    cw[list(CLASSES)] = 1.0
    net = SemanticNetwork(fold_student(init_student_params(0,
                                                           device="cuda")),
                          class_weights_exp=cw, height=H, frozen=True,
                          compute_dtype="bfloat16", device="cuda")
    net.preds = []
    fast = net._fast

    def keep(*args):
        out = fast(*args)
        net.preds.append(out)
        return out

    net._fast = keep
    return net


def host_allocs():
    return torch.cuda.host_memory_stats()["num_host_alloc"]


@pytest.mark.cuda
def test_ids_land_in_caller_owned_pinned_blocks():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned download is CUDA only")
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (7, B, H, W, 3)).astype(np.uint8)
    net = frozen_bf16_client()

    ans = net.predict_input(frames[0])
    assert ans.shape == (B, H, W) and ans.dtype == np.int32
    assert torch.from_numpy(ans).is_pinned()
    np.testing.assert_array_equal(ans, net.preds[0].cpu().numpy())
    assert 0 <= ans.min() and ans.max() < len(CLASSES)
    del ans

    kept = [net.predict_input(f) for f in frames[1:]]
    ptrs = {a.__array_interface__["data"][0] for a in kept}
    assert len(ptrs) == len(kept)
    for a, p in zip(kept, net.preds[1:]):
        assert torch.from_numpy(a).is_pinned()
        np.testing.assert_array_equal(a, p.cpu().numpy())
    del kept
    net.preds.clear()

    net.predict_input(frames[0])
    allocs, fresh = host_allocs(), GLOBAL_TIMER.counts["network/pinned_fresh"]
    downloads = GLOBAL_TIMER.counts["network/pinned_download"]
    for i in range(19):
        net.predict_input(frames[i % len(frames)])
    assert host_allocs() == allocs
    assert GLOBAL_TIMER.counts["network/pinned_fresh"] == fresh
    assert GLOBAL_TIMER.counts["network/pinned_download"] == downloads + 19
