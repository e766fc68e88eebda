"""The port's resize+argmax against ams_tpu's Pallas kernel and reference.

On the CPU the wrapper runs its plain version (gather-form resize +
``torch.argmax``).  It is held against the Pallas kernel in interpret mode
and against ``resize_argmax_reference``: ids equal wherever the top-2
margin of the full-resolution logits exceeds 1e-5 (the tie margin of
tests/test_ops.py; the Pallas kernel's matmul-form lerp rounds differently
at exact ties).  The CUDA kernel itself is compared with the plain version
on the card by the ``cuda``-marked test and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.models.resize import resize_bilinear_ac as j_resize
from ams_tpu.ops.fused_resize_argmax import (
    fused_resize_argmax as j_fused,
    resize_argmax_reference as j_reference,
)

from ams_tpu_torch.ops import build
from ams_tpu_torch.ops import fused_resize_argmax as fra

TIE_MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _grid(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)


def _decisive(grid_nhwc, out_hw):
    full = np.asarray(j_resize(jnp.asarray(grid_nhwc), out_hw))
    srt = np.sort(full, -1)
    return (srt[..., -1] - srt[..., -2]) > TIE_MARGIN


@pytest.mark.parametrize("shape,out_hw,tile_h", [
    ((2, 5, 9, 19), (64, 128), 16),     # the client's 19 classes
    ((2, 5, 9, 6), (64, 128), 16),      # an experiment's class subset
    ((2, 7, 11, 7), (49, 83), 8),       # ragged: rows not a tile multiple
])
def test_plain_matches_pallas_and_reference(shape, out_hw, tile_h):
    g = _grid(shape, sum(shape))
    ours = fra.fused_resize_argmax(
        torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))),
        out_hw).numpy()
    pallas = np.asarray(j_fused(jnp.asarray(g), out_hw, tile_h=tile_h,
                                interpret=True))
    ref = np.asarray(j_reference(jnp.asarray(g), out_hw))
    assert ours.dtype == np.int32 and ours.shape == ref.shape
    decisive = _decisive(g, out_hw)
    assert decisive.mean() > 0.999
    np.testing.assert_array_equal(ours[decisive], pallas[decisive])
    np.testing.assert_array_equal(ours[decisive], ref[decisive])


def test_ties_keep_lowest_id():
    g = np.zeros((1, 6, 3, 4), np.float32)
    g[0, 2] = 1.0
    g[0, 4] = 1.0          # exact tie with class 2 everywhere
    g[0, 5, 1, 1] = 5.0    # class 5 wins near one grid point
    ids = fra.fused_resize_argmax(torch.from_numpy(g), (5, 7)).numpy()
    ref = np.asarray(j_reference(jnp.asarray(g.transpose(0, 2, 3, 1)),
                                 (5, 7)))
    np.testing.assert_array_equal(ids, ref)
    assert set(np.unique(ids)) == {2, 5}


def test_cpu_tensor_never_touches_the_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = fra.fused_resize_argmax.launches
    out = fra.fused_resize_argmax(torch.from_numpy(_grid((1, 3, 4, 5), 0)),
                                  (7, 9))
    assert out.shape == (1, 7, 9)
    assert fra.fused_resize_argmax.launches == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        fra.fused_resize_argmax(torch.zeros(3, 4, 5), (7, 9))
    with pytest.raises(ValueError):
        fra.fused_resize_argmax(torch.zeros(1, 3, 4, 5, device="meta"),
                                (7, 9))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernel is CUDA only")
    for (b, c, gh, gw, h, w) in [(8, 19, 33, 65, 512, 1024),
                                 (8, 6, 33, 65, 512, 1024),
                                 (3, 7, 17, 33, 257, 513)]:
        grid = torch.from_numpy(_grid((b, c, gh, gw), c)).cuda()
        before = fra.fused_resize_argmax.launches
        got = fra.fused_resize_argmax(grid, (h, w))
        want = fra.resize_argmax_plain(grid, (h, w))
        torch.cuda.synchronize()
        assert fra.fused_resize_argmax.launches == before + 1
        assert torch.equal(got, want)
