"""The port's resize+argmax against ams_tpu's Pallas kernel and reference.

On the CPU the wrapper runs its plain version (gather-form resize +
``torch.argmax``).  It is held against the Pallas kernel in interpret mode
and against ``resize_argmax_reference``: ids equal wherever the top-2
margin of the full-resolution logits exceeds 1e-5 (the tie margin of
tests/test_ops.py; the Pallas kernel's matmul-form lerp rounds differently
at exact ties).  The CUDA kernel itself is compared with the plain version
on the card by the ``cuda``-marked test and by chip_smoke.py.

The kernel's plan (band runs and column tiles) is checked on the CPU, and
a numpy emulation of its arithmetic on that plan (per band run each
class's horizontal lerps once, then a running maximum down the rows, in
chunks of 32 classes past 32, in float32) equals the plain version bit
for bit.  The wrapper's class index and bfloat16 or channels-last grids
go through the plain version on the CPU, held against the Pallas kernel
and the reference on the gathered float32 grid.
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

from ams_tpu_torch.models.resize import _lerp_weights
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
    before = build.launch_count("resize_argmax")
    out = fra.fused_resize_argmax(torch.from_numpy(_grid((1, 3, 4, 5), 0)),
                                  (7, 9))
    assert out.shape == (1, 7, 9)
    assert build.launch_count("resize_argmax") == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        fra.fused_resize_argmax(torch.zeros(3, 4, 5), (7, 9))
    with pytest.raises(ValueError):
        fra.fused_resize_argmax(torch.zeros(1, 3, 4, 5, device="meta"),
                                (7, 9))


# (gh, gw, h, w): the client, ragged, an output below the grid, the grid's
# own size, one grid row, and a width below one tile
PLAN_SHAPES = {
    "client": (33, 65, 512, 1024),
    "ragged": (17, 33, 257, 513),
    "h_below_gh": (33, 65, 16, 32),
    "h_equals_gh": (33, 65, 33, 65),
    "gh_1": (1, 9, 64, 128),
    "w_below_tile": (5, 9, 64, 20),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_bands_and_tiles_cover_the_output_once(name):
    """Every output row lies in exactly one band run, all rows of a run
    share (ylo, yhi) with the run's grid rows, runs are non-empty and at
    most MAX_BAND_ROWS long, and the column tiles cover each column
    once."""
    gh, gw, h, w = PLAN_SHAPES[name]
    plan = fra.resize_argmax_plan(gh, gw, h, w)
    ylo, yhi, _ = _lerp_weights(gh, h)
    seen = np.zeros(h, np.int64)
    for top, bot, ys, ye in plan.bands:
        assert 0 < ye - ys <= fra.MAX_BAND_ROWS
        assert (ylo[ys:ye] == top).all() and (yhi[ys:ye] == bot).all()
        seen[ys:ye] += 1
    assert (seen == 1).all()
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= fra.MAX_THREADS
    cols = np.zeros(w, np.int64)
    for t in range(plan.n_tiles):
        cols[t * plan.threads:min((t + 1) * plan.threads, w)] += 1
    assert (cols == 1).all() and (plan.n_tiles - 1) * plan.threads < w
    assert plan.blocks(3) == 3 * len(plan.bands) * plan.n_tiles


def emulate_kernel(grid, out_hw, class_index=None):
    """numpy, in float32: the CUDA kernel's arithmetic on the wrapper's
    own plan.  Per band run and class, the two horizontal lerps of each
    column once (top, and d = bottom - top); per row a running (best, idx)
    over the classes with a strict ``>``, started at the first class, with
    classes past the last padded by (-inf, 0) up to the register bound
    (a multiple of 4) and, past 32 classes, chunks of 32.  grid (B, C,
    gh, gw) numpy -> (B, H, W) int32."""
    b, c, gh, gw = grid.shape
    h, w = out_hw
    ids = list(range(c)) if class_index is None else list(class_index)
    n = len(ids)
    width = -(-n // 4) * 4 if n <= 32 else -(-n // 32) * 32
    plan = fra.resize_argmax_plan(gh, gw, h, w)
    _, _, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    g = grid.astype(np.float32)
    out = np.zeros((b, h, w), np.int32)
    for top_row, bot_row, ys, ye in plan.bands:
        top = np.full((width, b, w), -np.inf, np.float32)
        d = np.zeros((width, b, w), np.float32)
        for k, cls in enumerate(ids):
            r0, r1 = g[:, cls, top_row], g[:, cls, bot_row]
            top[k] = r0[:, xlo] + (r0[:, xhi] - r0[:, xlo]) * xw
            d[k] = (r1[:, xlo] + (r1[:, xhi] - r1[:, xlo]) * xw) - top[k]
        for y in range(ys, ye):
            best = top[0] + d[0] * yw[y]
            idx = np.zeros((b, w), np.int32)
            for k in range(1, width):
                v = top[k] + d[k] * yw[y]
                win = v > best
                best = np.where(win, v, best)
                idx = np.where(win, k, idx)
            out[:, y] = idx
    return out


# (b, c, gh, gw, h, w, class index)
EMULATION_CASES = {
    "client_subset": (2, 19, 33, 65, 128, 256, (0, 1, 2, 8, 10, 13)),
    "ragged": (2, 7, 17, 33, 257, 513, None),
    "h_below_gh": (2, 19, 33, 65, 16, 32, None),
    "h_equals_gh": (1, 5, 33, 65, 33, 65, None),
    "gh_1": (2, 3, 1, 9, 64, 128, None),
    "w_1": (2, 7, 17, 33, 60, 1, None),
    "one_class": (1, 1, 5, 9, 40, 70, None),
    "classes_40_chunked": (1, 40, 9, 17, 70, 130, None),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_kernel_arithmetic_equals_plain_bit_for_bit(name):
    b, c, gh, gw, h, w, ci = EMULATION_CASES[name]
    g = _grid((b, c, gh, gw), c + gh)
    got = emulate_kernel(g, (h, w), ci)
    want = fra.resize_argmax_plain(torch.from_numpy(g), (h, w), ci).numpy()
    np.testing.assert_array_equal(got, want)


def _exp25_like(c):
    return tuple(range(0, c, 3))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_bf16_grid_with_class_index_matches_pallas_and_reference(layout):
    """A bf16 grid (NCHW, or channels-last as the bf16 forward leaves it)
    with a class table, through the wrapper's CPU path, against JAX's
    Pallas kernel and reference on the gathered float32 grid."""
    b, c, gh, gw, out_hw = 2, 19, 5, 9, (64, 128)
    g = torch.from_numpy(_grid((b, c, gh, gw), 11)).to(torch.bfloat16)
    if layout == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last)
    ci = _exp25_like(c)
    ours = fra.fused_resize_argmax(g, out_hw, ci).numpy()
    gathered = g.float()[:, list(ci)].permute(0, 2, 3, 1).numpy()
    pallas = np.asarray(j_fused(jnp.asarray(gathered), out_hw, tile_h=16,
                                interpret=True))
    ref = np.asarray(j_reference(jnp.asarray(gathered), out_hw))
    assert ours.dtype == np.int32 and ours.shape == ref.shape
    decisive = _decisive(gathered, out_hw)
    assert decisive.mean() > 0.999
    np.testing.assert_array_equal(ours[decisive], pallas[decisive])
    np.testing.assert_array_equal(ours[decisive], ref[decisive])
    # the same ids whatever form the class index takes
    for form in (list(ci), np.asarray(ci),
                 torch.tensor(ci, dtype=torch.long)):
        np.testing.assert_array_equal(
            fra.fused_resize_argmax(g, out_hw, form).numpy(), ours)


def test_class_index_out_of_range_is_rejected():
    g = torch.from_numpy(_grid((1, 6, 3, 4), 0))
    for bad in ((0, 6), (-1, 2), ()):
        with pytest.raises(ValueError):
            fra.fused_resize_argmax(g, (7, 9), bad)
    fra.fused_resize_argmax(g, (7, 9), (5, 0))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernel is CUDA only")
    for (b, c, gh, gw, h, w, dtype, cl, ci) in [
            (8, 19, 33, 65, 512, 1024, torch.float32, False, None),
            (8, 6, 33, 65, 512, 1024, torch.float32, False, None),
            (3, 7, 17, 33, 257, 513, torch.float32, False, None),
            (8, 19, 33, 65, 512, 1024, torch.bfloat16, True,
             _exp25_like(19)),
            (2, 19, 33, 65, 512, 1024, torch.float32, True, (3, 1, 4)),
            (2, 96, 33, 65, 512, 1024, torch.float32, False, None),
            (2, 1, 33, 65, 512, 1024, torch.float32, False, None),
            (2, 19, 33, 65, 16, 32, torch.bfloat16, False, None),
            (2, 7, 17, 33, 257, 1, torch.float32, False, None)]:
        grid = torch.from_numpy(_grid((b, c, gh, gw), c)).cuda().to(dtype)
        if cl:
            grid = grid.contiguous(memory_format=torch.channels_last)
        before = build.launch_count("resize_argmax")
        got = fra.fused_resize_argmax(grid, (h, w), ci)
        want = fra.resize_argmax_plain(grid, (h, w), ci)
        torch.cuda.synchronize()
        assert build.launch_count("resize_argmax") == before + 1
        assert torch.equal(got, want)
        with pytest.raises(ValueError):
            fra.fused_resize_argmax(grid, (h, w), (c,))
