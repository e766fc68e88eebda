"""The port's fused resize+CE (K2) against ams_tpu's, on the CPU.

On the CPU the port's wrapper runs its plain version, whose gradient
autograd supplies; the CUDA kernels run only on the card (chip_smoke.py
holds them against the plain version there, and the one ``cuda``-marked
test below skips without a card).  The same seeded numpy inputs go to
``ams_tpu``'s Pallas kernel in interpret mode and to its
``resize_ce_reference``.

Tolerances, the bar of tests/test_fused_ce.py: the loss to rtol 1e-5 (the
Pallas kernel upsamples by matmuls, the port by lerps: f32 rounding
differs); the grid gradient to rtol 1e-4 / atol 1e-6.  The all-invalid
case is exactly 0 in loss and gradient.  The numpy emulation of the CUDA
kernel's blocks and sum order, on the wrapper's plan, agrees with the
plain loss to rtol 1e-5 and with float64 autograd's gradient to rtol
1e-5 / atol 1e-9 (the same sums in another order, in float64).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ams_tpu.ops.fused_resize_ce import (
    fused_resize_ce as jax_fused_resize_ce,
    resize_ce_reference,
)

from ams_tpu_torch.models.resize import _lerp_weights
from ams_tpu_torch.ops import build
from ams_tpu_torch.ops import fused_resize_ce as frc


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _launches():
    """(loss-only, with-gradient) launches, as ``ops.build`` counts them."""
    return (build.launch_count("resize_ce_loss"),
            build.launch_count("resize_ce_loss_grad"))


def _case(seed, b, gh, gw, nc, h, w, p_valid=0.7):
    rng = np.random.RandomState(seed)
    grid = rng.randn(b, gh, gw, nc).astype(np.float32) * 2
    labels = rng.randint(0, nc, (b, h, w)).astype(np.int32)
    weights = (rng.rand(b, h, w) < p_valid).astype(np.float32)
    return grid, labels, weights


def _port_loss_and_grad(grid, labels, weights, hw):
    g = torch.from_numpy(np.ascontiguousarray(grid.transpose(0, 3, 1, 2)))
    g.requires_grad_(True)
    loss = frc.fused_resize_ce(g, torch.from_numpy(labels),
                               torch.from_numpy(weights), hw)
    (grad,) = torch.autograd.grad(loss, g)
    return float(loss.detach()), grad.numpy().transpose(0, 2, 3, 1)


def _jax_loss_and_grad(fn, grid, labels, weights, hw):
    loss, grad = jax.value_and_grad(
        lambda gg: fn(gg, jnp.asarray(labels), jnp.asarray(weights), hw))(
            jnp.asarray(grid))
    return float(loss), np.asarray(grad)


CASES = {
    "round_subset": (0, 2, 5, 9, 6, 64, 128),
    "odd_height": (1, 2, 5, 9, 6, 65, 128),
    "ragged": (2, 3, 5, 9, 7, 65, 127),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret_and_reference(name):
    seed, b, gh, gw, nc, h, w = CASES[name]
    grid, labels, weights = _case(seed, b, gh, gw, nc, h, w)
    loss, grad = _port_loss_and_grad(grid, labels, weights, (h, w))
    for fn in (lambda g, l, wt, hw: jax_fused_resize_ce(g, l, wt, hw, True),
               resize_ce_reference):
        j_loss, j_grad = _jax_loss_and_grad(fn, grid, labels, weights,
                                            (h, w))
        np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
        np.testing.assert_allclose(grad, j_grad, rtol=1e-4, atol=1e-6)


def test_all_invalid_pixels_give_exact_zeros():
    grid, labels, _ = _case(3, 2, 5, 9, 6, 64, 128)
    zero_w = np.zeros(labels.shape, np.float32)
    loss, grad = _port_loss_and_grad(grid, labels, zero_w, (64, 128))
    assert loss == 0.0
    assert np.abs(grad).max() == 0.0
    j_loss = float(jax_fused_resize_ce(jnp.asarray(grid),
                                       jnp.asarray(labels),
                                       jnp.asarray(zero_w), (64, 128), True))
    assert j_loss == 0.0


def test_cpu_wrapper_routes_to_the_plain_version():
    grid, labels, weights = _case(4, 2, 5, 9, 6, 33, 65)
    g = torch.from_numpy(np.ascontiguousarray(grid.transpose(0, 3, 1, 2)))
    lab, wt = torch.from_numpy(labels), torch.from_numpy(weights)
    n0 = _launches()
    got = frc.fused_resize_ce(g, lab, wt, (33, 65))
    want = frc.resize_ce_plain(g, lab, wt, (33, 65))
    assert torch.equal(got, want)
    assert _launches() == n0
    with pytest.raises(ValueError):
        frc.fused_resize_ce(g, lab[:, :-1], wt, (33, 65))
    with pytest.raises(ValueError):
        frc.fused_resize_ce(g[0], lab, wt, (33, 65))


def emulate_kernel(grid, labels, weights, out_hw, plan=None):
    """numpy, in float64: the CUDA kernel's blocks and sums, built on the
    wrapper's own plan (or ``plan``).  One block per (image, band, tile): per column, the
    band's rows in order into a top and a bottom sum per class; per chunk,
    the x range of each (class, side, grid column) into the tile's partial;
    then each grid cell sums its (band, side) partials in the finishing
    order, the tile to the left first.  grid (B, C, gh, gw) -> (loss,
    total, unnormalized gradient)."""
    b, c, gh, gw = grid.shape
    h, w = out_hw
    plan = plan or frc.resize_ce_plan(gh, gw, h, w)
    _, _, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    yw, xw = yw.astype(np.float64), xw.astype(np.float64)
    g = grid.astype(np.float64)
    classes = np.arange(c)[None, :, None]
    part = np.zeros((b, gh, 2, c, plan.sumcol))
    num = np.zeros(b)
    den = np.zeros(b)
    for band in range(gh):
        ys, ye = plan.bands[band]
        rows = g[:, :, band], g[:, :, min(band + 1, gh - 1)]
        for g0, g1, xs, xe, poff in plan.tiles:
            ncol = min(g1, gw - 1) - g0 + 1
            spart = np.zeros((b, 2, c, ncol))
            for cx0 in range(xs, xe, plan.threads):
                x = np.arange(cx0, min(cx0 + plan.threads, xe))
                wx = xw[x]
                top, bot = (r[..., xlo[x]] + (r[..., xhi[x]] - r[..., xlo[x]])
                            * wx for r in rows)
                acc = np.zeros((b, 2, c, len(x)))
                for y in range(ys, ye):
                    u = top + (bot - top) * yw[y]
                    m = u.max(1, keepdims=True)
                    e = np.exp(u - m)
                    s = e.sum(1)
                    lab, v = labels[:, y, x], weights[:, y, x]
                    ok = (lab >= 0) & (lab < c)
                    u_lab = np.take_along_axis(
                        u, np.clip(lab, 0, c - 1)[:, None], 1)[:, 0]
                    ce = np.where(ok, np.log(s) - (u_lab - m[:, 0]), 0.0)
                    num += (ce * v).sum(-1)
                    den += v.sum(-1)
                    gk = (e / s[:, None] - (lab[:, None] == classes)) \
                        * np.where(ok, v, 0.0)[:, None]
                    acc[:, 0] += gk * (1 - yw[y])
                    acc[:, 1] += gk * yw[y]
                for j in range(ncol):
                    r = plan.xr[g0 + j] - cx0
                    lo = slice(max(r[0], 0), min(r[1], len(x)))
                    hi = slice(max(r[2], 0), min(r[3], len(x)))
                    spart[..., j] += (acc[..., lo] * (1 - wx[lo])).sum(-1) \
                        + (acc[..., hi] * wx[hi]).sum(-1)
            part[:, band, ..., poff:poff + ncol] = spart
    grad = np.zeros((b, c, gh, gw))
    for gx in range(gw):
        t = plan.tile_of[gx]
        g0, _, _, _, poff = plan.tiles[t]
        cols = [poff + gx - g0]
        if gx == g0 and t > 0:
            p0, p1, _, _, ppoff = plan.tiles[t - 1]
            cols.insert(0, ppoff + p1 - p0)
        for gy in range(gh):
            sides = [(gy, 0)] + [(gy - 1, 1)] * (gy > 0) \
                + [(gy, 1)] * (gy == gh - 1)
            for band, side in sides:
                for col in cols:
                    grad[:, :, gy, gx] += part[:, band, side, :, col]
    total = max(den.sum(), 1.0)
    return num.sum() / total, total, grad


# the server round's shape at batch 2, and the edge cases of the plan
PLAN_CASES = {
    "server": (2, 19, 17, 33, 256, 512),
    "ragged": (3, 7, 5, 9, 65, 127),
    "gh_1": (2, 5, 1, 9, 64, 128),
    "gw_1": (2, 5, 5, 1, 64, 300),
    "h_below_gh": (2, 6, 33, 65, 16, 32),
    "w_not_tile_multiple": (2, 6, 5, 20, 64, 300),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_covers_each_pixel_once_and_reaches_only_adjacent_cells(name):
    """Bands and tiles partition the output; every row of band gy lerps
    between grid rows gy and min(gy + 1, gh - 1), every column of a tile
    between grid columns the tile owns; and the finishing order gives each
    grid cell exactly the rows and columns whose lerp touches it."""
    _, _, gh, gw, h, w = PLAN_CASES[name]
    plan = frc.resize_ce_plan(gh, gw, h, w)
    ylo, yhi, _ = _lerp_weights(gh, h)
    xlo, xhi, _ = _lerp_weights(gw, w)
    rows = np.concatenate([np.arange(*r) for r in plan.bands])
    np.testing.assert_array_equal(rows, np.arange(h))
    for gy, (ys, ye) in enumerate(plan.bands):
        assert (ylo[ys:ye] == gy).all()
        assert (yhi[ys:ye] == min(gy + 1, gh - 1)).all()
    g0, g1, xs, xe, poff = plan.tiles.T
    np.testing.assert_array_equal(np.concatenate([[0], g1[:-1]]), g0)
    assert g1[-1] == gw and (g1 > g0).all()
    cols = np.concatenate([np.arange(a, z) for a, z in zip(xs, xe)])
    np.testing.assert_array_equal(cols, np.arange(w))
    ncol = np.minimum(g1, gw - 1) - g0 + 1
    np.testing.assert_array_equal(poff, np.cumsum(ncol) - ncol)
    assert plan.sumcol == ncol.sum() and plan.ncol_max == ncol.max()
    for t in range(len(plan.tiles)):
        x = np.arange(xs[t], xe[t])
        assert (xe[t] - xs[t] <= plan.threads
                or g1[t] - g0[t] == 1), "a tile wider than its block"
        assert ((xlo[x] >= g0[t]) & (xlo[x] < g1[t])).all()
        assert ((xhi[x] >= g0[t]) & (xhi[x] < g0[t] + ncol[t])).all()
    for gx in range(gw):
        t = plan.tile_of[gx]
        assert g0[t] <= gx < g1[t]
        # the columns the finisher reads for gx: x of tile t through its
        # column gx - g0, and of tile t - 1 through its last column
        reach = [x for x in range(xs[t], xe[t])
                 if xlo[x] == gx or xhi[x] == gx]
        if gx == g0[t] and t > 0:
            reach += [x for x in range(xs[t - 1], xe[t - 1])
                      if xhi[x] == gx]
        want = np.flatnonzero((xlo == gx) | (xhi == gx))
        np.testing.assert_array_equal(np.sort(reach), want)
        assert len(set(reach)) == len(reach)
    for gy in range(gh):
        sides = [(gy, 0)] + [(gy - 1, 1)] * (gy > 0) \
            + [(gy, 1)] * (gy == gh - 1)
        reach = [(y, side) for band, side in sides
                 for y in range(*plan.bands[band])]
        want = [(y, 0) for y in np.flatnonzero(ylo == gy)] \
            + [(y, 1) for y in np.flatnonzero(yhi == gy)]
        assert sorted(reach) == sorted(want)


def _dense64(n_in, n_out):
    """(n_out, n_in) float64 align-corners lerp matrix of the same tables."""
    lo, hi, wt = _lerp_weights(n_in, n_out)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), lo), 1.0 - wt.astype(np.float64))
    np.add.at(m, (np.arange(n_out), hi), wt.astype(np.float64))
    return torch.from_numpy(m)


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_kernel_sum_order_reproduces_loss_and_gradient(name):
    """The kernel's blocks, band sums, tile contractions and finishing
    order, emulated in numpy on the wrapper's plan, give the plain loss
    (rtol 1e-5) and the unnormalized gradient that autograd gives for the
    same loss in float64 (rtol 1e-5, atol 1e-9: the same sums in another
    order; float32 autograd would add its own rounding over hundreds of
    terms of either sign per grid cell)."""
    _check_emulation(*PLAN_CASES[name])


def _check_emulation(b, nc, gh, gw, h, w, plan=None):
    grid, labels, weights = _case(7, b, gh, gw, nc, h, w)
    labels[0, 0, :3] = [-1, nc, nc + 5]         # out of range: CE 0, no grad
    nchw = np.ascontiguousarray(grid.transpose(0, 3, 1, 2))
    lab, wt = torch.from_numpy(labels), torch.from_numpy(weights)
    plain = float(frc.resize_ce_plain(torch.from_numpy(nchw), lab, wt,
                                      (h, w)))
    g64 = torch.from_numpy(nchw).double().requires_grad_(True)
    full = torch.einsum("Hg,bcgw,Ww->bcHW", _dense64(gh, h), g64,
                        _dense64(gw, w))
    onehot = lab.long()[:, None] == torch.arange(nc)[None, :, None, None]
    ce = -(onehot * torch.log_softmax(full, dim=1)).sum(1)
    (want,) = torch.autograd.grad((ce * wt.double()).sum(), g64)
    total = max(float(weights.sum()), 1.0)
    e_loss, e_total, e_grad = emulate_kernel(nchw, labels, weights, (h, w),
                                             plan)
    assert e_total == total
    np.testing.assert_allclose(e_loss, plain, rtol=1e-5)
    np.testing.assert_allclose(e_grad, want.numpy(), rtol=1e-5, atol=1e-9)


def _smem_bytes(c, threads, ncol_max, want_grad):
    """Stand-in for the kernel's ``resize_ce_smem_bytes`` (its
    ``band_smem_floats`` in bytes), since the CPU has no kernel to ask."""
    return 4 * (threads + want_grad * (threads + 2 * c * (threads + 1)
                                       + 2 * c * ncol_max))


H100_SMEM_PER_BLOCK = 232448    # cudaDevAttrMaxSharedMemoryPerBlockOptin


def _step_of(plan, gh, gw, h, w):
    """The first of PLAN_STEPS whose (cached) plan is ``plan``."""
    return next(i for i, st in enumerate(frc.PLAN_STEPS)
                if frc.resize_ce_plan(gh, gw, h, w, *st) is plan)


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_class_plan_shrinks_with_the_class_count(name):
    """class_plan keeps the default plan while its band block fits (every
    count up to 96 here), then steps down to fewer threads and intervals
    per tile as C grows, never back up; every plan fits the card's
    shared memory and keeps whole grid intervals per tile; 512 classes
    fit at every shape."""
    _, _, gh, gw, h, w = PLAN_CASES[name]
    xlo, _, _ = _lerp_weights(gw, w)
    default = frc.resize_ce_plan(gh, gw, h, w)
    last = 0
    for c in (1, 6, 19, 32, 33, 96, 128, 150, 209, 256, 384, 512, 640):
        plan = frc.class_plan(c, gh, gw, h, w, _smem_bytes,
                              H100_SMEM_PER_BLOCK)
        assert _smem_bytes(c, plan.threads, plan.ncol_max, 1) \
            <= H100_SMEM_PER_BLOCK
        step = _step_of(plan, gh, gw, h, w)
        assert step >= last
        last = step
        if c <= 96:
            assert step == 0
            assert plan.threads == default.threads
            np.testing.assert_array_equal(plan.tiles, default.tiles)
        g0, g1, xs, xe, _ = plan.tiles.T
        np.testing.assert_array_equal(np.concatenate([[0], g1[:-1]]), g0)
        cols = np.concatenate([np.arange(a, z) for a, z in zip(xs, xe)])
        np.testing.assert_array_equal(cols, np.arange(w))
        for t in range(len(plan.tiles)):
            x = np.arange(xs[t], xe[t])
            assert ((xlo[x] >= g0[t]) & (xlo[x] < g1[t])).all()
    assert frc.PLAN_STEPS[last][0] == 32 or last == 0


def test_class_plan_raises_past_its_last_step():
    """Past the smallest step the planner names the class count and the
    bytes; the server round's shape takes up to 829 classes on an H100
    (64 + 70 C floats at 32 threads, one interval per tile)."""
    kw = dict(smem_bytes=_smem_bytes, smem_limit=H100_SMEM_PER_BLOCK)
    plan = frc.class_plan(829, 17, 33, 256, 512, **kw)
    assert plan.threads == 32
    with pytest.raises(ValueError, match="830 classes"):
        frc.class_plan(830, 17, 33, 256, 512, **kw)


def test_smallest_plan_reproduces_loss_and_gradient():
    """The kernel's sums on the last step's plan (32 threads, one grid
    interval per tile), as class_plan gives it to many classes, at 40
    classes: the same bars as the default plan's emulation."""
    b, nc, gh, gw, h, w = 2, 40, 5, 9, 64, 128
    _check_emulation(b, nc, gh, gw, h, w,
                     frc.resize_ce_plan(gh, gw, h, w, *frc.PLAN_STEPS[-1]))


def test_autograd_node_launches_once_and_its_backward_none(monkeypatch):
    """Under grad the node's forward launches the kernel with the gradient
    once, and its backward scales the saved gradient by g / total without
    a launch; the loss-only launch serves calls without grad.  The launch
    itself is the numpy emulation here (the kernel runs only on the
    card), and its calls, with or without the gradient, are the count."""
    seed, b, gh, gw, nc, h, w = CASES["ragged"]
    grid, labels, weights = _case(seed, b, gh, gw, nc, h, w)

    launched = []

    def fake_launch(grid_t, lab, wt, out_hw, want_grad, groups=None):
        launched.append(want_grad)
        loss, total, grad = emulate_kernel(grid_t.detach().numpy(),
                                           lab.numpy(), wt.numpy(), out_hw)
        f32 = functools.partial(torch.tensor, dtype=torch.float32)
        return f32(loss), f32(total), f32(grad) if want_grad else None

    monkeypatch.setattr(frc, "_launch", fake_launch)
    g = torch.from_numpy(np.ascontiguousarray(grid.transpose(0, 3, 1, 2)))
    g.requires_grad_(True)
    lab, wt = torch.from_numpy(labels), torch.from_numpy(weights)
    loss, _, _ = frc._ResizeCE.apply(g, lab, wt, (h, w))
    assert launched == [True]
    (got,) = torch.autograd.grad(loss * 3.0, g)
    assert launched == [True]
    ref = frc.resize_ce_plain(g, lab, wt, (h, w))
    (want,) = torch.autograd.grad(ref * 3.0, g)
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    only, total = frc.resize_ce_loss(g.detach(), lab, wt, (h, w))
    assert launched == [True, False]
    assert float(total) == max(float(weights.sum()), 1.0)
    torch.testing.assert_close(only, ref.detach(), rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check "
                    "on the card")
    grid, labels, weights = _case(5, 2, 5, 9, 6, 64, 128)
    g = torch.from_numpy(np.ascontiguousarray(
        grid.transpose(0, 3, 1, 2))).cuda().requires_grad_(True)
    lab = torch.from_numpy(labels).cuda()
    wt = torch.from_numpy(weights).cuda()
    n0 = _launches()
    loss = frc.fused_resize_ce(g, lab, wt, (64, 128))
    (grad,) = torch.autograd.grad(loss, g)
    assert _launches() == (n0[0], n0[1] + 1)
    with torch.no_grad():
        only = frc.fused_resize_ce(g, lab, wt, (64, 128))
    assert _launches() == (n0[0] + 1, n0[1] + 1)
    ref = frc.resize_ce_plain(g, lab, wt, (64, 128))
    (ref_grad,) = torch.autograd.grad(ref, g)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(only, ref.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4, atol=1e-6)
