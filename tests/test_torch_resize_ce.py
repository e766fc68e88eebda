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
backward's separable, range-table form agrees with autograd to rtol 1e-5
/ atol 1e-7 (the same sums in another order).
"""

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
from ams_tpu_torch.ops import fused_resize_ce as frc


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


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
    fwd0, bwd0 = frc.resize_ce_fwd.launches, frc.resize_ce_bwd.launches
    got = frc.fused_resize_ce(g, lab, wt, (33, 65))
    want = frc.resize_ce_plain(g, lab, wt, (33, 65))
    assert torch.equal(got, want)
    assert (frc.resize_ce_fwd.launches, frc.resize_ce_bwd.launches) == \
        (fwd0, bwd0)
    with pytest.raises(ValueError):
        frc.fused_resize_ce(g, lab[:, :-1], wt, (33, 65))
    with pytest.raises(ValueError):
        frc.fused_resize_ce(g[0], lab, wt, (33, 65))


def test_backward_range_tables_reproduce_the_gradient():
    """The CUDA backward sums G over x by the inverse ranges of the lerp
    tables (pass A), then over y (pass B).  The same sums in numpy, with
    the wrapper's own tables, give autograd's unnormalized gradient."""
    seed, b, gh, gw, nc, h, w = CASES["ragged"]
    grid, labels, weights = _case(seed, b, gh, gw, nc, h, w)
    g = torch.from_numpy(np.ascontiguousarray(grid.transpose(0, 3, 1, 2)))
    g.requires_grad_(True)
    loss = frc.resize_ce_plain(g, torch.from_numpy(labels),
                               torch.from_numpy(weights), (h, w))
    (want,) = torch.autograd.grad(loss, g)
    want = want.numpy() * max(weights.sum(), 1.0)

    from ams_tpu_torch.models.resize import resize_nchw
    full = resize_nchw(g.detach(), (h, w)).numpy().astype(np.float64)
    p = np.exp(full - full.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = labels[:, None] == np.arange(nc)[None, :, None, None]
    gmat = (p - onehot) * weights[:, None]                  # (b, nc, h, w)

    ylo, yhi, yw = _lerp_weights(gh, h)
    xlo, xhi, xw = _lerp_weights(gw, w)
    yr = frc._ranges(ylo, yhi, gh).reshape(gh, 4)
    xr = frc._ranges(xlo, xhi, gw).reshape(gw, 4)
    hsum = np.zeros((b, nc, h, gw))
    for gx in range(gw):
        lo = slice(xr[gx, 0], xr[gx, 1])
        hi = slice(xr[gx, 2], xr[gx, 3])
        hsum[..., gx] = (gmat[..., lo] * (1 - xw[lo])).sum(-1) \
            + (gmat[..., hi] * xw[hi]).sum(-1)
    got = np.zeros((b, nc, gh, gw))
    for gy in range(gh):
        lo = slice(yr[gy, 0], yr[gy, 1])
        hi = slice(yr[gy, 2], yr[gy, 3])
        got[:, :, gy] = (hsum[:, :, lo] * (1 - yw[lo])[:, None]).sum(2) \
            + (hsum[:, :, hi] * yw[hi][:, None]).sum(2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


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
    loss = frc.fused_resize_ce(g, lab, wt, (64, 128))
    (grad,) = torch.autograd.grad(loss, g)
    ref = frc.resize_ce_plain(g, lab, wt, (64, 128))
    (ref_grad,) = torch.autograd.grad(ref, g)
    torch.testing.assert_close(loss, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-4, atol=1e-6)
