"""The port's pinned-BN round against the reference's TF-executed round,
per coordinate through 12 iterations.

The same gates and tolerances as tests/test_parity_round_pinned.py (whose
docstring gives the fixture, the pinning and the measured drift), with
the port's round (``ams_tpu_torch.distill.train_step``,
``DistillSpec(bn_train=False)``) in place of ams_tpu's.  The fixture's
batch sequences replay through ``idx_seq``; the round runs eagerly on the
CPU.

One gate differs, at the one-iteration horizon: the share of coordinates
beyond 1e-5 may be 1e-3 (ams_tpu's: 1e-4) and the cap is 5e-4, half an lr
(ams_tpu's: 1e-4).  The port's CPU convolutions (oneDNN) sum in another
order than TF's and XLA's, which agree with each other to the last bits
here; coordinates whose Adam step sits on a knife edge (a tiny gradient
under warm slots) then move by a fraction of lr.  Measured for the port:
2.4e-4 of the coordinates beyond 1e-5, spread over the middle blocks'
weights, max 1.5e-4, while the bulk stays machine-exact (q90 7.5e-9) and
the loss agrees to 2e-6.
"""

import os

import numpy as np
import pytest

import torch

from ams_tpu_torch.convert import masks_from_numpy
from ams_tpu_torch.distill.optimizer import adam_init
from ams_tpu_torch.distill.train_step import (
    DistillSpec,
    all_true_mask,
    make_distill_round,
    split_params,
)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "round_parity_pinned_h64.npz")

# Per-horizon distribution gates (measured values in the module
# docstring; tolerances carry 3-8x margin for host/arch rounding
# variation).  Keyed by iteration count: (bulk_atol, tail_frac, q90_max,
# cap_abs, loss_atol).
HORIZON_GATES = {
    1:  (1e-5, 1e-3, 1e-7, 5e-4, 2e-6),
    6:  (1e-4, 5e-2, 2e-4, 5e-3, 3e-4),
    12: (1e-3, 5e-2, 2e-3, 2e-2, 5e-4),
}


@pytest.fixture(scope="module")
def fx():
    if not os.path.exists(FIXTURE):
        pytest.skip("pinned round fixture missing "
                    "(run tools/make_round_fixture.py --bn_pin)")
    with np.load(FIXTURE) as z:
        out = {k: z[k] for k in z.files}
    assert bool(out["bn_pin"]), "fixture was not generated with --bn_pin"
    assert int(out["iters"]) == 12, \
        "HORIZON_GATES tolerances are anchored to the 12-iteration fixture"
    return out


def _group(fx, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in fx.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def setup(fx):
    init = _group(fx, "init:")
    params = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    return dict(params=params, init=init,
                frames_buf=torch.from_numpy(fx["pool_frames"]),
                labels_buf=torch.from_numpy(fx["pool_labels"]),
                n_valid=int(fx["pool_frames"].shape[0]),
                lr=float(fx["lr"]),
                iters=int(fx["iters"]), coord_frac=float(fx["coord_frac"]),
                rng=None)


def _spec(setup, strategy, iters=None):
    return DistillSpec(iters=setup["iters"] if iters is None else iters,
                       batch_size=6, strategy=strategy,
                       coord_frac=setup["coord_frac"],
                       compute_dtype="float32", bn_train=False)


def _run(setup, spec, *, opt_state=None, mask=None, idx, reselect=True):
    round_fn = make_distill_round(spec)
    params = setup["params"]
    if opt_state is None:
        train, _ = split_params(params)
        opt_state = adam_init(train)
    if mask is None:
        mask = all_true_mask(params)
    return round_fn(params, opt_state, setup["frames_buf"],
                    setup["labels_buf"], setup["n_valid"], setup["rng"],
                    setup["lr"], mask, reselect=reselect,
                    idx_seq=np.asarray(idx))


@pytest.fixture(scope="module")
def warm(fx, setup):
    """Frozen-params slot warmup: params AND BN stats bitwise frozen
    (pinned mode never advances the moving averages), slots advance."""
    zero = {k: torch.zeros_like(v) for k, v in
            all_true_mask(setup["params"]).items()}
    out, opt_state, _m, losses = _run(setup, _spec(setup, "full_model"),
                                      mask=zero, idx=fx["idx_seq"])
    for k, v in setup["init"].items():
        assert np.array_equal(np.asarray(out[k]), v), k  # incl. moving_*
    np.testing.assert_allclose(np.asarray(losses), fx["warm_losses"],
                               rtol=0, atol=1e-5)
    return dict(opt_state=opt_state)


def _gate_coords(out, ref, *, horizon, label, sel=None):
    """Per-horizon distribution gate (see HORIZON_GATES): bulk fraction,
    q90, absolute cap — plus the absolute invariant that pinned moving
    statistics never move."""
    bulk_atol, tail_frac, q90_max, cap_abs, _ = HORIZON_GATES[horizon]
    ds = []
    for k, rv in ref.items():
        d = np.abs(np.asarray(out[k], np.float64) - rv)
        if "moving_" in k:
            assert d.max() == 0.0, (label, k, d.max())  # frozen bitwise
            continue
        if sel is not None and k in sel:
            d = d[sel[k]]
        ds.append(d.ravel())
    d = np.concatenate(ds)
    frac = float((d > bulk_atol).mean())
    q90 = float(np.percentile(d, 90))
    worst = float(d.max())
    print("%s: frac>%g %.6f (<=%g), q90 %.2e (<=%g), max %.2e (<=%g)"
          % (label, bulk_atol, frac, tail_frac, q90, q90_max, worst,
             cap_abs))
    assert frac <= tail_frac, (label, frac)
    assert q90 <= q90_max, (label, q90)
    assert worst <= cap_abs, (label, worst)


def _gate_losses(ours, ref, label, horizon):
    atol = HORIZON_GATES[horizon][4]
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    d = np.abs(ours - ref)
    print("%s losses: max diff %.3e (<=%g)" % (label, d.max(), atol))
    assert d.max() < atol, (label, ours, ref)


def test_full_model_long_horizon(fx, setup, warm):
    """train_coord(all-ones) ≡ train over the full 12-iteration horizon:
    per-coordinate params at it1 / mid / final, Adam slots at final,
    per-iteration losses at flat (non-chaos-widened) tolerances."""
    iters = setup["iters"]
    mid = iters // 2

    for h, key in ((1, "full_it1:"), (mid, "full_it%d:" % mid),
                   (iters, "full_final:")):
        out, opt, _m, losses = _run(setup, _spec(setup, "full_model",
                                                 iters=h),
                                    opt_state=warm["opt_state"],
                                    idx=fx["idx_seq2"][:h])
        _gate_coords(out, _group(fx, key), horizon=h, label="full_it%d" % h)
        _gate_losses(losses, fx["full_losses"][:h], "full[:%d]" % h,
                     horizon=h)

    # Adam slots at the final horizon: opt.m / opt.v vs the recorded
    # <var>/Adam(_1) slot variables; beta powers derive from opt.step
    # (TF keeps beta1_power = beta1^t as explicit variables).  m is a
    # gradient EMA so it carries the same bounded drift as the params
    # (measured q99.9 2.3e-5, max 4.8e-4); v is a squared-gradient EMA at
    # ~1e-6 scale and is near-exact (measured max 1.0e-7).
    slots = _group(fx, "full_slot:")
    step = int(np.asarray(opt.step))
    dm, dv = [], []
    for name, rv in slots.items():
        if name.endswith("/Adam"):
            dm.append(np.abs(np.asarray(opt.m[name[:-5]], np.float64)
                             - rv).ravel())
        elif name.endswith("/Adam_1"):
            dv.append(np.abs(np.asarray(opt.v[name[:-7]], np.float64)
                             - rv).ravel())
        else:  # beta1_power / beta2_power scalars: TF initializes the
            # variable to beta and multiplies AFTER each apply, so after
            # `step` applies it stores beta^(step+1)
            # tolerance: TF accumulates the power by repeated f32
            # multiplication (eps/2 per multiply, 25 multiplies)
            beta = 0.9 if "beta1" in name else 0.999
            assert abs(beta ** (step + 1) - float(rv)) < 5e-6, \
                (name, step, rv)
    dm, dv = np.concatenate(dm), np.concatenate(dv)
    print("slots m: frac>1e-4 %.6f, max %.2e; v: max %.2e"
          % ((dm > 1e-4).mean(), dm.max(), dv.max()))
    assert (dm > 1e-4).mean() <= 0.02, (dm > 1e-4).mean()
    assert dm.max() <= 5e-3, dm.max()
    assert dv.max() <= 1e-5, dv.max()


def test_fixed_mask_long_horizon(fx, setup, warm):
    """Fixed Bernoulli mask over 12 iterations: masked-out coordinates
    bitwise-frozen, selected coordinates tracked per-coordinate."""
    mask_np = _group(fx, "fixed_mask:")
    mask = masks_from_numpy(mask_np, "cpu")
    out, _o, _m, losses = _run(setup, _spec(setup, "full_model"),
                               opt_state=warm["opt_state"], mask=mask,
                               idx=fx["idx_seq2"])
    _gate_losses(losses, fx["fixed_losses"], "fixed", horizon=setup["iters"])
    init = setup["init"]
    for k, m in mask_np.items():
        assert np.array_equal(np.asarray(out[k])[~m], init[k][~m]), k
    _gate_coords(out, _group(fx, "fixed_final:"), horizon=setup["iters"],
                 label="fixed_final", sel=mask_np)


def test_coord_desc_auto_long_horizon(fx, setup, warm):
    """coord_desc_auto: selection mask near-exact (ties only), then the
    masked trajectory per-coordinate through the final iteration."""
    cut = float(fx["auto_cut"])
    out1, _o, mask, _l = _run(setup, _spec(setup, "coord_desc_auto",
                                           iters=1),
                              opt_state=warm["opt_state"],
                              idx=fx["idx_seq2"][:1], reselect=True)
    ref_mask = _group(fx, "auto_mask:")
    margin = _group(fx, "auto_margin:")
    total = agreed = 0
    agree = {}
    for k, rm in ref_mask.items():
        om = np.asarray(mask[k])
        eq = om == rm
        agree[k] = eq
        total += rm.size
        agreed += int(eq.sum())
        flips = ~eq
        bad = flips & (np.abs(margin[k]) > 0.05 * cut)
        assert not bad.any(), (
            f"{k}: {int(bad.sum())} mask flips with margin up to "
            f"{np.abs(margin[k][flips]).max():.2e} (cut {cut:.2e})")
    assert agreed / total > 0.9995, (total - agreed, total)
    print(f"auto mask (pinned): {agreed}/{total} agree "
          f"({100 * (total - agreed) / total:.5f}% tie flips)")

    _gate_coords(out1, _group(fx, "auto_postsel:"), horizon=1,
                 label="auto_postsel", sel=agree)

    out, _o, _m, losses = _run(setup, _spec(setup, "coord_desc_auto"),
                               opt_state=warm["opt_state"],
                               idx=fx["idx_seq2"], reselect=True)
    _gate_losses(losses, fx["auto_losses"], "auto", horizon=setup["iters"])
    _gate_coords(out, _group(fx, "auto_final:"), horizon=setup["iters"],
                 label="auto_final", sel=agree)
