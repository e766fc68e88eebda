"""The port's distillation round against the reference's TF-executed round.

The same gates and tolerances as tests/test_parity_round.py (whose
docstring gives the fixture, the comparison protocol and the measured
headroom), with the port's round (``ams_tpu_torch.distill.train_step``)
in place of ams_tpu's.  The fixture's batch sequences replay through
``idx_seq``; the round runs eagerly on the CPU.
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
                       "round_parity_h64.npz")

# per-iteration loss tolerance: floor noise ~1e-6 amplified ~10-30x per
# iteration by the BN-coupled chaos (see fixture docstring)
LOSS_ATOL = [1e-5, 1e-4, 5e-4, 2e-3]


@pytest.fixture(scope="module")
def fx():
    if not os.path.exists(FIXTURE):
        pytest.skip("round fixture missing (run tools/make_round_fixture.py)")
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


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
                       compute_dtype="float32")


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
    """Frozen-params slot warmup (all-False mask): Adam slots and beta
    powers advance 4 steps while params stay bitwise frozen — the shared
    prefix of every recorded run.  The loss trace itself is a tight gate
    (every warmup forward runs at the identical initial point)."""
    zero = {k: torch.zeros_like(v) for k, v in
            all_true_mask(setup["params"]).items()}
    out, opt_state, _m, losses = _run(setup, _spec(setup, "full_model"),
                                      mask=zero, idx=fx["idx_seq"])
    # params bitwise untouched by a fully-masked round
    for k, v in setup["init"].items():
        if "moving_" not in k and k in out:
            assert np.array_equal(np.asarray(out[k]), v), k
    np.testing.assert_allclose(np.asarray(losses), fx["warm_losses"],
                               rtol=0, atol=1e-5)
    return dict(opt_state=opt_state)


def _losses_close(ours, ref):
    ours = np.asarray(ours)
    for i in range(len(ref)):
        assert abs(float(ours[i]) - float(ref[i])) < LOSS_ATOL[i], (
            i, ours, ref)


def _gate_one_iter(out, ref, init, *, lr, knife_frac, label):
    """1-iteration-horizon per-coordinate gate: BN moving stats strict,
    weight bulk strict, a bounded knife-edge tail (coords whose gradient
    sits at the float noise floor take ±lr-bounded noise steps — an
    intrinsic cross-implementation limit, not a semantics error)."""
    tot = bad = 0
    for k, rv in ref.items():
        d = np.abs(np.asarray(out[k]) - rv)
        if "moving_" in k:
            assert d.max() < 1e-4, (label, k, d.max())
            continue
        tot += d.size
        bad += int((d > 1e-4).sum())
        assert d.max() <= 2.05 * lr, (label, k, d.max())
    frac = bad / tot
    assert frac < knife_frac, (label, frac)
    print("%s: %d/%d coords beyond 1e-4 (%.4f%%)"
          % (label, bad, tot, 100 * frac))


def test_trainable_set_matches_entire_model_vars(fx, setup):
    """Our trainable split == the reference's entire_model_vars (the
    grad_masks_pl keys, graph_utils.py:424-425 sans patch/cache)."""
    emv = set(_group(fx, "auto_mask:"))
    train, state = split_params(setup["params"])
    assert set(train) == emv
    # everything else we track is BN moving statistics
    assert all("moving_" in k for k in state)


def test_cold_first_iteration(fx, setup):
    """One cold Adam step (t=1, zero slots) against the reference `train`
    op: loss, BN moving updates, and the t=1 bias-correction factors."""
    out, _opt, _m, losses = _run(setup, _spec(setup, "full_model", iters=1),
                                 idx=fx["idx_seq"][:1])
    np.testing.assert_allclose(np.asarray(losses), fx["cold1_losses"],
                               rtol=0, atol=1e-5)
    _gate_one_iter(out, _group(fx, "cold1_final:"), setup["init"],
                   lr=float(fx["lr"]), knife_frac=0.02, label="cold1")


def test_full_model_round_matches_tf(fx, setup, warm):
    """Warm full-model round: first-iteration params strictly, the whole
    trajectory through the loss trace."""
    out1, _o, _m, l1 = _run(setup, _spec(setup, "full_model", iters=1),
                            opt_state=warm["opt_state"],
                            idx=fx["idx_seq2"][:1])
    assert abs(float(np.asarray(l1)[0]) - float(fx["full_losses"][0])) \
        < 1e-5
    _gate_one_iter(out1, _group(fx, "full_it1:"), setup["init"],
                   lr=float(fx["lr"]), knife_frac=1e-3, label="full_it1")

    _out, _o, _m, losses = _run(setup, _spec(setup, "full_model"),
                                opt_state=warm["opt_state"],
                                idx=fx["idx_seq2"])
    _losses_close(losses, fx["full_losses"])


def test_fixed_mask_round_matches_tf(fx, setup, warm):
    """train_coord with a fixed Bernoulli mask from warm slots: masked
    params frozen bitwise at EVERY horizon, selected params tracked."""
    mask = masks_from_numpy(_group(fx, "fixed_mask:"), "cpu")
    init = setup["init"]

    out1, _o, _m, _l = _run(setup, _spec(setup, "full_model", iters=1),
                            opt_state=warm["opt_state"], mask=mask,
                            idx=fx["idx_seq2"][:1])
    _gate_one_iter(out1, _group(fx, "fixed_it1:"), init,
                   lr=float(fx["lr"]), knife_frac=1e-3, label="fixed_it1")

    out, _o, _m, losses = _run(setup, _spec(setup, "full_model"),
                               opt_state=warm["opt_state"], mask=mask,
                               idx=fx["idx_seq2"])
    _losses_close(losses, fx["fixed_losses"])
    # the exact invariant, chaos-proof at any horizon: masked-out
    # coordinates equal the initial values BITWISE (the reference assigns
    # the backup back; the round torch.where-s the old value in)
    for k, m in _group(fx, "fixed_mask:").items():
        assert np.array_equal(np.asarray(out[k])[~m], init[k][~m]), k
        assert np.array_equal(np.asarray(out1[k])[~m], init[k][~m]), k


def test_coord_desc_auto_round_matches_tf(fx, setup, warm):
    """Warm coord_desc_auto: selection-mask equality off quantile ties,
    the post-selection restore composition per-coordinate, the remaining
    trajectory through losses."""
    cut = float(fx["auto_cut"])
    # iters=1 stops right after the peeled probe step + where-revert
    # restore == the reference state after SemanticNetwork.py:288
    out1, _o, mask, _l = _run(setup, _spec(setup, "coord_desc_auto",
                                           iters=1),
                              opt_state=warm["opt_state"],
                              idx=fx["idx_seq2"][:1], reselect=True)

    ref_mask = _group(fx, "auto_mask:")
    margin = _group(fx, "auto_margin:")   # |delta_tf| - cut per coordinate
    total = agreed = 0
    agree = {}
    for k, rm in ref_mask.items():
        om = np.asarray(mask[k])
        eq = om == rm
        agree[k] = eq
        total += rm.size
        agreed += int(eq.sum())
        flips = ~eq
        # every disagreement must sit AT the threshold (a float tie):
        # within one cut-width of the cut, never a well-separated |delta|
        bad = flips & (np.abs(margin[k]) > cut)
        assert not bad.any(), (
            f"{k}: {int(bad.sum())} mask flips with margin up to "
            f"{np.abs(margin[k][flips]).max():.2e} (cut {cut:.2e})")
    assert agreed / total > 0.995, (total - agreed, total)
    print(f"auto mask: {agreed}/{total} agree "
          f"({100 * (total - agreed) / total:.4f}% tie flips)")

    # post-selection params: strict wherever the masks agree
    ps = _group(fx, "auto_postsel:")
    for k, rv in ps.items():
        d = np.abs(np.asarray(out1[k]) - rv)
        if "moving_" in k:
            assert d.max() < 1e-4, (k, d.max())
            continue
        sel = d[agree[k]] if k in agree else d
        assert sel.size == 0 or sel.max() < 5e-4, (k, float(sel.max()))

    _out, _o, _m, losses = _run(setup, _spec(setup, "coord_desc_auto"),
                                opt_state=warm["opt_state"],
                                idx=fx["idx_seq2"], reselect=True)
    _losses_close(losses, fx["auto_losses"])