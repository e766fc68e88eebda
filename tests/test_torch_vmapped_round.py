"""The batched-weights multi-video round against JAX's and against the
serial rounds, on the CPU.

``ams_tpu_torch.parallel.make_vmapped_multi_video_round`` trains V
students as one program: ``torch.func.vmap`` of ``torch.func.grad_and_value``
of the round's loss over the stacked weights, the rest of each iteration on
the stacked tensors.  Gates:

- (a) against JAX's ``make_vmapped_multi_video_round(with_class_mask=True)``
  (V=2, exps 25 and 12 over their union, f32, full_model, two iterations
  from warm Adam slots, ``n_valid=1`` so that both packages draw row 0):
  the bars of tests/test_torch_parallel.py::test_multi_video_round_against_jax
  (losses within 1e-5 then 5e-4; no coordinate beyond 2.05 lr per
  iteration, at most 15% beyond 1e-4; BN statistics within 0.1 of
  max(|value|, 1));
- (b) one program: one batched iteration at V=2 and V=4 makes as many
  ``aten.convolution`` and ``aten.convolution_backward`` calls as one
  single-video iteration;
- (c) coord_desc_auto at V=2: each video's threshold is ``torch.quantile``
  of its own |delta| (the selection helper, and its row-by-row path above
  ``torch.quantile``'s input limit), and the masks agree with the serial
  rounds' on more than 0.999 of the coordinates and 0.9 of each tensor's,
  the bars of tests/test_vmapped_round.py, at its 64x128 frames;
- (d) the fused loss under ``vmap``: the CPU wrapper's plain version equals
  per-video calls, and the kernel node's vmap rule launches once for all
  videos (an emulated launch), each video's loss and gradient its own;
- (e) the resize's fixed-order backward under ``vmap(grad)`` is the
  per-video gradient to the bit; (f) the stacked Adam step is V steps to
  the bit; (g) the refusals;
- the bf16 convolutions' layout: channels-last in the single round and
  under ``torch.func.grad``, the batching rule's under the batched round.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from ams_tpu import configs
from ams_tpu.distill import train_step as jts
from ams_tpu.distill.optimizer import AdamState as JAdamState
from ams_tpu.parallel import sharded as jsharded

from ams_tpu_torch import parallel as tparallel
from ams_tpu_torch.convert import (
    adam_state_from_numpy,
    masks_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.distill import train_step as tts
from ams_tpu_torch.distill.optimizer import adam_apply, adam_init
from ams_tpu_torch.models import resize
from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params
from ams_tpu_torch.ops import build
from ams_tpu_torch.ops import fused_resize_ce as frc
from ams_tpu_torch.parallel import sharded as tsharded

CAP, H, W, BATCH, LR = 3, 32, 64, 2, 1e-3
CI = (0, 1, 2, 10, 11, 13)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _videos(V, cap=CAP, h=H, w=W, seed=0):
    rng = np.random.RandomState(seed)
    params = [init_student_params(s, device="cpu") for s in range(V)]
    frames = [torch.from_numpy(rng.randint(0, 256, (cap, h, w, 3))
                               .astype(np.uint8)) for _ in range(V)]
    labels = [torch.from_numpy(rng.randint(0, 19, (cap, h, w))
                               .astype(np.uint8)) for _ in range(V)]
    return params, frames, labels


def _gens(V):
    return [torch.Generator().manual_seed(100 + j) for j in range(V)]


def _batched(fn, params, frames, labels, cap, *class_mask):
    V = len(params)
    return fn(tparallel.stack_videos(params),
              tparallel.stack_videos([adam_init(tts.split_params(p)[0])
                                      for p in params]),
              torch.stack(frames), torch.stack(labels), torch.full((V,), cap),
              _gens(V), LR,
              tparallel.stack_videos([tts.all_true_mask(p) for p in params]),
              *class_mask)


# ------------------------------------------------------ (a) against JAX


def test_batched_round_against_jax():
    """JAX's vmapped round and the port's batched round on the same params,
    class masks, warm Adam slots and buffers (``n_valid=1``)."""
    V, cap = 2, 2
    union = sorted(set(configs.class_indices(25)) |
                   set(configs.class_indices(12)))
    cm = np.array([[c in set(configs.class_indices(e)) for c in union]
                   for e in (25, 12)], np.float32)
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (V, cap, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 19, (V, cap, H, W)).astype(np.uint8)
    params = [params_to_numpy(init_student_params(s, device="cpu"))
              for s in range(V)]
    train = [k for k in params[0] if "moving_" not in k]
    warm = [(np.int32(10),
             {k: (rng.randn(*params[0][k].shape) * 1e-3).astype(np.float32)
              for k in train},
             {k: rng.uniform(1e-7, 1e-5, params[0][k].shape)
              .astype(np.float32) for k in train}) for _ in range(V)]
    spec_kw = dict(iters=2, batch_size=BATCH, num_classes=19,
                   class_indices=tuple(union), strategy="full_model",
                   coord_frac=0.1, compute_dtype="float32")
    masks = [{k: np.ones(params[0][k].shape, bool) for k in train}] * V

    jstack = jsharded.stack_videos
    jfn = jsharded.make_vmapped_multi_video_round(jts.DistillSpec(**spec_kw),
                                                  with_class_mask=True)
    t0 = time.perf_counter()
    jp, _, _, jl = jfn(
        jstack([{k: jnp.asarray(v) for k, v in p.items()} for p in params]),
        jstack([JAdamState(jnp.asarray(s), {k: jnp.asarray(x)
                                            for k, x in m.items()},
                           {k: jnp.asarray(x) for k, x in v.items()})
                for s, m, v in warm]),
        jnp.asarray(frames), jnp.asarray(labels), jnp.ones((V,), jnp.int32),
        jnp.stack([jax.random.PRNGKey(7 + j) for j in range(V)]),
        jnp.float32(LR),
        jstack([{k: jnp.asarray(v) for k, v in m.items()} for m in masks]),
        jnp.asarray(cm))
    jl = np.asarray(jl)
    print("JAX vmapped round: compile and run %.1f s"
          % (time.perf_counter() - t0))

    tfn = tparallel.make_vmapped_multi_video_round(
        tts.DistillSpec(**spec_kw), with_class_mask=True)
    tp, topt, _, tl = tfn(
        tparallel.stack_videos([params_from_numpy(p, "cpu")
                                for p in params]),
        tparallel.stack_videos([adam_state_from_numpy(*w, device="cpu")
                                for w in warm]),
        torch.from_numpy(frames), torch.from_numpy(labels), [1] * V,
        _gens(V), LR,
        tparallel.stack_videos([masks_from_numpy(m, "cpu") for m in masks]),
        torch.from_numpy(cm))
    tl = tl.numpy()
    assert tl.shape == (V, 2) and topt.step.tolist() == [12, 12]
    for j in range(V):
        assert np.all(np.abs(tl[j] - jl[j]) < [1e-5, 5e-4]), (j, tl, jl)
        total = beyond = 0
        for k in train:
            t, want = tp[k][j].numpy(), np.asarray(jp[k][j])
            d = np.abs(t - want)
            assert d.max() <= 2.05 * LR * 2, (j, k, d.max())
            beyond += int((d > 1e-4).sum())
            total += d.size
        assert beyond / total <= 0.15, (j, beyond / total)
        for k in params[0]:
            if "moving_" in k:
                t, want = tp[k][j].numpy(), np.asarray(jp[k][j])
                bound = 0.1 * np.maximum(np.abs(want), 1.0)
                assert np.all(np.abs(t - want) <= bound), k


# ------------------------------------------------------ (b) one program


class _ConvCount(TorchDispatchMode):
    """Counts the convolutions and their backwards that reach the
    kernels, below the functorch transforms."""

    def __init__(self):
        super().__init__()
        self.n = {"convolution": 0, "convolution_backward": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("V", [2, 4])
def test_one_batched_iteration_makes_one_iterations_convolutions(V):
    spec = tts.DistillSpec(iters=1, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy="full_model")
    params, frames, labels = _videos(V)
    p = params[0]
    with _ConvCount() as single:
        tts.make_distill_round(spec)(
            p, adam_init(tts.split_params(p)[0]), frames[0], labels[0], CAP,
            _gens(1)[0], LR, tts.all_true_mask(p))
    with _ConvCount() as batched:
        out = _batched(tparallel.make_vmapped_multi_video_round(spec),
                       params, frames, labels, CAP)
    assert out[3].shape == (V, 1)
    assert single.n["convolution"] > 50 and single.n[
        "convolution_backward"] > 50, single.n
    assert batched.n == single.n, (batched.n, single.n)


# ------------------------------------------- (c) coord_desc_auto selection


def test_selection_thresholds_are_each_videos_quantile():
    gen = torch.Generator().manual_seed(3)
    before = {k: torch.randn(3, *s, generator=gen)
              for k, s in (("a", (4, 5)), ("b", (7,)), ("c", (2, 3, 2)))}
    stepped = {k: v + 1e-3 * torch.randn(v.shape, generator=gen)
               for k, v in before.items()}
    mask, thr, ties = tsharded._select(stepped, before, 0.1)
    for j in range(3):
        delta = torch.cat([torch.abs(stepped[k][j] - before[k][j]).reshape(-1)
                           for k in sorted(before)])
        want = torch.quantile(delta, 0.9, interpolation="linear")
        assert torch.equal(thr[j], want)
        assert int(ties[j]) == int(torch.sum(delta == want))
        for k in before:
            assert torch.equal(
                mask[k][j], torch.abs(stepped[k][j] - before[k][j]) > want)
    # a (V, N) |delta| whose V x N entries pass torch.quantile's limit for
    # one flat input (2**24), at a small N: row by row, each row's linear
    # quantile
    n = 1025
    flat = torch.rand((1 << 24) // n + 1, n, generator=gen)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(flat, 0.9, interpolation="linear")
    got = tsharded.row_quantiles(flat, 0.9)
    want = np.quantile(flat.numpy().astype(np.float64), 0.9, axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_batched_selection_agrees_with_serial_rounds():
    """The bars of tests/test_vmapped_round.py:69-86 at its frame size
    (64x128, 4 frames): batched convolutions sum in another order, and
    the first Adam step's |delta| sits in a cluster at lr where that order
    can move a coordinate across the threshold."""
    V, cap, h, w = 2, 4, 64, 128
    spec = tts.DistillSpec(iters=2, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy="coord_desc_auto",
                           coord_frac=0.1)
    params, frames, labels = _videos(V, cap, h, w, seed=1)
    base = tts.make_distill_round(spec)
    ref = [base(p, adam_init(tts.split_params(p)[0]), f, l, cap, g, LR,
                tts.all_true_mask(p))
           for p, f, l, g in zip(params, frames, labels, _gens(V))]
    fn = tparallel.make_vmapped_multi_video_round(spec)
    out = _batched(fn, params, frames, labels, cap)
    assert fn.last_selection["threshold"].shape == (V,)
    for j, (_, _, m_s, loss_s) in enumerate(ref):
        agree = total = 0
        for k in m_s:
            a, b = out[2][k][j], m_s[k]
            agree += int((a == b).sum())
            total += a.numel()
            assert float((a == b).float().mean()) > 0.9, k
        assert agree / total > 0.999, (j, agree / total)
        np.testing.assert_allclose(out[3][j].numpy(), loss_s.numpy(),
                                   rtol=0, atol=5e-4)


# ------------------------------------------------------- (d) fused loss


def _ce_case(V, b=2, c=6, gh=5, gw=9, h=33, w=65, seed=4):
    gen = torch.Generator().manual_seed(seed)
    grid = torch.randn(V, b, c, gh, gw, generator=gen) * 3
    labels = torch.randint(0, c, (V, b, h, w), generator=gen,
                           dtype=torch.int32)
    weights = (torch.rand(V, b, h, w, generator=gen) < 0.7).float()
    return grid, labels, weights, (h, w)


def test_vmapped_fused_loss_on_the_cpu_equals_per_video_calls():
    grid, labels, weights, hw = _ce_case(3)
    n0 = (build.launch_count("resize_ce_loss"),
          build.launch_count("resize_ce_loss_grad"))

    def loss(g, lab, wt):
        return frc.fused_resize_ce(g, lab, wt, hw)

    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss))(
        grid, labels, weights)
    assert (build.launch_count("resize_ce_loss"),
            build.launch_count("resize_ce_loss_grad")) == n0
    for j in range(3):
        g = grid[j].clone().requires_grad_(True)
        want = frc.fused_resize_ce(g, labels[j], weights[j], hw)
        (want_grad,) = torch.autograd.grad(want, g)
        torch.testing.assert_close(losses[j], want.detach(), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(grads[j], want_grad, rtol=1e-6, atol=0)


def test_kernel_node_vmap_rule_launches_once_for_all_videos(monkeypatch):
    """The node's vmap rule, with the launch emulated by the plain version
    per group of images (the kernel runs only on the card): one launch
    over V x B images in V groups, each video's loss and gradient its
    own."""
    grid, labels, weights, hw = _ce_case(3)
    seen = []

    def fake_launch(g, lab, wt, out_hw, want_grad, groups=None):
        seen.append((tuple(g.shape), groups, want_grad))
        outs = []
        for gg, ll, ww in zip(*(t.chunk(groups) for t in (g, lab, wt))):
            gg = gg.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = frc.resize_ce_plain(gg, ll, ww, out_hw)
                (grad,) = torch.autograd.grad(loss, gg)
            total = torch.clamp(torch.sum(ww), min=1.0)
            outs.append((loss.detach(), total, grad * total))
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                torch.cat([o[2] for o in outs]))

    monkeypatch.setattr(frc, "_launch", fake_launch)

    def loss(g, lab, wt):
        return frc._ResizeCE.apply(g, lab, wt, hw)[0] * 3.0

    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss))(
        grid, labels, weights)
    assert seen == [((6, 6, 5, 9), 3, True)]    # one launch, V groups
    for j in range(3):
        g = grid[j].clone().requires_grad_(True)
        want = frc.resize_ce_plain(g, labels[j], weights[j], hw) * 3.0
        (want_grad,) = torch.autograd.grad(want, g)
        torch.testing.assert_close(losses[j], want.detach(), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(grads[j], want_grad, rtol=1e-5,
                                   atol=1e-7)


def test_batched_round_with_the_fused_loss_tracks_serial_rounds():
    V = 2
    spec = tts.DistillSpec(iters=2, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy="full_model",
                           fused_loss=True)
    params, frames, labels = _videos(V, seed=2)
    base = tts.make_distill_round(spec)
    ref = [base(p, adam_init(tts.split_params(p)[0]), f, l, CAP, g, LR,
                tts.all_true_mask(p))
           for p, f, l, g in zip(params, frames, labels, _gens(V))]
    out = _batched(tparallel.make_vmapped_multi_video_round(spec), params,
                   frames, labels, CAP)
    # iteration 0 is the same forward and loss; the later iterations are
    # held by test_batched_round_against_jax's gates
    for j in range(V):
        assert out[3][j].shape == (2,) and torch.isfinite(out[3][j]).all()
        assert abs(float(out[3][j][0] - ref[j][3][0])) < 1e-5


# --------------------------------------- (e) resize, (f) Adam, (g) refusals


def test_banded_select_backward_under_vmap_is_per_video_bitwise():
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(3, 2, 4, 5, 7, generator=gen)
    cot = torch.randn(3, 2, 4, 17, 33, generator=gen)

    def f(t, c):
        return torch.sum(resize.resize_nchw(t, (17, 33)) * c)

    got = torch.func.vmap(torch.func.grad(f))(x, cot)
    for j in range(3):
        t = x[j].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(f(t, cot[j]), t)
        assert torch.equal(got[j], want)


def test_stacked_adam_step_is_per_video_steps_bitwise():
    gen = torch.Generator().manual_seed(9)
    shapes = {"w": (3, 3, 4, 8), "b": (8,)}
    V = 3
    params = [{k: torch.randn(s, generator=gen) for k, s in shapes.items()}
              for _ in range(V)]
    grads = [{k: torch.randn(s, generator=gen) * 1e-2
              for k, s in shapes.items()} for _ in range(V)]
    states = []
    for j in range(V):
        st = adam_init(params[j])
        for _ in range(j):      # a different step count per video
            _, st = adam_apply(params[j], grads[j], st, LR)
        states.append(st)
    got_p, got_s = adam_apply(tparallel.stack_videos(params),
                              tparallel.stack_videos(grads),
                              tparallel.stack_videos(states), LR)
    assert got_s.step.tolist() == [1, 2, 3]
    for j in range(V):
        want_p, want_s = adam_apply(params[j], grads[j], states[j], LR)
        for k in shapes:
            assert torch.equal(got_p[k][j], want_p[k])
            assert torch.equal(got_s.m[k][j], want_s.m[k])
            assert torch.equal(got_s.v[k][j], want_s.v[k])


def test_batched_round_refuses_partitioned_specs_and_mixed_video_counts():
    spec = tts.DistillSpec(iters=1, batch_size=BATCH, num_classes=19,
                           class_indices=CI)
    for kw in ({"width_axis": "model"}, {"batch_axis": "data"}):
        with pytest.raises(ValueError, match="one device"):
            tparallel.make_vmapped_multi_video_round(
                dataclasses.replace(spec, **kw))
    params, frames, labels = _videos(2)
    fn = tparallel.make_vmapped_multi_video_round(spec)
    args = [tparallel.stack_videos(params),
            tparallel.stack_videos([adam_init(tts.split_params(p)[0])
                                    for p in params]),
            torch.stack(frames), torch.stack(labels), [CAP] * 2, _gens(2), LR,
            tparallel.stack_videos([tts.all_true_mask(p) for p in params])]
    for i, bad in ((2, torch.stack(frames * 2)), (4, [CAP] * 3),
                   (5, _gens(3))):
        with pytest.raises(ValueError, match="video counts"):
            fn(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="with_class_mask"):
        fn(*args, torch.ones(2, len(CI)))
    with pytest.raises(ValueError, match="one shape"):
        fn(*args[:2], [frames[0], frames[1][:, :-1]], *args[3:])


# ------------------------------------ the bf16 convolutions' memory layout


@pytest.mark.parametrize("form", ["round", "func_grad", "batched"])
def test_bf16_convolutions_are_channels_last_outside_the_batched_round(form):
    """The single bf16 round, and its loss under ``torch.func.grad``, feed
    channels-last activations to the convolutions; only the batched
    round's ``vmap`` (``layers.video_batched``) leaves the layout to the
    batching rule, whose inputs carry the video axis."""
    spec = tts.DistillSpec(iters=1, batch_size=BATCH, num_classes=19,
                           class_indices=CI, strategy="full_model",
                           compute_dtype="bfloat16")
    params, frames, labels = _videos(2)
    p = params[0]
    seen = {"convolution": 0, "channels_last": 0}

    class Layouts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "convolution":
                x = args[0]
                seen["convolution"] += 1
                seen["channels_last"] += int(
                    x.dim() == 4 and not x.is_contiguous()
                    and x.is_contiguous(memory_format=torch.channels_last))
            return func(*args, **(kwargs or {}))

    with Layouts():
        if form == "round":
            tts.make_distill_round(spec)(
                p, adam_init(tts.split_params(p)[0]), frames[0], labels[0],
                CAP, _gens(1)[0], LR, tts.all_true_mask(p))
        elif form == "func_grad":
            # the frames too, so that the first activation is already a
            # transform's tensor
            p_t, bn = tts.split_params(p)
            torch.func.grad_and_value(
                lambda pt, f: tts._round_loss(
                    spec, pt, bn, f, labels[0][:BATCH], None, spec.cdtype),
                argnums=(0, 1), has_aux=True)(
                    p_t, frames[0][:BATCH].float())
        else:
            _batched(tparallel.make_vmapped_multi_video_round(spec),
                     params, frames, labels, CAP)
    assert seen["convolution"] > 50, seen
    if form == "batched":
        assert seen["channels_last"] == 0, seen
    else:
        assert seen["channels_last"] >= seen["convolution"] - 3, seen


def test_bf16_conv_layout_is_left_to_the_batching_rule_only_when_batched():
    """An NCHW activation goes channels-last into a bf16 convolution under
    ``torch.func.grad`` as outside it; only inside ``video_batched()``,
    under the batched round's ``vmap``, is the layout the rule's."""
    from ams_tpu_torch.models import layers

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 2, 8, 6, 5, generator=gen)     # (V, B, C, H, W)
    w = torch.randn(3, 3, 8, 4, generator=gen)
    seen = []

    class Layouts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "convolution":
                a = args[0]
                seen.append(not a.is_contiguous() and a.is_contiguous(
                    memory_format=torch.channels_last))
            return func(*args, **(kwargs or {}))

    def loss(xv):
        return layers.conv2d(xv, w, compute_dtype="bfloat16").float().sum()

    with Layouts():
        loss(x[0])
        torch.func.grad(loss)(x[0])
        with layers.video_batched():
            torch.func.vmap(torch.func.grad(loss))(x)
    assert seen == [True, True, False], seen
