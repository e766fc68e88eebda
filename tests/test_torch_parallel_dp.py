"""The port's minibatch-parallel round over torch.distributed, on the CPU.

The counterpart of tests/test_sharded_round.py.  This file runs itself as
rank processes (``python tests/test_torch_parallel_dp.py --rank R --world
N --port P --out F``): gloo on a free localhost port, one thread each, a
timeout per process, results written to ``.npz``.  Every rank and the
single-device port round get the same seeded student, 64x128 uint8 frames
and labels and the same ``idx_seq`` (global batch 4, so 2 rows per rank
at world size 2).  Gates, those of tests/test_sharded_round.py:
- full_model, one iteration: loss rtol 1e-5; BN moving statistics rtol
  1e-4 / atol 1e-6; weights within one Adam step of each other;
- coord_desc_auto, two iterations, and the same with the fused loss (K2's
  plain version on the CPU): the first loss rtol 1e-5, the losses rtol
  1e-3, the selection masks agree on more than 0.999 of coordinates;
- against JAX's ``make_sharded_distill_round`` on a two-entry virtual CPU
  mesh (``model_parallelism=1``: the port refuses width partitioning), on
  the same params, warm Adam slots, buffers and ``idx_seq``: coord_desc_auto,
  one iteration (the peeled selection step alone, one JAX compile), with
  the gates of the full_model case above and mask agreement > 0.999;
- the two ranks' outputs are equal to the bit;
- at world size 1 the sharded round is the single-device round to the bit
  (both run in the one rank process, at one thread);
- the reducer's default (None) leaves BN's moments and the masked mean
  as they were, to the bit; a global batch that does not divide over the
  ranks raises, and so does ``batch_axis`` without a process group.
"""

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ams_tpu_torch.convert import (  # noqa: E402
    adam_state_from_numpy,
    params_to_numpy,
)
from ams_tpu_torch.distill import loss as tloss  # noqa: E402
from ams_tpu_torch.distill.optimizer import adam_init  # noqa: E402
from ams_tpu_torch.distill.train_step import (  # noqa: E402
    DistillSpec,
    all_true_mask,
    make_distill_round,
    split_params,
)
from ams_tpu_torch.models import layers  # noqa: E402
from ams_tpu_torch.models.mobilenetv2_deeplab import (  # noqa: E402
    init_student_params,
)

CAP, H, W, BATCH, LR = 6, 64, 128, 4, 1e-3
CI = (0, 1, 2, 10, 11, 13)
CASES = {"full_model": dict(strategy="full_model", iters=1),
         "coord_desc_auto": dict(strategy="coord_desc_auto", iters=2),
         "fused": dict(strategy="coord_desc_auto", iters=2,
                       fused_loss=True),
         "jax": dict(strategy="coord_desc_auto", iters=1)}
WARM = {"jax"}      # cases that start from warm_slots(), not adam_init
RANK_TIMEOUT_S = 240


def _spec(case, batch=BATCH):
    return DistillSpec(batch_size=batch, num_classes=19, class_indices=CI,
                       coord_frac=0.1, compute_dtype="float32",
                       **CASES[case])


def _data():
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (CAP, H, W, 3)).astype(np.uint8)
    labels = rng.randint(0, 19, (CAP, H, W)).astype(np.uint8)
    idx = rng.randint(0, CAP, (2, BATCH))
    return frames, labels, idx


def warm_slots(params):
    """Adam step 10 with seeded slots for the trainable keys of a numpy
    student: coord_desc_auto's selection then ranks steps of differing
    sizes, not the tie cluster of a first step from zero slots."""
    rng = np.random.RandomState(1)
    train = sorted(k for k in params if "moving_" not in k)
    return (np.int32(10),
            {k: (rng.randn(*params[k].shape) * 1e-3).astype(np.float32)
             for k in train},
            {k: rng.uniform(1e-7, 1e-5, params[k].shape).astype(np.float32)
             for k in train})


def _run(case, round_fn):
    """One round from the seeded student -> {name: numpy array}."""
    frames, labels, idx = _data()
    params = init_student_params(0, device="cpu")
    opt = (adam_state_from_numpy(*warm_slots(params_to_numpy(params)),
                                 device="cpu")
           if case in WARM else adam_init(split_params(params)[0]))
    p, _, m, losses = round_fn(
        params, opt,
        torch.from_numpy(frames), torch.from_numpy(labels), CAP, None, LR,
        all_true_mask(params), idx_seq=idx[:CASES[case]["iters"]])
    out = {"losses": losses.numpy()}
    out.update({"param:" + k: v.numpy() for k, v in p.items()})
    out.update({"mask:" + k: v.numpy() for k, v in m.items()})
    return out


def _rank_main(argv):
    """A rank process: every case through the sharded round (and at
    world size 1 through the plain round too) -> one .npz."""
    from ams_tpu_torch.parallel import init_multi_host, \
        make_sharded_distill_round
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    world = init_multi_host("localhost:%d" % a.port, a.world, a.rank,
                            backend="gloo")
    assert world == a.world, (world, a.world)
    res = {}
    try:
        for case in CASES:
            fn = make_sharded_distill_round(_spec(case))
            res.update({case + "/" + k: v
                        for k, v in _run(case, fn).items()})
            if a.world == 1:
                res.update({"plain/" + case + "/" + k: v for k, v in
                            _run(case, make_distill_round(
                                _spec(case))).items()})
        try:
            make_sharded_distill_round(_spec("full_model",
                                             batch=2 * a.world + 1))
            res["odd_batch_raises"] = np.bool_(False)
        except ValueError:
            res["odd_batch_raises"] = np.bool_(True)
    finally:
        dist.destroy_process_group()
    np.savez(a.out, **res)
    return 0


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world, tmp):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [os.path.join(tmp, "w%d_r%d.npz" % (world, r))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--port", str(port), "--out", outs[r]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, outs


def _collect(procs, outs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = []
    for path in outs:
        with np.load(path) as z:
            results.append({k: z[k] for k in z.files})
    return results


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's results]}; both worlds run at once."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    launched = {w: _launch(w, tmp) for w in (2, 1)}
    return {w: _collect(*launched[w]) for w in launched}


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(2)
    return {case: _run(case, make_distill_round(_spec(case)))
            for case in CASES}


def _case(res, case):
    return {k[len(case) + 1:]: v for k, v in res.items()
            if k.startswith(case + "/")}


def test_full_model_matches_single_device(ranks, single):
    got, want = _case(ranks[2][0], "full_model"), single["full_model"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in ("MobilenetV2/Conv/BatchNorm/moving_mean",
              "concat_projection/BatchNorm/moving_variance"):
        np.testing.assert_allclose(got["param:" + k], want["param:" + k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    d = np.abs(got["param:logits/semantic/weights"]
               - want["param:logits/semantic/weights"])
    assert float(d.max()) <= 2 * LR * 3.2 + 1e-6


@pytest.mark.parametrize("case", ["coord_desc_auto", "fused"])
def test_coord_desc_selection_agrees(ranks, single, case):
    got, want = _case(ranks[2][0], case), single[case]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    keys = [k for k in want if k.startswith("mask:")]
    total = sum(want[k].size for k in keys)
    agree = sum(int((got[k] == want[k]).sum()) for k in keys)
    assert agree / total > 0.999, agree / total


def test_two_ranks_match_jax_sharded_round(ranks):
    """JAX's round on a two-entry virtual CPU mesh, its minibatch split
    over ``data``, and the port's two gloo ranks, from the same params,
    warm Adam slots, buffers and ``idx_seq``."""
    import jax
    import jax.numpy as jnp
    from ams_tpu.distill import train_step as jts
    from ams_tpu.distill.optimizer import AdamState as JAdamState
    from ams_tpu.parallel.mesh import make_mesh
    from ams_tpu.parallel.sharded import make_sharded_distill_round as jround

    frames, labels, idx = _data()
    params = params_to_numpy(init_student_params(0, device="cpu"))
    step, m, v = warm_slots(params)
    jparams = {k: jnp.asarray(x) for k, x in params.items()}
    mesh = make_mesh(2, model_parallelism=1)
    fn = jround(jts.DistillSpec(batch_size=BATCH, num_classes=19,
                                class_indices=CI, coord_frac=0.1,
                                compute_dtype="float32", **CASES["jax"]),
                mesh)
    t0 = time.perf_counter()
    with mesh:
        jp, _, jm, jl = fn(
            jparams, JAdamState(jnp.int32(step),
                                {k: jnp.asarray(x) for k, x in m.items()},
                                {k: jnp.asarray(x) for k, x in v.items()}),
            jnp.asarray(frames), jnp.asarray(labels), jnp.int32(CAP),
            jax.random.PRNGKey(0), jnp.float32(LR),
            jts.all_true_mask(jparams),
            idx_seq=jnp.asarray(idx[:CASES["jax"]["iters"]], jnp.int32))
        jl = np.asarray(jl)
    print("JAX sharded round: compile and run %.1f s"
          % (time.perf_counter() - t0))
    got = _case(ranks[2][0], "jax")
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    for k in ("MobilenetV2/Conv/BatchNorm/moving_mean",
              "concat_projection/BatchNorm/moving_variance"):
        np.testing.assert_allclose(got["param:" + k], np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    d = max(float(np.abs(got["param:" + k] - np.asarray(jp[k])).max())
            for k in m)
    assert d <= 2.05 * LR, d
    total = sum(x.size for x in m.values())
    agree = sum(int((got["mask:" + k] == np.asarray(jm[k])).sum()) for k in m)
    assert agree / total > 0.999, agree / total


def test_ranks_hold_the_same_bits(ranks):
    r0, r1 = ranks[2]
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_world_size_one_is_the_single_device_round(ranks, case):
    res = ranks[1][0]
    got, want = _case(res, case), _case(res, "plain/" + case)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_must_divide_over_the_ranks(ranks):
    assert bool(ranks[2][0]["odd_batch_raises"])
    assert bool(ranks[1][0]["odd_batch_raises"]) is False  # 3 over 1 rank


def test_batch_axis_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        make_distill_round(DistillSpec(batch_axis="data"))


def _batch_norm_train_before(x, gamma, beta, eps=layers.BN_EPS):
    """batch_norm_train as it was before the reducer argument."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp(torch.square(xf).mean(dim=(0, 2, 3))
                      - torch.square(mean), min=0.0)
    inv = torch.rsqrt(var + eps) * gamma
    y = (xf - mean[:, None, None]) * inv[:, None, None] + beta[:, None, None]
    return y.to(x.dtype), mean, var


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_reducer_leaves_the_reductions_bitwise(dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 8, 5, 7, generator=gen) * 3 + 1).to(dtype)
    gamma = torch.rand(8, generator=gen) + 0.5
    beta = torch.randn(8, generator=gen)
    for got, want in zip(layers.batch_norm_train(x, gamma, beta),
                         _batch_norm_train_before(x, gamma, beta)):
        assert torch.equal(got, want)
    v = torch.randn(4, 9, generator=gen)
    mask = torch.rand(4, 9, generator=gen) > 0.3
    m = mask.float()
    assert torch.equal(tloss.masked_mean(v, mask),
                       torch.sum(v * m) / torch.clamp(torch.sum(m), min=1.0))


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
