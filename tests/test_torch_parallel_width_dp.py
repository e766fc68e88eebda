"""The port's round over a data 2 x model 2 mesh, on the CPU.

The counterpart of tests/test_sharded_round.py's ``make_mesh(4,
model_parallelism=2)`` cases.  This file runs itself as two gloo rank
processes (``python tests/test_torch_parallel_width_dp.py --rank R
--port P --out F``), each of which splits its share of the minibatch
over the width of its mesh row: ``make_mesh(4, model_parallelism=2,
device="cpu")``, row r for rank r.  Inputs are those of
tests/test_torch_parallel_dp.py (seeded student, 64x128 uint8 frames and
labels, global batch 4, one ``idx_seq``).  Gates, tests/test_sharded_
round.py's:
- full_model, one iteration from zero Adam slots: loss rtol 1e-5; BN
  moving statistics rtol 1e-4 / atol 1e-6; weights within one Adam step;
- coord_desc_auto, two iterations, with and without the fused loss (K2's
  plain version on the CPU, once per mesh row on the gathered grid): the
  first loss rtol 1e-5, the losses rtol 1e-3, masks agreeing on more
  than 0.999 of coordinates;
- against JAX's ``make_sharded_distill_round(make_mesh(4,
  model_parallelism=2))`` on the same params, warm Adam slots, buffers
  and ``idx_seq``: coord_desc_auto, one iteration (the peeled selection
  step alone, one JAX compile), with the full_model gates and mask
  agreement above 0.999;
- the two ranks' outputs are equal to the bit;
- a mesh whose ``data`` axis is not the group's world size raises.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.dirname(os.path.abspath(__file__))):
    if path not in sys.path:
        sys.path.insert(0, path)

from test_torch_parallel_dp import (  # noqa: E402
    CAP,
    CASES,
    LR,
    _case,
    _collect,
    _free_port,
    _data,
    _run,
    _spec,
    warm_slots,
)

from ams_tpu_torch.convert import params_to_numpy  # noqa: E402
from ams_tpu_torch.distill.train_step import make_distill_round  # noqa: E402
from ams_tpu_torch.models.mobilenetv2_deeplab import (  # noqa: E402
    init_student_params,
)

WORLD, MODEL = 2, 2
BN_KEYS = ("MobilenetV2/Conv/BatchNorm/moving_mean",
           "concat_projection/BatchNorm/moving_variance")


def _mesh():
    from ams_tpu_torch.parallel import make_mesh

    return make_mesh(WORLD * MODEL, model_parallelism=MODEL, device="cpu")


def _rank_main(argv):
    """A rank process: every case through the round over row ``rank`` of
    the mesh -> one .npz."""
    from ams_tpu_torch.parallel import init_multi_host, make_mesh, \
        make_sharded_distill_round
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    init_multi_host("localhost:%d" % a.port, WORLD, a.rank, backend="gloo")
    res = {}
    try:
        for case in CASES:
            fn = make_sharded_distill_round(_spec(case), _mesh())
            res.update({case + "/" + k: v
                        for k, v in _run(case, fn).items()})
        try:
            make_sharded_distill_round(
                _spec("full_model"),
                make_mesh(MODEL, model_parallelism=MODEL, device="cpu"))
            res["world_mismatch_raises"] = np.bool_(False)
        except ValueError:
            res["world_mismatch_raises"] = np.bool_(True)
    finally:
        dist.destroy_process_group()
    np.savez(a.out, **res)
    return 0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("width_dp"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [os.path.join(tmp, "r%d.npz" % r) for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--out", outs[r]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    return _collect(procs, outs)


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(2)
    return {case: _run(case, make_distill_round(_spec(case)))
            for case in CASES if case != "jax"}


def test_full_model_matches_single_device(ranks, single):
    got, want = _case(ranks[0], "full_model"), single["full_model"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in BN_KEYS:
        np.testing.assert_allclose(got["param:" + k], want["param:" + k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    d = np.abs(got["param:logits/semantic/weights"]
               - want["param:logits/semantic/weights"])
    assert float(d.max()) <= 2 * LR * 3.2 + 1e-6


@pytest.mark.parametrize("case", ["coord_desc_auto", "fused"])
def test_coord_desc_selection_agrees(ranks, single, case):
    got, want = _case(ranks[0], case), single[case]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    keys = [k for k in want if k.startswith("mask:")]
    total = sum(want[k].size for k in keys)
    agree = sum(int((got[k] == want[k]).sum()) for k in keys)
    assert agree / total > 0.999, agree / total


def test_ranks_match_jax_round_over_model_2(ranks):
    """JAX's GSPMD round on a (data 2, model 2) virtual CPU mesh and the
    port's two ranks of width-partitioned rows, from the same params,
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
    mesh = make_mesh(WORLD * MODEL, model_parallelism=MODEL)
    spec = _spec("jax")
    fn = jround(jts.DistillSpec(
        batch_size=spec.batch_size, num_classes=19,
        class_indices=spec.class_indices, coord_frac=0.1,
        compute_dtype="float32", **CASES["jax"]), mesh)
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
    print("JAX round over model 2: compile and run %.1f s"
          % (time.perf_counter() - t0))
    got = _case(ranks[0], "jax")
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    for k in BN_KEYS:
        np.testing.assert_allclose(got["param:" + k], np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    d = max(float(np.abs(got["param:" + k] - np.asarray(jp[k])).max())
            for k in m)
    assert d <= 2.05 * LR, d
    total = sum(x.size for x in m.values())
    agree = sum(int((got["mask:" + k] == np.asarray(jm[k])).sum()) for k in m)
    assert agree / total > 0.999, agree / total


def test_ranks_hold_the_same_bits(ranks):
    r0, r1 = ranks
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_mesh_data_axis_must_be_the_world(ranks):
    assert all(bool(r["world_mismatch_raises"]) for r in ranks)


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
