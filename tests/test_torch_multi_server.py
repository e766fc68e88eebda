"""The port's MultiVideoServer against ams_tpu's, on the CPU.

The counterparts of the 12 tests of tests/test_multi_server.py at their
sizes (h=32, batch 2, memory capacity 4, exps 25/22/12/17), with the
port's mesh of CPU entries in place of JAX's virtual devices; a video
count that does not divide the mesh raises ``ValueError`` (JAX asserts).
Against JAX's server, with no JAX round run:
- a ``save_state`` bundle written by either package loads in the other
  with params, Adam slots, masks and memories equal to the bit, and the
  loaded key is usable (a port round; ``jax.random.split``);
- ``encode_delta`` gives the same bytes on the same params and masks as
  JAX's, both servers encoding with their native codecs (the gzip
  header's OS byte included) and both with their Python codecs;
- the fixed coord strategies' masks are equal to the bit;
- ``deploy``'s artifact equals JAX's ``fold_student`` to the bit (the bar
  of tests/test_torch_frozen.py);
- with ``checkpoint=`` both servers start from the same weights.
"""

import functools
import gzip
import os

import numpy as np
import pytest
import torch

import jax

from ams_tpu.models import frozen as jfrozen
from ams_tpu.parallel.mesh import make_mesh as jmake_mesh
from ams_tpu.runtime import multi_server as jmulti
from ams_tpu.runtime.multi_server import MultiVideoServer as JServer
from ams_tpu.stream import codec as jcodec

from ams_tpu_torch import configs
from ams_tpu_torch.parallel.mesh import make_mesh
from ams_tpu_torch.runtime.multi_server import (
    MultiVideoServer,
    prng_key,
    split_key,
)
from ams_tpu_torch.runtime import multi_server as tmulti
from ams_tpu_torch.stream import codec as tcodec
from ams_tpu_torch.stream.codec import decode_delta

H, CAP = 32, 4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _samples(rng, n):
    return ([rng.randint(0, 256, (H, 2 * H, 3)).astype(np.uint8)
             for _ in range(n)],
            [rng.randint(0, 19, (H, 2 * H)).astype(np.uint8)
             for _ in range(n)])


def _server(ids, n_dev, **kw):
    kw = dict(dict(batch_size=2, lr=1e-2, memory_capacity=CAP), **kw)
    return MultiVideoServer(video_ids=ids, height=H,
                            mesh=make_mesh(n_dev, device="cpu"),
                            device="cpu", **kw)


def _fill(srv, n, seed=0):
    rng = np.random.RandomState(seed)
    for v in range(srv.V):
        srv.ingest(v, *_samples(rng, n))


def _selected_share(blob, shapes, strategy="coord_desc_auto"):
    masks, _ = decode_delta(blob, shapes, strategy=strategy)
    trainable = [k for k in masks if "moving_" not in k]
    total = sum(masks[k].size for k in trainable)
    return sum(int(masks[k].sum()) for k in trainable) / total


@pytest.fixture(scope="module")
def server():
    srv = _server([25, 22, 12, 17], 4, lr=1e-3, strategy="coord_desc_auto",
                  coord_frac=0.1)
    _fill(srv, 3)
    return srv


def test_concurrent_round(server):
    losses = server.train_round(iters=2)
    assert losses.shape == (server.V, 2)
    assert np.isfinite(losses).all()
    w = server.params_V["logits/semantic/weights"].numpy()
    assert not np.allclose(w[0], w[1])


def test_per_video_delta(server):
    blob = server.encode_delta(0)
    assert len(blob) > 100
    shapes = {k: v.shape for k, v in server.video_params(0).items()}
    assert 0.05 < _selected_share(blob, shapes) < 0.15


def test_restore_initial_single_video(server):
    server.train_round(iters=1)
    before = server.video_params(1)
    server.restore_initial(video_idx=0)
    after0 = server.video_params(0)
    for k in ("logits/semantic/weights", "aspp0/weights"):
        np.testing.assert_array_equal(after0[k],
                                      server._initial_V[k][0].numpy())
    np.testing.assert_array_equal(
        server.video_params(1)["logits/semantic/weights"],
        before["logits/semantic/weights"])


def test_deploy(server, tmp_path):
    path = str(tmp_path / "client0")
    server.deploy(0, path)
    assert os.path.exists(path + ".npz")
    with np.load(path + ".npz") as z:
        ours = {k: z[k] for k in z.files}
    want = {k: np.asarray(v) for k, v in jfrozen.fold_student(
        {k: jax.numpy.asarray(v)
         for k, v in server.video_params(0).items()}).items()}
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)


def test_more_videos_than_devices():
    srv = _server([25, 22, 12, 17], 2, strategy="full_model")
    assert srv.videos_per_device == 2
    _fill(srv, 2)
    before = [srv.video_params(v)["logits/semantic/weights"]
              for v in range(4)]
    losses = srv.train_round(iters=1)
    assert losses.shape == (4, 1)
    for v in range(4):
        after = srv.video_params(v)["logits/semantic/weights"]
        assert not np.array_equal(after, before[v]), "video %d" % v


def test_keep_mask_reuses_selection(server):
    server.train_round(iters=2)
    mask_before = {k: v.clone() for k, v in server.mask_V.items()}
    server.train_round(iters=1, keep_mask=True)
    for k, v in server.mask_V.items():
        assert torch.equal(v, mask_before[k]), k


def test_video_count_must_divide_mesh():
    with pytest.raises(ValueError, match="multiple of the mesh"):
        _server([25, 22, 12], 2)


def test_different_class_subsets_per_video():
    srv = _server([25, 17], 2, strategy="coord_desc_auto", coord_frac=0.1)
    # 25 -> {0,1,2,10,11,13}, 17 -> {0,2,8,10,11,13}: a union of 7
    assert len(srv.class_indices) == 7
    cm = srv.class_mask_V.numpy()
    assert cm.shape == (2, 7) and not np.array_equal(cm[0], cm[1])
    for v, vid in enumerate(srv.video_ids):
        got = {c for c, m in zip(srv.class_indices, cm[v]) if m > 0}
        assert got == set(configs.class_indices(vid).tolist())
    _fill(srv, 3)
    losses = srv.train_round(iters=2, no_restore=False)
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    for v in range(2):
        shapes = {k: x.shape for k, x in srv.video_params(v).items()}
        assert 0.05 < _selected_share(srv.encode_delta(v), shapes) < 0.15


def test_multi_video_resume_roundtrip(tmp_path):
    def mk():
        return _server([25, 17], 2, strategy="coord_desc_auto",
                       coord_frac=0.1)

    srv = mk()
    _fill(srv, 2)
    srv.train_round(iters=1)
    prefix = str(tmp_path / "mv")
    srv.save_state(prefix)
    l1 = srv.train_round(iters=1, keep_mask=True)

    srv2 = mk()
    assert srv2.load_state(prefix)
    for k in srv.mask_V:
        assert torch.equal(srv2.mask_V[k], srv.mask_V[k])
    l2 = srv2.train_round(iters=1, keep_mask=True)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    assert not mk().load_state(str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="video_ids"):
        _server([25, 22], 2).load_state(prefix)


def test_empty_memory_refuses_round():
    srv = _server([25, 17], 2, strategy="full_model")
    srv.ingest(0, *_samples(np.random.RandomState(0), 1))
    with pytest.raises(ValueError, match=r"\[1\]"):
        srv.train_round(iters=1)


def test_fixed_coord_strategy_builds_masks():
    srv = _server([25, 17], 2, strategy="coord_desc_last", coord_frac=0.1)
    total = sum(int(v[0].numel()) for v in srv.mask_V.values())
    sel = sum(int(v[0].sum()) for v in srv.mask_V.values())
    assert 0.05 < sel / total < 0.15, "mask does not match the 10% recipe"
    _fill(srv, 2)
    before = {k: v.clone() for k, v in srv.params_V.items()}
    srv.train_round(iters=2)
    for k, m in srv.mask_V.items():
        assert torch.equal(before[k][~m], srv.params_V[k][~m]), k


def test_coord_delta_ships_stats_annex(server):
    server.train_round(iters=1)
    blob = server.encode_delta(0)
    params0 = server.video_params(0)
    shapes = {k: v.shape for k, v in params0.items()}
    masks, values = decode_delta(blob, shapes, strategy="coord_desc_auto")
    stat = "MobilenetV2/Conv/BatchNorm/moving_mean"
    assert stat in masks and masks[stat].all(), "stats annex missing"
    np.testing.assert_array_equal(
        values[stat], params0[stat].astype(np.float16).astype(np.float32))
    masks2, _ = decode_delta(server.encode_delta(0, stats_annex=False),
                             shapes, strategy="coord_desc_auto")
    assert stat not in masks2


# ------------------------------------------------------------ against JAX


def _jax_server(**kw):
    return JServer(video_ids=[25, 17], height=H, batch_size=2, lr=1e-2,
                   memory_capacity=CAP, mesh=jmake_mesh(2), **kw)


def _bundle(prefix):
    with np.load(prefix + "_mv_resume.npz") as z:
        return {k: z[k] for k in z.files}


def _assert_bundles_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_server_key_matches_jax():
    for seed in (0, 5, 2 ** 31 - 1):
        np.testing.assert_array_equal(prng_key(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    key, seeds = split_key(prng_key(3), 4)
    assert key.dtype == np.uint32 and key.shape == (2,)
    assert len(set(seeds)) == 4 and all(0 <= s < 2 ** 64 for s in seeds)
    again = split_key(prng_key(3), 4)
    np.testing.assert_array_equal(again[0], key)
    assert again[1] == seeds


def test_bundles_load_across_packages(tmp_path, monkeypatch):
    """JAX writes (with slots, masks and key moved off their initial
    values), the port loads, trains a round and writes; JAX loads that.
    The bundles re-saved by the loader are the loaded ones to the bit."""
    rng = np.random.RandomState(1)
    jsrv = _jax_server(strategy="coord_desc_auto", coord_frac=0.1)
    for v in range(2):
        jsrv.ingest(v, *_samples(rng, 2 + v))
    jnp = jax.numpy
    opt = jsrv.opt_V
    jsrv.opt_V = type(opt)(
        step=jnp.asarray([3, 4], jnp.int32),
        m={k: jnp.asarray(rng.randn(*x.shape).astype(np.float32))
           for k, x in opt.m.items()},
        v={k: jnp.asarray(rng.rand(*x.shape).astype(np.float32))
           for k, x in opt.v.items()})
    jsrv.mask_V = {k: jnp.asarray(rng.rand(*x.shape) < 0.5)
                   for k, x in jsrv.mask_V.items()}
    jsrv._rng = jax.random.split(jsrv._rng)[0]
    jprefix = str(tmp_path / "from_jax")
    jsrv.save_state(jprefix)

    tsrv = _server([25, 17], 2, strategy="coord_desc_auto", coord_frac=0.1)
    assert tsrv.load_state(jprefix)
    for v in range(2):
        assert len(tsrv.memories[v]) == 2 + v
    assert tsrv.opt_V.step.tolist() == [3, 4]
    tprefix = str(tmp_path / "port_resaved")
    tsrv.save_state(tprefix)
    _assert_bundles_equal(_bundle(jprefix), _bundle(tprefix))
    # the same state gives the same wire bytes: both servers encode with
    # their native codecs, whose gzip header names the OS (byte 9), and
    # both Python codecs, which leave it unknown, agree too
    for v in range(2):
        for annex in (True, False):
            ours = tsrv.encode_delta(v, stats_annex=annex)
            assert ours == jsrv.encode_delta(v, stats_annex=annex)
            with monkeypatch.context() as m:
                m.setattr(jmulti, "encode_delta", functools.partial(
                    jcodec.encode_delta, use_native=False))
                m.setattr(tmulti, "encode_delta", functools.partial(
                    tcodec.encode_delta, use_native=False))
                python = tsrv.encode_delta(v, stats_annex=annex)
                assert python == jsrv.encode_delta(v, stats_annex=annex)
                assert gzip.decompress(python) == gzip.decompress(ours)

    # the loaded key drives a port round; the port's bundle loads in JAX
    losses = tsrv.train_round(iters=1, keep_mask=True)
    assert np.isfinite(losses).all()
    assert not np.array_equal(tsrv._rng, _bundle(jprefix)["rng"])
    tsrv.save_state(tprefix)
    jsrv2 = _jax_server(strategy="coord_desc_auto", coord_frac=0.1)
    assert jsrv2.load_state(tprefix)
    jprefix2 = str(tmp_path / "jax_resaved")
    jsrv2.save_state(jprefix2)
    _assert_bundles_equal(_bundle(tprefix), _bundle(jprefix2))
    k1, k2 = jax.random.split(jsrv2._rng)
    assert k1.shape == (2,) and not np.array_equal(k1, k2)


@pytest.mark.parametrize("strategy", ["coord_desc_last", "coord_desc_rand"])
def test_fixed_strategy_masks_and_checkpoint_equal_jax(strategy, tmp_path):
    """The fixed strategies' masks bit for bit; with ``checkpoint=`` both
    packages start every video from the same weights (``load_any`` +
    ``merge_restore``), whatever their inits."""
    from ams_tpu_torch.convert import params_to_numpy
    from ams_tpu_torch.models.mobilenetv2_deeplab import init_student_params

    path = str(tmp_path / "student.npz")
    np.savez(path, **params_to_numpy(init_student_params(7, device="cpu")))
    kw = dict(strategy=strategy, coord_frac=0.1, seed=3, checkpoint=path)
    tsrv = _server([25, 17], 2, **kw)
    jsrv = _jax_server(**kw)
    assert set(tsrv.mask_V) == set(jsrv.mask_V)
    for k, m in jsrv.mask_V.items():
        np.testing.assert_array_equal(tsrv.mask_V[k].numpy(), np.asarray(m),
                                      err_msg=k)
    assert set(tsrv.params_V) == set(jsrv.params_V)
    for k, v in jsrv.params_V.items():
        np.testing.assert_array_equal(tsrv.params_V[k].numpy(),
                                      np.asarray(v), err_msg=k)


def test_server_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiVideoServer(video_ids=[25], height=H, batch_size=2, lr=1e-3)


@pytest.mark.cuda
def test_server_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 9 runs the "
                    "server on the card")
    srv = MultiVideoServer(video_ids=[25, 17], height=H, batch_size=2,
                           lr=1e-2, strategy="coord_desc_auto",
                           memory_capacity=CAP)
    _fill(srv, 2)
    losses = srv.train_round(iters=2)
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    assert srv.params_V["aspp0/weights"].is_cuda
