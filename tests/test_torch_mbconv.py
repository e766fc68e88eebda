"""The port's fused MBConv block against ams_tpu's Pallas kernels (K3, K4).

On the CPU the wrappers run ``mbconv_plain``; it is held against the JAX
kernels in interpret mode on every case of tests/test_fused_mbconv.py and
tests/test_fused_mbconv_banded.py (stride 2 included) and on the
mixed-rate stage.  Both compute the same storage points (bf16 after each
relu6 and at the output, f32 accumulation, f32 depthwise weights), so the
bar is far tighter than those tests' atol/rtol 0.05: rtol 2^-7 with an
atol of 2^-7 times the output's largest magnitude (about one bf16 ulp),
and at most 1% of the outputs may differ at all.  Measured on this host:
every case equal bit for bit.  The CUDA kernel itself is held against
``mbconv_plain`` on the card by the ``cuda``-marked test and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ams_tpu.ops import fused_mbconv as JF
from ams_tpu.ops import fused_mbconv_banded as JB

from ams_tpu_torch.convert import params_from_numpy
from ams_tpu_torch.ops import build
from ams_tpu_torch.ops import fused_mbconv as F
from ams_tpu_torch.ops import fused_mbconv_banded as FB

BAR = 2.0 ** -7


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _weights(rng, cin, cmid, cout, has_expand):
    cm = cmid if has_expand else cin
    return dict(
        we=(rng.randn(1, 1, cin, cmid) * 0.1).astype(np.float32),
        be=(rng.randn(cmid) * 0.1).astype(np.float32),
        wd=(rng.randn(3, 3, cm, 1) * 0.1).astype(np.float32),
        bd=(rng.randn(cm) * 0.1).astype(np.float32),
        wpr=(rng.randn(1, 1, cm, cout) * 0.1).astype(np.float32),
        bp=(rng.randn(cout) * 0.1).astype(np.float32))


def _bf16(a):
    """numpy f32 holding bf16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _kernel_args(wt, has_expand, lib):
    """(w_expand, b_expand, w_dw, b_dw, w_proj, b_proj) in the kernels'
    layout, as jnp (lib=jnp) or torch (lib=torch) arrays."""
    conv = jnp.asarray if lib is jnp else torch.from_numpy
    cm = wt["wd"].shape[2]
    return (conv(wt["we"][0, 0]) if has_expand else None,
            conv(wt["be"][None]) if has_expand else None,
            conv(np.ascontiguousarray(wt["wd"][:, :, :, 0].reshape(9, cm))),
            conv(wt["bd"][None]), conv(wt["wpr"][0, 0]), conv(wt["bp"][None]))


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2) \
        .to(torch.bfloat16)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _assert_close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BAR, atol=BAR * scale)
    assert (got != want).mean() <= 0.01


@pytest.mark.parametrize(
    "h,w,cin,cmid,cout,rate,residual,has_expand",
    [
        (13, 11, 8, 32, 8, 1, True, True),
        (13, 11, 8, 32, 16, 1, False, True),
        (9, 9, 8, 8, 8, 1, False, False),     # block-0 style (no expand)
        (17, 15, 16, 96, 16, 2, True, True),  # atrous
    ])
def test_plain_matches_fused_mbconv_flat(h, w, cin, cmid, cout, rate,
                                         residual, has_expand):
    """The cases of tests/test_fused_mbconv.py::test_block_parity."""
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(2, h, w, cin))
    wt = _weights(rng, cin, cmid, cout, has_expand)
    hp, wp, trb = JF.stage_geometry(h, w, rate, 4)
    out = JF.mbconv_flat(JF.to_flat(jnp.asarray(x, jnp.bfloat16), hp, wp,
                                    trb, rate),
                         *_kernel_args(wt, has_expand, jnp), hp=hp, wp=wp,
                         trb=trb, h=h, w=w, rate=rate, residual=residual,
                         interpret=True)
    want = np.asarray(JF.from_flat(out, hp, wp, trb, rate, h, w), np.float32)
    got = F.mbconv_block(_nchw(x), *_kernel_args(wt, has_expand, torch),
                         rate=rate, residual=residual)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_close(_nhwc(got), want)


def test_mixed_rate_stage_matches():
    """tests/test_fused_mbconv.py::test_mixed_rate_stage: a rate-1 block
    then a rate-2 block chained in one rate-2 stage layout."""
    rng = np.random.RandomState(1)
    h, w, c = 11, 13, 8
    x = _bf16(rng.randn(1, h, w, c))
    blocks = [_weights(rng, c, 4 * c, c, True) for _ in range(2)]
    hp, wp, trb = JF.stage_geometry(h, w, 2, 4)
    y = JF.to_flat(jnp.asarray(x, jnp.bfloat16), hp, wp, trb, 2)
    t = _nchw(x)
    for wt, rate in zip(blocks, (1, 2)):
        y = JF.mbconv_flat(y, *_kernel_args(wt, True, jnp), hp=hp, wp=wp,
                           trb=trb, h=h, w=w, rate=rate, col0=2,
                           residual=True, interpret=True)
        t = F.mbconv_block(t, *_kernel_args(wt, True, torch), rate=rate,
                           residual=True)
    want = np.asarray(JF.from_flat(y, hp, wp, trb, 2, h, w), np.float32)
    _assert_close(_nhwc(t), want)


@pytest.mark.parametrize(
    "h,w,cin,cmid,cout,stride,residual,has_expand,tr",
    [
        (32, 48, 8, 32, 8, 1, True, True, 8),
        (32, 48, 8, 32, 16, 1, False, True, 8),
        (24, 32, 8, 8, 16, 1, False, False, 4),
        (32, 48, 8, 32, 16, 2, False, True, 4),
        (64, 32, 8, 32, 16, 2, False, True, 8),
        (40, 48, 8, 16, 8, 1, False, True, 16),
        (33, 65, 8, 32, 8, 1, True, True, 8),
        (17, 33, 8, 8, 16, 1, False, False, 4),
        (33, 65, 8, 32, 16, 1, False, True, 16),
    ])
def test_plain_matches_mbconv_banded(h, w, cin, cmid, cout, stride,
                                     residual, has_expand, tr):
    """The cases of tests/test_fused_mbconv_banded.py::test_banded_parity
    (``tr`` is the TPU's band height; the port tiles by itself)."""
    rng = np.random.RandomState(0)
    x = _bf16(rng.randn(2, h, w, cin))
    wt = _weights(rng, cin, cmid, cout, has_expand)
    want = np.asarray(JB.mbconv_banded(
        jnp.asarray(x, jnp.bfloat16), *_kernel_args(wt, has_expand, jnp),
        stride=stride, residual=residual, tr=tr, interpret=True), np.float32)
    before = build.launch_count("mbconv_banded")
    got = FB.mbconv_banded(_nchw(x), *_kernel_args(wt, has_expand, torch),
                           stride=stride, residual=residual)
    # the CPU runs no kernel
    assert build.launch_count("mbconv_banded") == before
    _assert_close(_nhwc(got), want)


def test_run_fused_stage_matches():
    """A two-block stride-1 stage (residual, then widening) through both
    packages' run_fused_stage, from a folded-style weight dict."""
    rng = np.random.RandomState(3)
    h, w, c = 15, 21, 16
    x = _bf16(rng.randn(2, h, w, c))
    folded = {}
    for name, cin, cout in (("blk_a", c, c), ("blk_b", c, 24)):
        wt = _weights(rng, cin, 6 * cin, cout, True)
        folded[name + "/expand/weights"] = wt["we"]
        folded[name + "/expand/folded_bias"] = wt["be"]
        folded[name + "/depthwise/depthwise_weights"] = wt["wd"]
        folded[name + "/depthwise/folded_bias"] = wt["bd"]
        folded[name + "/project/weights"] = wt["wpr"]
        folded[name + "/project/folded_bias"] = wt["bp"]
    spec = (("blk_a", True, 1, True), ("blk_b", True, 1, False))
    jblocks = [JF.FusedBlock(folded, *s) for s in spec]
    want = np.asarray(JF.run_fused_stage(jnp.asarray(x, jnp.bfloat16),
                                         jblocks, interpret=True), np.float32)
    tp = params_from_numpy(folded, "cpu")
    tblocks = [F.fused_block(tp, *s) for s in spec]
    _assert_close(_nhwc(F.run_fused_stage(_nchw(x), tblocks)), want)


def test_banded_supported_matches():
    for h in (1, 2, 3, 4, 16, 17, 33, 64, 65, 129, 256, 257):
        for w in (1, 15, 16, 17, 32, 33, 48, 65, 128, 129, 512, 513):
            for stride in (1, 2, 3):
                for rate in (1, 2):
                    assert FB.banded_supported(h, w, stride, rate) == \
                        JB.banded_supported(h, w, stride, rate), \
                        (h, w, stride, rate)


# every block of the student (cin, cmid, cout, stride, rate, has_expand)
_STUDENT_BLOCKS = [
    (32, 32, 16, 1, 1, False), (16, 96, 24, 2, 1, True),
    (24, 144, 24, 1, 1, True), (24, 144, 32, 2, 1, True),
    (32, 192, 32, 1, 1, True), (32, 192, 64, 2, 1, True),
    (64, 384, 64, 1, 1, True), (64, 384, 96, 1, 1, True),
    (96, 576, 96, 1, 1, True), (96, 576, 160, 1, 1, True),
    (160, 960, 160, 1, 2, True), (160, 960, 320, 1, 2, True),
]
# each block's input grid in the 512x1024 forward (the stem gives 257x513)
_STUDENT_GRIDS = [(257, 513), (257, 513), (129, 257), (129, 257),
                  (65, 129), (65, 129), (33, 65), (33, 65), (33, 65),
                  (33, 65), (33, 65), (33, 65)]


class _H100Occupancy:
    """The planner's view of the built kernel (``F.KernelOccupancy``) with
    no card to ask: the registers per thread (and spilled bytes) of each
    warp tiling as the compiler gave them on the card (PERF.md,
    chip_smoke.py phase 2), and an H100 SM's 233,472 bytes of shared
    memory (1 KB reserved per block), 65,536 registers (allocated per
    thread in steps of 8) and 2,048 threads."""
    registers = {(2, 2): (94, 0), (2, 3): (103, 0), (2, 4): (112, 0),
                 (3, 4): (119, 0), (3, 5): (147, 0)}
    tilings = tuple(registers)

    def resident(self, mt, nt, smem):
        regs = -(-self.registers[(mt, nt)][0] // 8) * 8
        return min(233472 // (smem + 1024), 65536 // (regs * F.THREADS),
                   2048 // F.THREADS)


_OCC = _H100Occupancy()


@pytest.mark.parametrize("block", _STUDENT_BLOCKS)
def test_stage_tile_always_fits(block):
    """The shared-memory tile choice that replaces stage_fits_vmem finds a
    tile for every block of the student, inside the 227 KB a block may
    use, with a chunk that divides the mid width, on the block's grid of
    the 512x1024 forward and with no grid given."""
    cin, cmid, cout, stride, rate, has_expand = block
    grid = _STUDENT_GRIDS[_STUDENT_BLOCKS.index(block)]
    for hw in (grid, ()):
        tile_h, tile_w, chunk = F.stage_tile(cin, cmid, cout, stride, rate,
                                             has_expand, *hw, occupancy=_OCC)
        assert (tile_h * tile_w) % 16 == 0 and cmid % chunk == 0
        assert chunk % 8 == 0
        assert F.smem_bytes(cin, cout, stride, rate, has_expand, tile_h,
                            tile_w, chunk) <= F.SMEM_LIMIT
        # the kernel takes it: chunks of 16 to 64 (the student's mid
        # widths are multiples of 16), a compiled warp tiling
        assert chunk % 16 == 0 and chunk <= 64
        assert F.warp_tiles(tile_h * tile_w, cout, _OCC.tilings) \
            in _OCC.tilings
    # the smallest plan the student's blocks can take, a 1x16 tile with a
    # 16-channel chunk, fits too: no block ever needs an unfused fallback
    assert F.smem_bytes(cin, cout, stride, rate, has_expand, 1, 16,
                        16) <= F.SMEM_LIMIT


@pytest.mark.parametrize("block,grid", list(zip(_STUDENT_BLOCKS,
                                                _STUDENT_GRIDS)))
def test_plan_accumulators_within_budget(block, grid):
    """The project accumulators a thread keeps in registers stay within
    ACC_BUDGET, and the warps' tiles cover the block's output tile."""
    cin, cmid, cout, stride, rate, has_expand = block
    tile_h, tile_w, chunk = F.stage_tile(cin, cmid, cout, stride, rate,
                                         has_expand, *grid, occupancy=_OCC)
    mt, nt = F.warp_tiles(tile_h * tile_w, cout, _OCC.tilings)
    warps = -(-(tile_h * tile_w // 16) // mt) * -(-(cout // 8) // nt)
    assert warps <= F.THREADS // 32
    assert F.acc_registers(tile_h, tile_w, cout, _OCC.tilings) \
        == 4 * mt * nt <= F.ACC_BUDGET


def test_tail_plan_expands_less_than_the_first_kernel():
    """expanded_conv_16 (33x65, rate 2, 160->960->320): the first
    kernel's 4x16 tile expanded 7,200 window positions per image for its
    2,145 output pixels (3.36 each); the plan chosen by waste expands
    fewer, and projects no more pixels."""
    args = (160, 960, 320, 1, 2, True)
    old = F.plan_cost(160, 320, 1, 2, True, 4, 16, 16, 33, 65,
                      occupancy=_OCC)
    assert old["window_per_px"] == pytest.approx(7200 / 2145)
    new = F.plan_cost(160, 320, 1, 2, True,
                      *F.stage_tile(*args, 33, 65, occupancy=_OCC), 33, 65,
                      occupancy=_OCC)
    assert new["window_per_px"] < 7200 / 2145
    assert new["projected_per_px"] <= old["projected_per_px"]


def _folded(rng, name, cin, cmid, cout, has_expand):
    wt = _weights(rng, cin, cmid, cout, has_expand)
    d = {name + "/depthwise/depthwise_weights": wt["wd"],
         name + "/depthwise/folded_bias": wt["bd"],
         name + "/project/weights": wt["wpr"],
         name + "/project/folded_bias": wt["bp"]}
    if has_expand:
        d[name + "/expand/weights"] = wt["we"]
        d[name + "/expand/folded_bias"] = wt["be"]
    return params_from_numpy(d, "cpu")


@pytest.mark.parametrize("block,grid", list(zip(_STUDENT_BLOCKS,
                                                _STUDENT_GRIDS)))
def test_packed_weights_unpack_to_the_block(block, grid):
    """The kernel-layout weights of every block shape, at the chunk its
    plan takes and at every other chunk it could take (8 included),
    unpack to FusedBlock's own w_expand / w_proj / w_dw and biases bit for
    bit; the k padding of both 1x1 products and a missing expand's bias
    are zeros."""
    cin, cmid, cout, stride, rate, has_expand = block
    rng = np.random.RandomState(cin + cmid + cout)
    bl = F.fused_block(_folded(rng, "pk", cin, cmid, cout, has_expand),
                       "pk", has_expand, rate, False)
    ws = (bl.w_expand, bl.b_expand, bl.w_dw, bl.b_dw, bl.w_proj)
    plan_chunk = F.stage_tile(cin, cmid, cout, stride, rate, has_expand,
                              *grid, occupancy=_OCC)[2]
    chunks = [c for c in (8, 16, 32, 48, 64) if cmid % c == 0]
    assert plan_chunk in chunks
    for chunk in chunks:
        we, wp, f = F.packed_weights(*ws, chunk, "cpu")
        n, chunk_p = cmid // chunk, -(-chunk // 16) * 16
        assert wp.dtype == torch.bfloat16 and f.dtype == torch.float32
        assert wp.shape == (n, cout, chunk_p) and wp.is_contiguous()
        assert torch.equal(wp[:, :, :chunk].transpose(1, 2)
                           .reshape(cmid, cout), bl.w_proj)
        assert not wp[:, :, chunk:].any()
        assert f.shape == (n, 11, chunk) and f.is_contiguous()
        ft = f.transpose(0, 1).reshape(11, cmid)
        assert torch.equal(ft[:9], bl.w_dw)
        assert torch.equal(ft[9], bl.b_dw.reshape(-1))
        if has_expand:
            cin_p = -(-cin // 16) * 16
            assert we.dtype == torch.bfloat16
            assert we.shape == (cmid, cin_p) and we.is_contiguous()
            assert torch.equal(we[:, :cin].t(), bl.w_expand)
            assert not we[:, cin:].any()
            assert torch.equal(ft[10], bl.b_expand.reshape(-1))
        else:
            assert we is None and not ft[10].any()
        assert F.packed_weights(*ws, chunk, "cpu") is \
            F.packed_weights(*ws, chunk, "cpu")        # built once


def test_packed_weights_follow_the_parameters():
    """The packed layout is rebuilt with the block: after an in-place
    update of a folded tensor, after a new parameter dict, and after an
    in-place update of the block's own weights, the packed weights hold
    the new values."""
    def packed(bl, chunk=16):
        return F.packed_weights(bl.w_expand, bl.b_expand, bl.w_dw, bl.b_dw,
                                bl.w_proj, chunk, "cpu")

    rng = np.random.RandomState(6)
    folded = _folded(rng, "b", 8, 32, 16, True)
    first = F.fused_block(folded, "b", True, 1, False)
    we0, wp0, f0 = packed(first)
    folded["b/project/weights"].mul_(2.0)
    folded["b/depthwise/folded_bias"].add_(1.0)
    second = F.fused_block(folded, "b", True, 1, False)
    assert second is not first
    we1, wp1, f1 = packed(second)
    assert torch.equal(wp1, (wp0.float() * 2).to(torch.bfloat16))
    assert torch.equal(f1[:, 9], f0[:, 9] + 1.0)
    assert torch.equal(we1, we0)
    new = {k: v.clone() * 2 for k, v in folded.items()}
    third = F.fused_block(new, "b", True, 1, False)
    assert third is not second
    we2, wp2, f2 = packed(third)
    assert torch.equal(we2, (we1.float() * 2).to(torch.bfloat16))
    assert torch.equal(f2, f1 * 2)
    third.w_dw.add_(1.0)
    assert torch.equal(packed(third)[2][:, :9], f2[:, :9] + 1.0)


def test_chunk_of_8_is_planned_and_packed():
    """A mid width that 16 does not divide (the JAX kernels' block-0 test
    case, 8 -> 8 -> 8 without expand) plans a chunk of 8, whose project
    runs at k = 16: the packed project weights carry 8 zero columns per
    chunk, and the launcher's checks take the block."""
    tile_h, tile_w, chunk = F.stage_tile(8, 8, 8, 1, 1, False, 9, 9,
                                         occupancy=_OCC)
    assert chunk == 8 and (tile_h * tile_w) % 16 == 0
    assert F.stage_tile(8, 24, 8, 1, 1, True, 9, 9,
                        occupancy=_OCC)[2] == 8
    rng = np.random.RandomState(7)
    wt = _kernel_args(_weights(rng, 8, 8, 8, False), False, torch)
    we, wp, f = F.pack_weights(*wt[:5], 8, "cpu")
    assert we is None and wp.shape == (1, 8, 16) and f.shape == (1, 11, 8)
    assert torch.equal(wp[0, :, :8].t(), wt[4].to(torch.bfloat16))
    assert not wp[:, :, 8:].any()
    # the smem sum rounds the chunk's bf16 rows to 16 (+ 8), as make_plan
    # does: only the two f32 buffers of 11 x chunk are smaller than at 16
    assert F.smem_bytes(8, 8, 1, 1, False, 1, 16, 8) == \
        F.smem_bytes(8, 8, 1, 1, False, 1, 16, 16) - 2 * 11 * 8 * 4


def test_launch_takes_a_mid_width_of_8(monkeypatch):
    """Every check of ``launch`` passes a block whose mid width is 8; the
    next step asks the built kernel for its occupancy."""
    class Reached(Exception):
        pass

    def reached():
        raise Reached

    monkeypatch.setattr(F, "kernel_occupancy", reached)
    rng = np.random.RandomState(8)
    x = torch.zeros(2, 8, 9, 9, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wt = _kernel_args(_weights(rng, 8, 8, 8, False), False, torch)
    with pytest.raises(Reached):
        F.launch("mbconv", x, *wt, stride=1, rate=1, residual=False)
    wt = _kernel_args(_weights(rng, 8, 24, 8, True), True, torch)
    with pytest.raises(Reached):
        F.launch("mbconv", x, *wt, stride=1, rate=1, residual=True)


def test_fused_block_cache_follows_the_parameters():
    """FusedBlock is reused for the same tensors and rebuilt for a new
    dict or an in-place update, so a cached block never outlives a change
    of the weights."""
    rng = np.random.RandomState(5)
    wt = _weights(rng, 8, 16, 8, True)
    folded = params_from_numpy({
        "b/expand/weights": wt["we"], "b/expand/folded_bias": wt["be"],
        "b/depthwise/depthwise_weights": wt["wd"],
        "b/depthwise/folded_bias": wt["bd"],
        "b/project/weights": wt["wpr"], "b/project/folded_bias": wt["bp"]},
        "cpu")
    first = F.fused_block(folded, "b", True, 1, True)
    assert F.fused_block(folded, "b", True, 1, True) is first
    b_proj = first.b_proj.clone()
    folded["b/project/folded_bias"].add_(1.0)
    second = F.fused_block(folded, "b", True, 1, True)
    assert second is not first
    torch.testing.assert_close(second.b_proj, b_proj + 1.0)
    new = {k: v.clone() * 2 for k, v in folded.items()}
    third = F.fused_block(new, "b", True, 1, True)
    assert third is not second
    torch.testing.assert_close(third.w_dw, second.w_dw * 2)


def test_cpu_tensor_never_touches_the_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    rng = np.random.RandomState(2)
    wt = _weights(rng, 8, 16, 8, True)
    before = (build.launch_count("mbconv"),
              build.launch_count("mbconv_banded"))
    x = _nchw(_bf16(rng.randn(1, 6, 7, 8)))
    assert F.mbconv_block(x, *_kernel_args(wt, True, torch),
                          residual=True).shape == (1, 8, 6, 7)
    assert FB.mbconv_banded(x, *_kernel_args(wt, True, torch),
                            stride=2).shape == (1, 8, 3, 4)
    assert (build.launch_count("mbconv"),
            build.launch_count("mbconv_banded")) == before


def test_wrapper_rejects_what_the_kernel_cannot_take():
    rng = np.random.RandomState(4)
    wt = _kernel_args(_weights(rng, 8, 16, 8, True), True, torch)
    with pytest.raises(ValueError):
        F.mbconv_block(torch.zeros(1, 8, 4, 4, device="meta"), *wt)
    with pytest.raises(ValueError):
        FB.mbconv_banded(torch.zeros(1, 8, 4, 4, device="meta"), *wt)
    # the launch checks, reached before any library is loaded
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        F.launch("mbconv", x.float(), *wt, stride=1, rate=1, residual=False)
    with pytest.raises(ValueError):      # NCHW storage, not channels-last
        F.launch("mbconv", torch.zeros(1, 8, 4, 5, dtype=torch.bfloat16),
                 *wt, stride=1, rate=1, residual=False)
    with pytest.raises(ValueError):      # residual needs cin == cout, s 1
        F.launch("mbconv", x.contiguous(memory_format=torch.channels_last),
                 *wt, stride=2, rate=1, residual=True)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernel is CUDA only")
    gen = torch.Generator().manual_seed(0)
    for (b, h, w, cin, cmid, cout, s, r, res, he) in [
            (2, 13, 11, 8, 32, 8, 1, 1, True, True),
            (2, 9, 9, 8, 8, 8, 1, 1, False, False),
            (2, 17, 15, 16, 96, 16, 1, 2, True, True),
            (2, 33, 65, 8, 32, 16, 2, 1, False, True),
            (8, 129, 257, 24, 144, 24, 1, 1, True, True),
            (8, 33, 65, 160, 960, 320, 1, 2, False, True)]:
        x = torch.randn(b, cin, h, w, generator=gen).to(
            "cuda", torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        ws = [(torch.randn(cin, cmid, generator=gen) / cin ** 0.5)
              if he else None,
              torch.randn(cmid, generator=gen) * 0.1 if he else None,
              torch.randn(9, cmid, generator=gen) / 3,
              torch.randn(cmid, generator=gen) * 0.1,
              torch.randn(cmid, cout, generator=gen) / cmid ** 0.5,
              torch.randn(cout, generator=gen) * 0.1]
        ws = [None if t is None else t.cuda() for t in ws]
        if s == 1:
            got = F.mbconv_block(x, *ws, rate=r, residual=res)
        else:
            got = FB.mbconv_banded(x, *ws, stride=s, residual=res)
        want = F.mbconv_plain(x, *ws, stride=s, rate=r, residual=res)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                                   atol=2 ** -8 * scale)
