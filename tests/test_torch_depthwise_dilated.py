"""The dilated depthwise kernel: its plain version, its routing in
``layers.depthwise_conv2d``, its wrapper's contract and its arithmetic.

On the CPU the wrapper runs its plain version, the ``F.conv2d`` call
``layers.depthwise_conv2d`` made before the kernel, bit for bit.  The
routing predicate is held to the cases the kernel takes; a CPU tensor
never launches it.  A torch emulation of the kernel's index arithmetic
(sub-lattices, column groups, row strips, the ring of rows, the padding
never read) writes every output once and agrees with the plain version
within the rounding both have: f32 sums rounded to bf16 once.

With a bias and a ReLU (the folded teacher's epilogue) the plain version
computes in float32 and rounds once, as the kernel does.

The ``cuda``-marked tests run on the card: the kernel against cuDNN at
every dilated shape of the benchmark's three cells (bit for bit without
an epilogue), its bias and bias+ReLU epilogues against a float32
reference rounded once, and one OS8 chunk of the teacher through
``teacher_predict_fast`` against the cuDNN route, raw and folded.
This file imports no JAX, so on a card machine it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_depthwise_dilated.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ams_tpu_torch.models import layers
from ams_tpu_torch.ops import build
from ams_tpu_torch.ops import depthwise_dilated as dd
from ams_tpu_torch.utils.trace import GLOBAL_TIMER

COUNTER = "layers/depthwise_dilated"


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _input(shape, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    return x.to(device, torch.bfloat16, memory_format=torch.channels_last)


def _weight(c, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed + 1)
    return (torch.randn((3, 3, c, 1), generator=g) * 0.5).to(device)


def _bias(c, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed + 2)
    return (torch.randn(c, generator=g) * 0.5).to(device)


def _agree(got, want, x, w, rate, padding, bias=None):
    """Both sum nine f32 products (and the bias) and round to bf16 once,
    in other orders: they differ by at most one bf16 ulp of the result,
    plus what the two f32 sums can differ by (a rounding of 2^-24 per
    term, 9 or with the bias 10, on both sides, of the sum of the terms'
    magnitudes) where the sum cancels.  A ReLU after the sum moves
    neither bound."""
    got, want = got.float(), want.float()
    mags = F.conv2d(x.float().abs(), w.float().abs().permute(2, 3, 0, 1),
                    padding=padding, dilation=rate, groups=x.shape[1])
    terms = 9
    if bias is not None:
        mags = mags + bias.float().abs()[:, None, None]
        terms = 10
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    tol = ulp + 2 * terms * 2.0 ** -24 * mags
    excess = ((got - want).abs() - tol).max().item()
    assert excess <= 0, "off by %g beyond an ulp" % excess
    return ((got - want).abs() / ulp).max().item()


# --- the plain version is the F.conv2d path as it was --------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rate", [2, 4, 12, 36])
@pytest.mark.parametrize("pads", ["same", "width_shard"])
def test_plain_is_the_conv2d_path_bit_for_bit(dtype, rate, pads):
    """``depthwise_dilated_plain`` at the padding ``_pad`` hands on equals
    ``layers.depthwise_conv2d`` (on the CPU, the F.conv2d path) bit for
    bit: TF's SAME (r, r) and a width shard's column window (r, 0)."""
    h, w = 2 * rate + 5, 2 * rate + 7
    x = _input((2, 16, h, w), rate)
    wt = _weight(16, rate)
    if dtype == "float32":
        x = x.float().contiguous()
    padding = (rate, rate) if pads == "same" else (rate, 0)
    pairs = ((padding[0],) * 2, (padding[1],) * 2)
    want = layers.depthwise_conv2d(x, wt, rate=rate, padding=pairs,
                                   compute_dtype=x.dtype)
    got = dd.depthwise_dilated_plain(x, wt.to(x.dtype), rate, padding)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if dtype == "bfloat16":
        assert torch.equal(dd.depthwise_dilated(x, wt.to(x.dtype), rate,
                                                padding), want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rate", [2, 5])
def test_plain_epilogue_is_f32_rounded_once(rate, relu):
    """With a bias (and a ReLU) the plain version is the float32
    convolution plus the bias (then the ReLU), rounded to bf16 once,
    channels-last; the wrapper's CPU route is the plain version; without
    either it is the bf16 ``F.conv2d`` as before."""
    x = _input((2, 12, 2 * rate + 6, 2 * rate + 5), rate)
    w = _weight(12, rate).to(torch.bfloat16)
    b = _bias(12, rate)
    want = F.conv2d(x.float(), w.float().permute(2, 3, 0, 1),
                    padding=(rate, rate), dilation=rate, groups=12) \
        + b[:, None, None]
    if relu:
        want = torch.relu(want)
    got = dd.depthwise_dilated_plain(x, w, rate, (rate, rate), b, relu)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want.to(torch.bfloat16))
    if relu:
        assert bool((got >= 0).all()) and bool((got == 0).any())
    assert torch.equal(dd.depthwise_dilated(x, w, rate, (rate, rate), b,
                                            relu), got)
    assert torch.equal(dd.depthwise_dilated_plain(x, w, rate, (rate, rate)),
                       F.conv2d(x, w.permute(2, 3, 0, 1),
                                padding=(rate, rate), dilation=rate,
                                groups=12))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("rate", [1, 2])
def test_depthwise_conv2d_bias_routes_and_flags_its_epilogue(rate, relu):
    """``layers.depthwise_conv2d_bias`` hands a dilated bf16 convolution
    its bias and ReLU in the kernel's epilogue (here its plain version)
    and says so; rate 1 adds them as passes after ``F.conv2d``, the f32
    bias to the bf16 output rounded once."""
    x = torch.randn(2, 16, 13, 15)
    w, b = torch.randn(3, 3, 16, 1) * 0.5, torch.randn(16)
    y, fused = layers.depthwise_conv2d_bias(x, w, b, rate=rate,
                                            compute_dtype=torch.bfloat16,
                                            relu=relu)
    assert fused is (rate > 1)
    xb = x.to(torch.bfloat16, memory_format=torch.channels_last)
    wb = w.to(torch.bfloat16)
    if fused:
        want = dd.depthwise_dilated_plain(xb, wb, rate, (rate, rate), b,
                                          relu)
    else:
        want = (layers.depthwise_conv2d(xb, wb, rate=rate).float()
                + b[:, None, None]).to(torch.bfloat16)
        want = torch.relu(want) if relu else want
    assert torch.equal(y, want)


# --- routing ---------------------------------------------------------------

def _route(x, w, *, stride=1, rate=2, padding="SAME",
           compute_dtype=torch.bfloat16):
    """What ``depthwise_conv2d`` asks ``takes_dilated_kernel``, after its
    ``_cast`` and ``_pad``."""
    x, w = layers._cast(x, w, compute_dtype)
    x, pad = layers._pad(x, w.shape[0], w.shape[1], stride, rate, padding)
    return layers.takes_dilated_kernel(x, w, stride, rate, pad)


def _x(c=16, h=17, w=19):
    return torch.randn(2, c, h, w)


@pytest.mark.parametrize("case,expect", [
    ("bf16_rate2", True),
    ("bf16_rate36", True),
    ("width_shard_pads", True),
    ("no_grad_with_requires_grad", True),
    ("rate1", False),
    ("stride2", False),
    ("float32", False),
    ("keeps_dtype_f32", False),
    ("video_batched", False),
    ("grad_with_requires_grad", False),
    ("weight_requires_grad", False),
    ("channels_12", True),
    ("odd_channels", False),
    ("asymmetric_padding", False),
    ("kernel_5x5", False),
    ("nchw_bf16", False),
])
def test_routing_picks_the_kernel_exactly_where_listed(case, expect):
    x, w = _x(), torch.randn(3, 3, 16, 1)
    kw = {}
    if case == "bf16_rate36":
        kw["rate"] = 36
    elif case == "width_shard_pads":
        kw["padding"] = ((2, 2), (0, 0))
    elif case == "rate1":
        kw["rate"] = 1
    elif case == "stride2":
        kw["stride"] = 2
    elif case == "float32":
        kw["compute_dtype"] = torch.float32
    elif case == "keeps_dtype_f32":
        kw["compute_dtype"] = None
    elif case == "channels_12":
        x, w = _x(c=12), torch.randn(3, 3, 12, 1)
    elif case == "odd_channels":
        x, w = _x(c=15), torch.randn(3, 3, 15, 1)
    elif case == "asymmetric_padding":
        kw["padding"] = ((2, 3), (2, 2))
    elif case == "kernel_5x5":
        w = torch.randn(5, 5, 16, 1)
    elif case == "nchw_bf16":
        x = x.to(torch.bfloat16)
        kw["compute_dtype"] = None
    if case == "video_batched":
        with layers.video_batched():
            assert _route(x, w, **kw) is expect
        return
    if case in ("grad_with_requires_grad", "no_grad_with_requires_grad"):
        x.requires_grad_(True)
    if case == "weight_requires_grad":
        w.requires_grad_(True)
    if case == "no_grad_with_requires_grad":
        with torch.no_grad():
            assert _route(x, w, **kw) is expect
        return
    assert _route(x, w, **kw) is expect


@pytest.mark.parametrize("rate", [1, 2, 12])
def test_cpu_tensor_never_launches(rate):
    """A CPU input that the predicate takes still runs F.conv2d: no
    launch, no count; the result is the plain version's."""
    x, w = _x(), torch.randn(3, 3, 16, 1)
    launches = build.launch_count("depthwise_dilated")
    counted = GLOBAL_TIMER.counts.get(COUNTER, 0)
    y = layers.depthwise_conv2d(x, w, rate=rate,
                                compute_dtype=torch.bfloat16)
    assert build.launch_count("depthwise_dilated") == launches
    assert GLOBAL_TIMER.counts.get(COUNTER, 0) == counted
    xb = x.to(torch.bfloat16, memory_format=torch.channels_last)
    assert torch.equal(y, dd.depthwise_dilated_plain(
        xb, w.to(torch.bfloat16), rate, (rate, rate)))


# --- the wrapper's contract ------------------------------------------------

def _bad(case):
    x, w = _input((2, 16, 11, 13), 0), _weight(16, 0).to(torch.bfloat16)
    rate, padding = 2, (2, 2)
    if case == "float32_input":
        x = x.float()
    elif case == "float32_weight":
        w = w.float()
    elif case == "nchw":
        x = x.contiguous()
    elif case == "sliced_columns":
        x = x[:, :, :, 1:]
    elif case == "odd_channels":
        x, w = _input((2, 13, 11, 13), 0), w[:, :, :13]
    elif case == "weight_5x5":
        w = torch.zeros((5, 5, 16, 1), dtype=torch.bfloat16)
    elif case == "weight_channels":
        w = w[:, :, :8]
    elif case == "three_dims":
        x = x[0]
    elif case == "rate_0":
        rate = 0
    elif case == "rate_256":
        rate = 256
    elif case == "rate_float":
        rate = 2.0
    elif case == "padding_negative":
        padding = (2, -1)
    elif case == "padding_three":
        padding = (2, 2, 2)
    elif case == "empty_output":
        padding = (0, 0)
        x = _input((2, 16, 4, 13), 0)
    elif case == "meta_device":
        x, w = x.to("meta"), w.to("meta")
    bias = None
    if case == "bias_bf16":
        bias = torch.zeros(16, dtype=torch.bfloat16)
    elif case == "bias_channels":
        bias = torch.zeros(8)
    elif case == "bias_meta":
        bias = torch.zeros(16, device="meta")
    return x, w, rate, padding, bias, case == "relu_without_bias"


@pytest.mark.parametrize("case", [
    "float32_input", "float32_weight", "nchw", "sliced_columns",
    "odd_channels", "weight_5x5", "weight_channels", "three_dims", "rate_0",
    "rate_256", "rate_float", "padding_negative", "padding_three",
    "empty_output", "meta_device", "bias_bf16", "bias_channels",
    "bias_meta", "relu_without_bias"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    x, w, rate, padding, bias, relu = _bad(case)
    with pytest.raises((ValueError, TypeError)):
        dd.depthwise_dilated(x, w, rate, padding, bias, relu)


# --- the kernel's arithmetic, emulated --------------------------------------

def emulate_kernel(x, w, rate, padding, cols, strips, strip_rows):
    """``csrc/depthwise_dilated.cu`` in torch: per (image, sub-lattice,
    row strip, column group) the thread's column offsets and mask, its
    rows m (iy = py - ph + r m) read only inside the input and below the
    strip's end + 2, and each output as the nine f32 products summed in
    the kernel's order (ky-major).  -> (output, writes per output)."""
    n_img, c, h, wd = x.shape
    ph, pw = padding
    r = rate
    ho, wo = h + 2 * ph - 2 * r, wd + 2 * pw - 2 * r
    xf = x.float().permute(0, 2, 3, 1)
    k = w.float().reshape(9, c)
    out = torch.full((n_img, ho, wo, c), float("nan"))
    writes = torch.zeros((n_img, ho, wo), dtype=torch.int64)
    groups = -(-(-(-wo // r)) // cols)
    for n in range(n_img):
        for py in range(r):
            for px in range(r):
                hs, ws = (ho - py + r - 1) // r, (wo - px + r - 1) // r
                for strip in range(strips):
                    i0 = strip * strip_rows
                    i1 = min(hs, i0 + strip_rows)
                    for g in range(groups):
                        j0 = g * cols
                        if j0 >= ws or i0 >= i1:
                            continue
                        ixs = [px - pw + r * (j0 + q) for q in range(cols + 2)]

                        def row(m):
                            iy = py - ph + r * m
                            vals = torch.zeros((cols + 2, c))
                            if m < i1 + 2 and 0 <= iy < h:
                                for q, ix in enumerate(ixs):
                                    if 0 <= ix < wd:
                                        vals[q] = xf[n, iy, ix]
                            return vals

                        for i in range(i0, i1):
                            rows = [row(i + ky) for ky in range(3)]
                            for jj in range(min(cols, ws - j0)):
                                acc = torch.zeros(c)
                                for ky in range(3):
                                    for kx in range(3):
                                        acc = acc + k[3 * ky + kx] \
                                            * rows[ky][jj + kx]
                                oy, ox = py + r * i, px + r * (j0 + jj)
                                out[n, oy, ox] = acc
                                writes[n, oy, ox] += 1
    return (out.to(torch.bfloat16).permute(0, 3, 1, 2)
            .contiguous(memory_format=torch.channels_last), writes)


@pytest.mark.parametrize("shape,rate,padding,strips,rows", [
    ((1, 8, 13, 17), 2, (2, 2), 1, 7),
    ((2, 8, 11, 23), 3, (3, 3), 1, 4),
    ((1, 16, 17, 19), 2, (2, 0), 3, 3),
    ((1, 8, 9, 29), 4, (4, 4), 2, 2),
    ((1, 8, 14, 15), 5, (5, 5), 1, 3),
    ((1, 8, 12, 12), 2, (1, 3), 3, 2),
    ((1, 8, 10, 11), 1, (1, 1), 2, 5),
    ((1, 6, 13, 11), 3, (3, 3), 2, 3),
])
def test_kernel_arithmetic_covers_each_output_once(shape, rate, padding,
                                                   strips, rows):
    x, w = _input(shape, rate), _weight(shape[1], rate).to(torch.bfloat16)
    got, writes = emulate_kernel(x, w, rate, padding, dd.COLS, strips, rows)
    assert bool((writes == 1).all())
    want = dd.depthwise_dilated_plain(x, w, rate, padding)
    assert got.shape == want.shape
    _agree(got, want, x, w, rate, padding)


# --- the plan ---------------------------------------------------------------

def test_plan_fills_the_card_at_the_smallest_routed_shape():
    """The student's 16x960x32x64 at rate 2 fills an H100 (132 SMs, five
    blocks each) without cutting rows; a small input is cut into strips
    of at least MIN_STRIP_ROWS rows that cover every row once."""
    plan = dd.depthwise_dilated_plan(16, 960, 32, 64, 2, 132)
    assert plan.strips == 1 and plan.blocks >= 132 * dd.RESIDENT_BLOCKS
    small = dd.depthwise_dilated_plan(1, 64, 200, 40, 2, 132)
    hs = 100
    assert small.strips > 1 and small.strip_rows >= dd.MIN_STRIP_ROWS
    assert (small.strips - 1) * small.strip_rows < hs \
        <= small.strips * small.strip_rows


# --- the smoke run's expected launches ----------------------------------------

def _routed_calls(monkeypatch):
    """Count the ``depthwise_conv2d`` calls the kernel would take on the
    card, on CPU tensors: the routing predicate asked whatever the
    device."""
    routed = layers.depthwise_conv2d
    hits = [0]

    def counting(x, w, stride=1, rate=1, padding="SAME", *,
                 compute_dtype=None):
        if not isinstance(x, layers.spatial.WidthShards):
            xx, ww = layers._cast(x, w, compute_dtype)
            xx, pad = layers._pad(xx, ww.shape[0], ww.shape[1], stride, rate,
                                  padding)
            hits[0] += layers.takes_dilated_kernel(xx, ww, stride, rate, pad)
        return routed(x, w, stride, rate, padding,
                      compute_dtype=compute_dtype)

    monkeypatch.setattr(layers, "depthwise_conv2d", counting)
    return hits


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("fused", [False, True, "banded"])
def test_smoke_expects_the_student_launches_the_routing_gives(monkeypatch,
                                                               fused):
    """chip_smoke's ``expected_dw_launches`` against the routes a bf16
    folded student forward takes: the three rate-2 blocks, unless K3 or
    K4 fuses them."""
    from ams_tpu_torch.models import frozen
    from ams_tpu_torch.models import mobilenetv2_deeplab as sm

    folded = frozen.fold_student(sm.init_student_params(0, device="cpu"))
    frames = torch.randint(0, 256, (1, 64, 128, 3), dtype=torch.uint8)
    hits = _routed_calls(monkeypatch)
    with torch.inference_mode():
        frozen._grid_logits_folded_nchw(folded, frames, torch.bfloat16, fused)
    want = _chip_smoke().expected_dw_launches(64, 128, fused)
    assert hits[0] == want
    assert want == (0 if fused is True else 3)


def test_smoke_expects_the_os16_teacher_launches_the_routing_gives(
        monkeypatch):
    from ams_tpu_torch.models import xception_deeplab as xd

    params = xd.init_teacher_params(0, device="cpu")
    frames = torch.randint(0, 256, (1, 65, 129, 3), dtype=torch.uint8)
    hits = _routed_calls(monkeypatch)
    with torch.inference_mode():
        xd.teacher_predict_fast(params, frames)
    assert hits[0] == _chip_smoke().DW_TEACHER_OS16 == 6


# --- on the card --------------------------------------------------------------

CELL_SHAPES = [   # (n, c, h, w, rate): every dilated depthwise of the cells
    (8, 728, 129, 257, 2), (8, 1024, 129, 257, 2),
    (8, 1024, 129, 257, 4), (8, 1536, 129, 257, 4),
    (8, 2048, 129, 257, 12), (8, 2048, 129, 257, 24),
    (8, 2048, 129, 257, 36),
    (16, 1024, 33, 65, 2), (16, 1536, 33, 65, 2),
    (16, 2048, 33, 65, 6), (16, 2048, 33, 65, 12), (16, 2048, 33, 65, 18),
    (16, 960, 32, 64, 2),
]


STRIP_SHAPES = [   # batch 1, where the plan cuts rows into strips
    (1, 1024, 33, 65, 2), (1, 960, 32, 64, 2),
    (1, 12, 97, 70, 3),   # channels not a multiple of 8, a short last strip
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dilated depthwise kernel is "
                    "CUDA only")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=["x".join(map(str, s)) for s in CELL_SHAPES])
def test_kernel_within_an_ulp_of_cudnn(shape):
    _need_card()
    n, c, h, wd, rate = shape
    x = _input((n, c, h, wd), rate, "cuda")
    w = _weight(c, rate, "cuda").to(torch.bfloat16)
    launches = build.launch_count("depthwise_dilated")
    for padding in ((rate, rate), (rate, 0)):
        got = dd.depthwise_dilated(x, w, rate, padding)
        want = dd.depthwise_dilated_plain(x, w, rate, padding)
        torch.cuda.synchronize()
        assert got.is_contiguous(memory_format=torch.channels_last)
        _agree(got, want, x, w, rate, padding)
    assert build.launch_count("depthwise_dilated") == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES + STRIP_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in CELL_SHAPES + STRIP_SHAPES])
def test_bias_free_kernel_equals_cudnn_bit_for_bit(shape):
    """The instantiation without an epilogue is the kernel as it was:
    cuDNN's bits at every shape of the cells and the row strips."""
    _need_card()
    n, c, h, wd, rate = shape
    x = _input((n, c, h, wd), rate + 11, "cuda")
    w = _weight(c, rate + 11, "cuda").to(torch.bfloat16)
    got = dd.depthwise_dilated(x, w, rate, (rate, rate))
    want = dd.depthwise_dilated_plain(x, w, rate, (rate, rate))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["bias", "bias_relu"])
@pytest.mark.parametrize("shape", CELL_SHAPES + STRIP_SHAPES,
                         ids=["x".join(map(str, s))
                              for s in CELL_SHAPES + STRIP_SHAPES])
def test_epilogue_within_an_ulp_of_f32_rounded_once(shape, relu,
                                                    monkeypatch):
    """The bias (and ReLU) epilogue against the float32 convolution plus
    the bias (then the ReLU) rounded to bf16 once (the plain version,
    TF32 off), at both paddings; one launch and one count each."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    n, c, h, wd, rate = shape
    x = _input((n, c, h, wd), rate + 5, "cuda")
    w = _weight(c, rate + 5, "cuda").to(torch.bfloat16)
    b = _bias(c, rate + 5, "cuda")
    launches = build.launch_count("depthwise_dilated")
    counted = GLOBAL_TIMER.counts.get(COUNTER, 0)
    for padding in ((rate, rate), (rate, 0)):
        got = dd.depthwise_dilated(x, w, rate, padding, b, relu)
        want = dd.depthwise_dilated_plain(x, w, rate, padding, b, relu)
        torch.cuda.synchronize()
        assert got.is_contiguous(memory_format=torch.channels_last)
        _agree(got, want, x, w, rate, padding, b)
        if relu:
            assert bool((got >= 0).all())
    assert build.launch_count("depthwise_dilated") == launches + 2
    assert GLOBAL_TIMER.counts.get(COUNTER, 0) == counted + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STRIP_SHAPES,
                         ids=["x".join(map(str, s)) for s in STRIP_SHAPES])
def test_kernel_row_strips_within_an_ulp_of_cudnn(shape):
    _need_card()
    n, c, h, wd, rate = shape
    x = _input((n, c, h, wd), rate + 7, "cuda")
    w = _weight(c, rate + 7, "cuda").to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for padding in ((rate, rate), (rate, 0)):
        ho, wo = h + 2 * padding[0] - 2 * rate, wd + 2 * padding[1] - 2 * rate
        plan = dd.depthwise_dilated_plan(n, c, ho, wo, rate, sms)
        assert plan.strips > 1, plan
        got = dd.depthwise_dilated(x, w, rate, padding)
        want = dd.depthwise_dilated_plain(x, w, rate, padding)
        torch.cuda.synchronize()
        _agree(got, want, x, w, rate, padding)


def _frames(n, h, w, seed):
    """Seeded uint8 frames with structure: a few low-frequency sinusoids
    per channel plus noise (random pixels average out in the trunk)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((n, h, w, 3), 128.0, np.float32)
    for i in range(n):
        for ch in range(3):
            for _ in range(4):
                fy, fx = rng.uniform(0.5, 6, 2) / np.array([h, w])
                out[i, :, :, ch] += rng.uniform(20, 60) * np.sin(
                    2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
    out += rng.randn(*out.shape).astype(np.float32) * 8
    return np.clip(out, 0, 255).astype(np.uint8)


def _calibrated_os8(monkeypatch):
    """The OS8 teacher's seeded params on the card with BN statistics the
    batch moments of a float32 forward of two frames, so seeded weights
    give activations of a trained network's scale, and one chunk of 8
    padded 1025x2049 frames."""
    from ams_tpu_torch.models import xception_deeplab as xd

    config = xd.deeplab_teacher(8, 4)
    params = xd.init_teacher_params(0, device="cuda", config=config)
    frames = torch.from_numpy(_frames(8, 1025, 2049, 3)).cuda()
    infer = layers.batch_norm_infer

    def batch_moments(x, gamma, beta, mean, var, eps=layers.BN_EPS):
        mean.copy_(x.float().mean(dim=(0, 2, 3)))
        var.copy_(x.float().var(dim=(0, 2, 3)))
        return infer(x, gamma, beta, mean, var, eps)

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(layers, "batch_norm_infer", batch_moments)
        xd.teacher_logits_nchw(params, frames[:2], out_hw=None,
                               config=config)
    return config, params, frames


@pytest.mark.cuda
def test_os8_chunk_ids_match_the_cudnn_route(monkeypatch):
    """One chunk of 8 padded 1025x2049 frames through the OS8 teacher's
    fast path: 57 launches, and ids equal to the cuDNN route's on 99.9%
    of pixels (the 57 convolutions round within an ulp of cuDNN's, and
    the difference reaches a pixel's argmax only at near-ties)."""
    _need_card()
    from ams_tpu_torch.models import xception_deeplab as xd

    config, params, frames = _calibrated_os8(monkeypatch)
    with torch.inference_mode():
        launches = build.launch_count("depthwise_dilated")
        counted = GLOBAL_TIMER.counts.get(COUNTER, 0)
        ids = xd.teacher_predict_fast(params, frames, config=config)
        torch.cuda.synchronize()
        assert build.launch_count("depthwise_dilated") == launches + 57
        assert GLOBAL_TIMER.counts.get(COUNTER, 0) == counted + 57
        with monkeypatch.context() as m:
            m.setattr(layers, "takes_dilated_kernel", lambda *a: False)
            ref = xd.teacher_predict_fast(params, frames, config=config)
        assert build.launch_count("depthwise_dilated") == launches + 57
    agree = (ids == ref).float().mean().item()
    assert agree >= 0.999, agree
    assert len(torch.unique(ref)) > 1


@pytest.mark.cuda
def test_os8_chunk_folded_ids_match_the_unfused_route(monkeypatch):
    """The labeler's route, BN folded in bf16 (``fold_teacher``), on one
    OS8 chunk of 8 padded 1025x2049 frames: still 57 launches, 131
    offsets in epilogues and 15 as passes, and on the two frames held
    against the float32 forward, ids equal to the unfused bf16 route's
    and to the float32 argmax on 99% of the pixels whose float32 top-two
    margin exceeds 1% of max|logit| (the bar of the port's bf16 tests,
    off the near-ties either bf16 route can flip).  Weights and BN
    statistics are the benchmark's (``perfbench``: offsets U(1, 2),
    statistics calibrated by its reference): with zero offsets, as in
    ``_calibrated_os8``, a deep random network amplifies rounding from
    layer to layer until every bf16 route, folded or not, agrees with the
    float32 argmax on about a quarter of those pixels."""
    _need_card()
    from ams_tpu_torch.models import xception_deeplab as xd
    from perfbench.entries.labeler import pad_like_ams
    from perfbench.lib import frames as bench_frames
    from perfbench.lib import weights
    from perfbench.reference import teacher_v3plus as ref

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    config = xd.DEEPLABV3PLUS_OS8
    params = weights.init(ref.param_specs(), 11, "cuda")
    ref.calibrate(params, pad_like_ams(bench_frames.frames(
        4, 1024, 2048, 12, "cuda")), output_stride=8)
    frames = pad_like_ams(bench_frames.frames(8, 1024, 2048, 13, "cuda"))
    folded = xd.fold_teacher(params, torch.bfloat16)
    with torch.inference_mode():
        ref_ids = xd.teacher_predict_fast(params, frames, config=config)
        launches = build.launch_count("depthwise_dilated")
        before = dict(GLOBAL_TIMER.counts)
        ids = xd.teacher_predict_fast(folded, frames, config=config)
        torch.cuda.synchronize()
        assert build.launch_count("depthwise_dilated") == launches + 57
        for name, want in (("teacher/bn_epilogue", 131),
                           ("teacher/bn_pass", 15), (COUNTER, 57)):
            assert GLOBAL_TIMER.counts.get(name, 0) - before.get(name, 0) \
                == want, name
        f32 = xd.teacher_logits_nchw(params, frames[:2], config=config)
    top2 = f32.topk(2, dim=1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 0.01 * f32.abs().max()
    assert decisive.float().mean().item() > 0.5
    assert len(torch.unique(ref_ids)) > 1
    agree = (ids[:2] == ref_ids[:2])[decisive].float().mean().item()
    assert agree >= 0.99, agree
    truth = (ids[:2] == f32.argmax(1))[decisive].float().mean().item()
    assert truth >= 0.99, truth
