"""The yardstick's arithmetic: union-of-intervals busy time against hand
cases, the FLOP count of a small convolution stack against a hand count,
K1's bound, and the readers on a hand-made trace."""

import types

import pytest
import torch

from perfbench.counts import bounds, flops
from perfbench.lib import readers
from perfbench.lib.trace import Trace, union


@pytest.mark.parametrize("events,merged", [
    ([], []),
    ([("a", 0, 10)], [[0, 10]]),
    ([("a", 0, 10), ("b", 20, 30)], [[0, 10], [20, 30]]),
    ([("a", 0, 10), ("copy", 5, 15)], [[0, 15]]),          # overlap
    ([("a", 0, 30), ("b", 5, 10), ("c", 12, 20)], [[0, 30]]),  # nested
    ([("b", 10, 20), ("a", 0, 10)], [[0, 20]]),             # touching
    ([("c", 40, 50), ("a", 0, 10), ("b", 8, 12)], [[0, 12], [40, 50]]),
])
def test_union(events, merged):
    assert union(events) == merged


def test_trace_busy_is_the_union_not_the_sum():
    dev = [("kern_a", 0, 400_000_000), ("Memcpy HtoD", 100_000_000,
                                         300_000_000),
           ("kern_b", 600_000_000, 700_000_000)]
    t = Trace(dev, [("cudaStreamSynchronize", 450_000_000, 590_000_000)],
              window_s=1.0)
    assert t.busy_s == pytest.approx(0.5)
    assert t.seconds_where(lambda n: n.startswith("kern")) == \
        pytest.approx(0.5)
    assert t.seconds_where(lambda n: n.startswith("Memcpy")) == \
        pytest.approx(0.2)
    b = t.breakdown()
    assert b["device_ops"][0] == ["kern_a", pytest.approx(0.4)]
    assert b["idle_gaps"] == [["host in cudaStreamSynchronize",
                               pytest.approx(0.2)]]
    ctx = types.SimpleNamespace(trace_data=t)
    assert readers.idle_pct(ctx) == pytest.approx(50.0)


def test_gap_without_a_runtime_call_names_the_next_op():
    t = Trace([("a", 0, 10), ("b", 50, 60)], [], window_s=1e-7)
    assert t.breakdown()["idle_gaps"] == [["before b", pytest.approx(4e-8)]]


def test_elementwise_share():
    t = Trace([("void at::native::vectorized_elementwise_kernel<4>", 0, 30),
               ("void at::native::reduce_kernel<512, 1>", 30, 40),
               ("sm90_xmma_fprop_implicit_gemm_bf16", 40, 100)], [], 1e-7)
    ctx = types.SimpleNamespace(trace_data=t)
    assert readers.elementwise_pct(ctx) == pytest.approx(40.0)


def test_conv_stack_flops_against_a_hand_count():
    """3x3 conv 3->8 at stride 2, depthwise 3x3 on 8, 1x1 8->4, on a
    1x3x16x16 input that needs no gradient."""
    w1 = torch.empty(8, 3, 3, 3, device="meta", requires_grad=True)
    w2 = torch.empty(8, 1, 3, 3, device="meta", requires_grad=True)
    w3 = torch.empty(4, 8, 1, 1, device="meta", requires_grad=True)
    x = torch.empty(1, 3, 16, 16, device="meta")

    def forward():
        y = torch.nn.functional.conv2d(x, w1, stride=2, padding=1)
        y = torch.nn.functional.conv2d(y, w2, padding=1, groups=8)
        return torch.nn.functional.conv2d(y, w3)

    c1 = 2 * (8 * 8 * 8) * (3 * 9)      # 8x8 outputs of 8 channels
    c2 = 2 * (8 * 8 * 8) * 9            # depthwise: 9 taps each
    c3 = 2 * (4 * 8 * 8) * 8
    assert flops.count(forward) == c1 + c2 + c3

    def train():
        torch.autograd.grad(forward().sum(), [w1, w2, w3])

    # backward: the first conv only its weight gradient (x needs none),
    # the others both gradients, each the forward's multiply-adds
    assert flops.count(train) == (c1 + c2 + c3) + c1 + 2 * c2 + 2 * c3


def test_model_counts_are_stable():
    union = (0, 1, 2, 8, 10, 11, 13)
    one = flops.student_train(2, 64, 128, union)
    assert flops.student_train(4, 64, 128, union) == 2 * one
    fwd = flops.student_infer(2, 64, 128)
    assert 2 * fwd < one < 3.2 * fwd    # backward ~2x, stem without dgrad


def test_k1_bound():
    s, which = bounds.resize_argmax_bound_s(16, 19, 33, 65, 513, 1025, 2)
    nbytes = 16 * 19 * 33 * 65 * 2 + 16 * 513 * 1025 * 4 + (513 + 1025) * 12
    assert which == "bytes" and s == pytest.approx(nbytes / 3.35e12)
