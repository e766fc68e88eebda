"""Sums over the ranks of a ``torch.distributed`` process group.

The JAX package's minibatch-parallel round is one GSPMD program: XLA
inserts the psums that BN's batch moments and the loss's mean need.  The
port runs one process per rank, and the model code takes a ``SumReducer``
where a batch reduction may span ranks (``layers.batch_norm_train``,
``loss.masked_mean``, the fused loss): ``reduce(x)`` is the sum of ``x``
over the ranks, differentiable.  Its backward is the sum of the incoming
gradients over the ranks, the transpose of the forward: when every rank
backpropagates its copy of the replicated loss with the seed 1/world,
each rank holds the gradient with respect to its own replica of the
parameters, and summing those over the ranks (``sum_tensors``) gives the
gradient of the global loss.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class SumReducer:
    """Sums over the ranks of ``group`` (the default group if None), which
    must be initialized.  ``world`` and ``rank`` are this process's place
    in it."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "SumReducer needs an initialized torch.distributed process "
                "group (parallel.init_multi_host)")
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; differentiable."""
        return _AllReduceSum.apply(x, self.group)

    def sum_tensors(self, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, in one all-reduce of their
        concatenation (all of one dtype and device); not differentiable."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [part.view_as(t) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]
