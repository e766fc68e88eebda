"""Width partitioning of activations over devices, in PyTorch.

The JAX package partitions the activation width of one network over the
mesh's ``model`` axis with GSPMD: XLA inserts each convolution's halo
exchange and the sums that BN's moments and the means over H and W need.
The port has no such compiler, so the exchanges are explicit here, and
the shards live in one process: a ``WidthShards`` holds one tensor per
device of the caller's mesh row, with each one's range of global columns.

- Each layer's output columns are split into balanced contiguous ranges
  (``balanced_ranges``; the first ranges take the remainder, so 33
  columns over 2 devices are 17 + 16).
- A convolution builds each shard's input as a *column window*
  (``WidthShards.window``): the global columns its output range reads,
  from whichever shards hold them, zero outside ``[0, W)``.  A halo wider
  than a neighbour's shard (ASPP's rate-18 branches on a 33-column grid)
  takes columns from every shard that holds them.
- Means over H and W are width-weighted sums of the shards' means
  (``mean``), on the row's first device.
- ``gather`` returns the whole tensor on the row's first device.

Slicing, ``torch.cat`` and ``Tensor.to(device)`` are differentiable, so
autograd gives every exchange its transpose: gradients of a window flow
back to the shards whose columns it copied, and gradients of weights used
on another device flow back to the first device's parameters.  No
``torch.distributed`` call is made per convolution: the ``data`` axis
alone spans processes (``parallel.collectives``).

Every helper also takes a plain tensor and then does what the unsharded
layer does, so the model code has one path for both.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

Range = Tuple[int, int]


def balanced_ranges(n: int, m: int) -> List[Range]:
    """``n`` columns over ``m`` shards as contiguous [lo, hi) ranges whose
    sizes differ by at most one, the larger first.  ``ValueError`` when a
    shard would be empty."""
    if m < 1 or n < m:
        raise ValueError("%d columns cannot be split over %d shards" % (n, m))
    base, extra = divmod(n, m)
    out, lo = [], 0
    for i in range(m):
        hi = lo + base + (i < extra)
        out.append((lo, hi))
        lo = hi
    return out


class WidthShards:
    """A tensor split along its width axis ``dim`` over devices.

    ``parts[i]`` holds global columns ``ranges[i]`` (contiguous, in order,
    covering ``[0, width)``) on its own device.  ``shape`` is the whole
    tensor's, so code that reads sizes (BN's element count, the loss's
    frame size) reads the global ones."""

    def __init__(self, parts: Sequence[torch.Tensor], ranges: Sequence[Range],
                 width: int, dim: int = 3):
        self.parts = list(parts)
        self.ranges = [tuple(r) for r in ranges]
        self.width = int(width)
        self.dim = dim
        if len(self.parts) != len(self.ranges) or not self.parts:
            raise ValueError("%d parts for %d ranges"
                             % (len(self.parts), len(self.ranges)))
        for p, (lo, hi) in zip(self.parts, self.ranges):
            if p.shape[dim] != hi - lo:
                raise ValueError("a part of width %d for columns [%d, %d)"
                                 % (p.shape[dim], lo, hi))

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.dim] = self.width
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The row's first device, where gathers and sums land."""
        return self.parts[0].device

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    def map(self, fn: Callable, dim: int = None) -> "WidthShards":
        """``fn`` on every part, which keeps its columns; ``dim`` is the
        width axis of the results (default: this one's)."""
        return WidthShards([fn(p) for p in self.parts], self.ranges,
                           self.width, self.dim if dim is None else dim)

    def __add__(self, other: "WidthShards") -> "WidthShards":
        if not isinstance(other, WidthShards) or other.ranges != self.ranges:
            raise ValueError("adding width shards of other column ranges")
        return WidthShards([a + b.to(a.device)
                            for a, b in zip(self.parts, other.parts)],
                           self.ranges, self.width, self.dim)

    def window(self, lo: int, hi: int, device: torch.device) -> torch.Tensor:
        """Global columns ``[lo, hi)`` on ``device``, taken from whichever
        parts hold them, zero where they fall outside ``[0, width)``."""
        for p, (a, b) in zip(self.parts, self.ranges):
            if (a, b) == (lo, hi) and p.device == device:
                return p
        pieces = []
        if lo < 0:
            pieces.append(self._zeros(min(hi, 0) - lo, device))
        for p, (a, b) in zip(self.parts, self.ranges):
            s, e = max(a, lo), min(b, hi)
            if s < e:
                pieces.append(p.narrow(self.dim, s - a, e - s).to(device))
        if hi > self.width:
            pieces.append(self._zeros(hi - max(lo, self.width), device))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                             self.dim)

    def _zeros(self, n: int, device) -> torch.Tensor:
        s = list(self.parts[0].shape)
        s[self.dim] = n
        return torch.zeros(s, dtype=self.dtype, device=device)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the row's first device."""
        dev = self.device
        return torch.cat([p.to(dev) for p in self.parts], self.dim)


def shard_width(x, devices: Sequence[torch.device], dim: int = 3):
    """``x`` split over ``devices`` in balanced column ranges of axis
    ``dim``; width shards are returned as they are."""
    if isinstance(x, WidthShards):
        return x
    ranges = balanced_ranges(x.shape[dim], len(devices))
    return WidthShards([x.narrow(dim, lo, hi - lo).to(d)
                        for (lo, hi), d in zip(ranges, devices)],
                       ranges, x.shape[dim], dim)


def apply(x, fn: Callable):
    """``fn(x)`` for a tensor; ``fn`` on every part of width shards."""
    return x.map(fn) if isinstance(x, WidthShards) else fn(x)


def gather(x) -> torch.Tensor:
    """The whole tensor (a tensor is returned as it is)."""
    return x.gather() if isinstance(x, WidthShards) else x


def conv_columns(x: WidthShards, k_eff: int, stride: int, left: int,
                 out_width: int, conv: Callable[[torch.Tensor],
                                                torch.Tensor]
                 ) -> WidthShards:
    """A convolution over width shards: output columns split in balanced
    ranges, shard i's from ``conv`` (unpadded in width) of its column
    window: output column j reads global input columns ``[j * stride -
    left, j * stride - left + k_eff)``, ``k_eff = (k - 1) * rate + 1``."""
    out_ranges = balanced_ranges(out_width, len(x.parts))
    parts = [conv(x.window(lo * stride - left,
                           (hi - 1) * stride - left + k_eff, dev))
             for (lo, hi), dev in zip(out_ranges, x.devices)]
    return WidthShards(parts, out_ranges, out_width, x.dim)


def mean(x, dims: Tuple[int, ...], keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)``; over width shards (``dims`` holding the width
    axis), the shards' means weighted by their column counts and summed
    on the first device."""
    if not isinstance(x, WidthShards):
        return x.mean(dim=dims, keepdim=keepdim)
    if x.dim not in dims:
        raise ValueError("a mean over width shards must reduce the width")
    dev = x.device
    total = None
    for p, (lo, hi) in zip(x.parts, x.ranges):
        term = p.mean(dim=dims, keepdim=keepdim).to(dev) * (
            (hi - lo) / x.width)
        total = term if total is None else total + term
    return total


def broadcast(x: torch.Tensor, like):
    """A (B, C, 1, 1) tensor expanded over ``like``'s height and width: a
    tensor, or width shards on ``like``'s devices and columns."""
    if not isinstance(like, WidthShards):
        return x.expand(x.shape[0], x.shape[1], like.shape[2], like.shape[3])
    return like.map(lambda p: x.to(p.device).expand(
        x.shape[0], x.shape[1], p.shape[2], p.shape[3]))


def cat_channels(xs: Sequence):
    """``torch.cat(xs, 1)``, part by part for width shards of the same
    columns."""
    if not isinstance(xs[0], WidthShards):
        return torch.cat(list(xs), dim=1)
    first = xs[0]
    if any(x.ranges != first.ranges for x in xs):
        raise ValueError("concatenating width shards of other column ranges")
    return WidthShards([torch.cat([x.parts[i] for x in xs], dim=1)
                        for i in range(len(first.parts))],
                       first.ranges, first.width, first.dim)
