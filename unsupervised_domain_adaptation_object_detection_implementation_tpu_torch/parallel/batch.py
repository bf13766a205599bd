"""Global-batch semantics on the data axis.

The JAX mesh step is the single-device step on the global batch, so every
mean, normalizer, batch statistic and k-means in it runs over the rows of
all chips. Here each rank holds its rows of that batch, and the loss it
differentiates is its share of the global loss: the shares of the data
axis sum to the global loss, and their gradients, summed over the axis by
the train step, to its gradient. The helpers below give the modules that
couple rows their global form:

- `batch_total(count)`: a count or normalizer summed over the axis, with
  no gradient (a local numerator over it is the rank's share);
- `batch_mean(x)`: the mean over every row's elements of the global batch,
  as a local sum over the global count;
- `batch_moments(x, dims)`: E[x] and E[x²] over the global batch (live
  BatchNorm), through a summing all-reduce whose gradient is the summing
  all-reduce of the gradients;
- `gather_rows(x)`: the global batch's rows of `x` (an all-reduce into a
  zeroed buffer, so that the same code runs on NCCL and on gloo, which has
  no CUDA all-gather), whose gradient sends each rank the sum, over the
  axis, of every rank's gradient for its rows;
- `replicated()`: code that computes a term of the global batch on every
  rank alike (the grouped instance loss after `gather_rows`), inside which
  the helpers act as in one process; `replica_share(term)` is then the
  rank's share, term / ranks, so that the summed gradient counts it once;
- `draw_rows(draw, shape)`: a random draw of batch shape as this rank's
  rows of the global draw, so that an N-rank step draws what one process
  draws on the global batch (the generators are seeded alike on every
  rank);
- `Dropout`: `nn.Dropout` whose mask is this rank's rows of the global
  batch's mask.

Without an active layout (`parallel/mesh.py:use_layout`), or with one rank
on the data axis, each computes exactly what the single-process code
computes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Layout, active_data, use_layout


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient is the sum over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Rows of every rank of a group, in rank order, through an all-reduce
    into a zeroed buffer; the gradient of a rank's rows is the sum over the
    group of their gradients."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        buf = x.new_zeros((size * x.shape[0],) + tuple(x.shape[1:]))
        buf[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None, \
            None


def sum_over_data(tensors: Sequence[torch.Tensor], layout: Layout
                  ) -> List[torch.Tensor]:
    """New tensors: each of `tensors` summed over the layout's data axis,
    through one flat all-reduce per dtype (the train step's gradient and
    metric sums)."""
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=layout.data.group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data axis, differentiable (its gradient is
    summed likewise); `x` itself without data parallelism."""
    dp = active_data()
    if dp is None:
        return x
    return _AllReduceSum.apply(x, dp.group)


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """A count or normalizer of the local rows summed over the data axis,
    with no gradient; `x` itself without data parallelism."""
    dp = active_data()
    if dp is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=dp.group)
    return y


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The rank's share of the mean over the global batch of all elements
    of `x` (B local rows of equal shape on every rank): x.sum() / (numel ·
    ranks); `x.mean()` without data parallelism."""
    dp = active_data()
    if dp is None:
        return x.mean()
    return x.sum() / (x.numel() * dp.size)


def batch_moments(x: torch.Tensor, dims: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x²]) over `dims` of the global batch (dim 0 the rows),
    differentiable; `(x.mean(dims), (x·x).mean(dims))` without data
    parallelism."""
    dp = active_data()
    if dp is None:
        return x.mean(dims), (x * x).mean(dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    sums = _AllReduceSum.apply(torch.stack([x.sum(dims), (x * x).sum(dims)]),
                               dp.group)
    total = n * dp.size
    return sums[0] / total, sums[1] / total


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of `x` (dim 0), differentiable (see the
    module docstring); bool and integer tensors are gathered without
    gradient. `x` itself without data parallelism."""
    dp = active_data()
    if dp is None:
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.int32), dp.group, dp.size,
                                 dp.rank).bool()
    return _GatherRows.apply(x, dp.group, dp.size, dp.rank)


@contextlib.contextmanager
def replicated() -> Iterator[None]:
    """Code that every rank of the data axis runs alike on global tensors:
    the helpers act as in one process inside it."""
    with use_layout(None):
        yield


def data_parallel() -> bool:
    """Whether a layout with more than one rank on the data axis is
    active."""
    return active_data() is not None


def replica_share(term: torch.Tensor) -> torch.Tensor:
    """The rank's share of a term that every rank of the data axis computes
    alike: term / ranks; `term` itself without data parallelism."""
    dp = active_data()
    return term if dp is None else term / dp.size


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)`, or under data parallelism this rank's rows of
    `draw` of the global batch's shape (shape[0] local rows a rank)."""
    dp = active_data()
    shape = tuple(shape)
    if dp is None:
        return draw(shape)
    b = shape[0]
    full = draw((b * dp.size,) + shape[1:])
    return full[dp.rank * b:(dp.rank + 1) * b]


def _ones_in_layout_of(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Ones of x's shape with `rows` rows, dense in x's memory order
    (dim 0 outermost), so that a random draw over it maps the numbers onto
    elements as a draw over x's global batch would."""
    if x.dim() and x.stride(0) < max(x.stride()):
        raise ValueError('the rows of a data-parallel dropout input must be '
                         'its outermost dimension')
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    shape = (rows,) + tuple(x.shape[1:])
    ones = x.new_ones([shape[d] for d in order])
    return ones.permute([order.index(d) for d in range(x.dim())])


class Dropout(nn.Dropout):
    """`nn.Dropout` whose mask under data parallelism is this rank's rows of
    the mask of the global batch (drawn from the default generator, which
    the loop seeds alike on every rank); `nn.Dropout` otherwise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dp = active_data()
        if dp is None or not self.training or self.p == 0.0:
            return super().forward(x)
        b = x.shape[0]
        mask = nn.functional.dropout(_ones_in_layout_of(x, b * dp.size),
                                     self.p, True)
        return x * mask[dp.rank * b:(dp.rank + 1) * b]
