"""Tensor parallelism of the Shared2FC box head on the model axis
(counterpart of the JAX package's `parallel/shardings.py`).

The Megatron split of the JAX rules (`_tp_spec`): `shared_fc1` is split by
its output columns, its bias with it; `shared_fc2` by its input rows, and
one all-reduce over the model axis sums the partial products before its
bias (which stays whole). Everything else is replicated. In torch's
(out, in) weight layout the first split is dim 0 of `shared_fc1.weight`
and `.bias`, the second dim 1 of `shared_fc2.weight`.

The same rule places the momentum, Adam's second moment and the EMA of a
split parameter: each holds exactly its parameter's shard (the JAX
`test_shard_train_state_momentum_follows_param`).

In the forward (`Shared2FCBBoxHead`), `copy_to_model_axis` is the identity
whose gradient is summed over the model axis (every shard's part of the
input gradient of `shared_fc1`), and `reduce_from_model_axis` the sum over
the model axis whose gradient passes unchanged: as `torch.autograd.Function`s
they run under the train step's `torch.autograd.grad`.

The JAX `fsdp_param_shardings` has no caller in the JAX loop and is not
ported (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Layout


def tp_split_dim(name: str, shape: Tuple[int, ...]) -> Optional[int]:
    """The dim of the port tensor `name` (a parameter's state-dict name,
    or the same name in the optimizer state or EMA) that the model axis
    splits, or None for a replicated one."""
    keys = name.split('.')
    if 'shared_fc1' in keys:
        if keys[-1] == 'weight' and len(shape) == 2:
            return 0
        if keys[-1] == 'bias' and len(shape) == 1:
            return 0
    if 'shared_fc2' in keys and keys[-1] == 'weight' and len(shape) == 2:
        return 1
    return None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, its gradient summed over the model axis."""
    return _CopyToModel.apply(x, group)


def reduce_from_model_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model axis, its gradient passed unchanged."""
    return _ReduceFromModel.apply(x, group)


def _shard(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    size = t.shape[dim]
    if size % layout.model.size:
        raise ValueError(f'a dim of {size} does not split over '
                         f'model={layout.model.size}')
    return t.chunk(layout.model.size, dim)[layout.model.rank].clone()


@torch.no_grad()
def shard_train_state_(model: nn.Module, state, optimizer, layout: Layout):
    """Split the box head's pair over the model axis in place: each split
    parameter keeps only this rank's shard (the same Parameter object, so
    `state.params` and the optimizers' names stay valid), and so do its
    momentum, second moment and EMA; the Shared2FC heads run their
    Megatron forward, and each optimizer's clip sums the split gradients'
    squares over the model axis. `optimizer` is a trainer's (one, or the
    GAN step's pair); `state` holds the one-device layout on entry (a
    fresh or restored state). A model axis of one rank changes nothing."""
    if layout.model.size == 1:
        return
    from ..apis.train_state import optimizer_states
    names = [n for n, p in state.params.items()
             if tp_split_dim(n, tuple(p.shape)) is not None]
    if not names:
        raise ValueError('a model axis needs a Shared2FC box head to split')
    for n in names:
        dim = tp_split_dim(n, tuple(state.params[n].shape))
        p = state.params[n]
        p.data = _shard(p.data, dim, layout)
        for opt in optimizer_states(state.opt_state):
            for moments in (opt.momentum, getattr(opt, 'nu', None)):
                if moments is not None and n in moments:
                    moments[n] = _shard(moments[n], dim, layout)
        if state.ema_params is not None:
            state.ema_params[n] = _shard(state.ema_params[n], dim, layout)
    for tx in optimizer if isinstance(optimizer, tuple) else (optimizer,):
        mine = frozenset(n for n in names if tx.trainable.get(n))
        tx.model_split = (mine, layout.model.group) if mine else None
    for m in model.modules():
        if hasattr(m, 'shared_fc1') and hasattr(m, 'shared_fc2'):
            m.model_group = layout.model.group


def _gather(t: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """The whole tensor of a shard, through an all-reduce into a zeroed
    buffer over the model axis."""
    shape = list(t.shape)
    shape[dim] *= layout.model.size
    full = t.new_zeros(shape)
    full.narrow(dim, layout.model.rank * t.shape[dim], t.shape[dim]).copy_(t)
    dist.all_reduce(full, group=layout.model.group)
    return full


@torch.no_grad()
def gather_payload(payload: Dict, layout: Optional[Layout]) -> Dict:
    """A checkpoint payload (`utils/checkpoint.py:train_state_dict`) with
    every split tensor gathered whole over the model axis: the one-device
    layout, which one process loads and serves. Every rank of the model
    axis calls it; without a model axis the payload is returned as is."""
    if layout is None or layout.model.size == 1:
        return payload
    out = dict(payload)
    for key in ('params', 'momentum', 'nu', 'ema_params'):
        tree = payload.get(key)
        if tree is None:
            continue
        tree = dict(tree)
        for n in sorted(tree):
            dim = tp_split_dim(n, tuple(tree[n].shape))
            if dim is not None:
                tree[n] = _gather(tree[n], dim, layout)
        out[key] = tree
    return out
