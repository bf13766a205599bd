"""The (data, model) layout of the ranks (counterpart of the JAX package's
`parallel/mesh.py`).

The JAX package shards one program over a device mesh: the batch on the
`data` axis, the Megatron box-head pair on the `model` axis, everything
else replicated; each mesh step computes the single-device step on the
global batch. Here every rank is one process of `torch.distributed`, and
`Layout` arranges the default process group's ranks into the same grid,
model axis minor (rank = data_rank · model + model_rank, as the JAX mesh
puts TP pairs side by side), with one process group per data column and
one per model row.

A layout is active inside `use_layout(layout)`: the train step runs the
model there, and the global-batch helpers (`parallel/batch.py`) read the
active layout's data axis. With no active layout, or a data axis of one
rank, they compute what a single process computes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional

import torch.distributed as dist


class Axis(NamedTuple):
    """One axis of the layout as a rank sees it: its size, this rank's
    index on it and the process group of the ranks along it (the data
    axis always has one; a model axis of one rank has None)."""
    size: int
    rank: int
    group: Optional[dist.ProcessGroup]


class Layout(NamedTuple):
    """The ranks of the default process group as a (data, model) grid."""
    world: int
    rank: int
    data: Axis
    model: Axis


def make_layout(model: int = 1) -> Layout:
    """The layout of the initialised default process group with `model`
    ranks on the model axis (the tensor-parallel degree); the rest fill
    the data axis. Every rank must call it, in the same order as its other
    group creations: each rank creates every group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f'{world} ranks do not divide into model={model}')
    data = world // model
    data_rank, model_rank = divmod(rank, model)
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == model_rank:
            data_group = g
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == data_rank:
                model_group = g
    return Layout(world, rank, Axis(data, data_rank, data_group),
                  Axis(model, model_rank, model_group))


def mesh_shape(cfg, world: int) -> List[int]:
    """[data, model] of a config's `mesh = dict(data=-1, model=k)` block
    over `world` ranks (data=-1 fills; no block: data parallel over every
    rank). A block that does not tile `world` raises."""
    mesh_cfg = (cfg.get('mesh') if hasattr(cfg, 'get') else None) or {}
    model = int(mesh_cfg.get('model', 1))
    data = int(mesh_cfg.get('data', -1))
    if model < 1 or world % model:
        raise ValueError(f'mesh model={model} does not divide {world} ranks')
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f'mesh data={data} x model={model} is not the '
                         f'{world} ranks of the process group')
    return [data, model]


def mesh_from_cfg(cfg) -> Layout:
    """The layout of a config's `mesh` block over the initialised default
    process group (`mesh_shape`)."""
    return make_layout(mesh_shape(cfg, dist.get_world_size())[1])


_ACTIVE: List[Optional[Layout]] = [None]


@contextlib.contextmanager
def use_layout(layout: Optional[Layout]) -> Iterator[None]:
    """Make `layout` the active one for the duration (None: no layout, as
    a single process); the previous one comes back afterwards."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = layout
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def active_data() -> Optional[Axis]:
    """The active layout's data axis when it holds more than one rank,
    else None."""
    layout = _ACTIVE[0]
    if layout is None or layout.data.size == 1:
        return None
    return layout.data
