"""Carry a JAX-package variable tree into a port module.

`from_jax_variables(tree, model)` maps the flax collections `params` and
`batch_stats` (numpy leaves; any nested mapping) onto `model`'s state dict:

- conv `kernel` (kh, kw, I, O) → `weight` (O, I, kh, kw);
- Dense `kernel` (I, O) → `weight` (O, I). The first RoI FC keeps its rows
  as they are: port and JAX package both flatten RoI features x-major, so no
  permutation is needed;
- `bias` → `bias`; BatchNorm `scale`/`bias` (params) and `mean`/`var`
  (batch_stats) keep their names, for the trunk's frozen BN and the DA
  heads' live BN alike;
- the CycleGAN's instance norms' `scale`/`bias` keep their names;
- the Swin trunk's LayerNorm `scale`/`bias` keep their names;
- raw parameters keep their names and layouts: the normed mask
  predictor's `conv_logits_kernel` (C, K), MHSA's relative position
  terms `rel_h` (h, 1, c) and `rel_w` (1, w, c), and the Swin windows'
  relative position bias table `rel_bias` ((2ws−1)², heads).

Module paths join with '.', and flax names that contain '/' (`layer1/0`)
split there too, so `params/backbone/trunk/layer1/0/conv1/kernel` becomes
`backbone.trunk.layer1.0.conv1.weight` (and Swin's `stage0/block1`
becomes `stage0.block1`). Leaves with no counterpart in the
model are returned, not dropped silently; for every detector the port
has (each DA variant, CyDA and CyCADA, the Swin trunk included) there
are none.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(collection: str, path: Tuple[str, ...], leaf: Any
                  ) -> Tuple[Optional[str], np.ndarray]:
    """(state-dict key or None, converted array) for one flax leaf."""
    value = np.asarray(leaf)
    prefix = ''.join(p.replace('/', '.') + '.' for p in path[:-1])
    name = path[-1]
    if collection == 'params':
        if name == 'kernel' and value.ndim == 4:
            return f'{prefix}weight', value.transpose(3, 2, 0, 1)
        if name == 'kernel' and value.ndim == 2:
            return f'{prefix}weight', value.T
        if name in ('bias', 'scale', 'conv_logits_kernel', 'rel_h', 'rel_w',
                    'rel_bias'):
            return prefix + name, value
    elif collection == 'batch_stats' and name in ('mean', 'var'):
        return prefix + name, value
    return None, value


def from_jax_variables(tree: Mapping, model: nn.Module
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Returns (state_dict, unmapped): the converted tensors whose key and
    shape exist in `model`, and the '/'-joined paths of every leaf that has
    no counterpart there."""
    target = model.state_dict()
    state: Dict[str, torch.Tensor] = {}
    unmapped: List[str] = []
    for collection, sub in tree.items():
        for path, leaf in _leaves(sub):
            key, value = _convert_leaf(collection, path, leaf)
            if key is None or key not in target \
                    or tuple(target[key].shape) != value.shape:
                unmapped.append('/'.join((collection,) + path))
                continue
            state[key] = torch.from_numpy(np.array(value, copy=True))
    return state, unmapped


def load_jax_variables(model: nn.Module, tree: Mapping) -> List[str]:
    """Load a JAX-package variable tree into `model` (every parameter and
    buffer must be covered; raises otherwise). Returns the unmapped leaves."""
    state, unmapped = from_jax_variables(tree, model)
    model.load_state_dict(state, strict=True)
    return unmapped
