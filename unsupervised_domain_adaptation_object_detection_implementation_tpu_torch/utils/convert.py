"""Carry a JAX-package variable tree into a port module.

`from_jax_variables(tree, model)` maps the flax collections `params` and
`batch_stats` (numpy leaves; any nested mapping) onto `model`'s state dict:

- conv `kernel` (kh, kw, I, O) → `weight` (O, I, kh, kw);
- Dense `kernel` (I, O) → `weight` (O, I). The first RoI FC keeps its rows
  as they are: port and JAX package both flatten RoI features x-major, so no
  permutation is needed; so do the RoI-head variants' FCs over (y, x, C)
  flattened maps (Double-Head's `fc0`, the MaskIoU head's `fc0`), which the
  port feeds in that order;
- `bias` → `bias`; BatchNorm `scale`/`bias` (params) and `mean`/`var`
  (batch_stats) keep their names, for the trunk's frozen BN and the DA
  heads' live BN alike;
- the group norms' `scale`/`bias` (the CycleGAN's instance norms, Grid
  R-CNN's `gn<i>`) keep their names;
- the Swin trunk's LayerNorm `scale`/`bias` keep their names;
- raw parameters keep their names and layouts: the normed mask
  predictor's `conv_logits_kernel` (C, K), MHSA's relative position
  terms `rel_h` (h, 1, c) and `rel_w` (1, w, c), and the Swin windows'
  relative position bias table `rel_bias` ((2ws−1)², heads), and the
  Guided Anchoring and Cascade RPN adaptive convs' HWIO kernels
  `adapt_conv_w` / `s2_adapt_w` (kh, kw, C, Co), which the port's
  deformable conv takes as they are (bf16 at `dtype=bfloat16`, as the JAX
  package makes them), and the one-stage heads' per-level scalars
  `scale_{lvl}`;
- FCOS's deformable convs (`cls_conv3_dcn/kernel`, HWIO) become a conv's
  `weight`, as a conv kernel does (the port's `DeformConv` keeps its
  kernel as a conv does); their offset convs (`cls_conv3_offset`) are
  convs;
- 1-D conv `kernel` (k, I, O) (SABL's `reg_post_x` / `reg_post_y`) →
  `weight` (O, I, k); the stride-2 transposed convs `up_x` / `up_y`, flax
  `ConvTranspose` kernels (k, I, O) with `transpose_kernel=False`, which
  put x[i] · kernel[1 - j] at output 2i + j, → `ConvTranspose1d` weights
  (I, O, k) flipped along k (torch puts x[i] · weight[j] there).

Module paths join with '.', and flax names that contain '/' (`layer1/0`)
split there too, so `params/backbone/trunk/layer1/0/conv1/kernel` becomes
`backbone.trunk.layer1.0.conv1.weight` (and Swin's `stage0/block1`
becomes `stage0.block1`). The cascade family's per-stage heads keep the
JAX names as modules of their own (`bbox_head_0` … `bbox_head_2`,
`mask_head_<i>`), as do HTC's and SCNet's `semantic_head`, `glbctx_head`,
`relay_head` (its Dense rows stay in (y, x, C) order, the order the port
reads them in) and `scnet_mask_head`. Leaves with no counterpart in the
model are returned, not dropped silently; for every detector the port
has (each DA variant, CyDA and CyCADA, the Swin trunk, the cascade
family, the RoI-head variants' `DoubleBBoxHead`, `GridHead`,
`MaskIoUHead` and `PointHead`, the proposal-network family, the
one-stage core and the RetinaNet-derived heads with SABL's box head and
its cascade's `sabl_head_<i>` included) there are none.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import re

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
        if name == 'kernel' and value.ndim == 3 and \
                path[-2].startswith('up_'):
            # flax ConvTranspose (k, I, O): out[2i + j] = x[i] · k[1 - j]
            return f'{prefix}weight', np.ascontiguousarray(
                value.transpose(1, 2, 0)[..., ::-1])
        if name == 'kernel' and value.ndim == 3:
            return f'{prefix}weight', value.transpose(2, 1, 0)
        if name in ('bias', 'scale', 'conv_logits_kernel', 'rel_h', 'rel_w',
                    'rel_bias', 'adapt_conv_w', 's2_adapt_w') \
                or re.fullmatch(r'scale_\d+', name):
            return prefix + name, value
    elif collection == 'batch_stats' and name in ('mean', 'var'):
        return prefix + name, value
    return None, value


def _tensor(value: np.ndarray) -> torch.Tensor:
    """A torch copy of a numpy leaf; bfloat16 leaves (numpy has no such
    type of its own) pass through float32, exactly."""
    if value.dtype.name == 'bfloat16':
        return torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(value, copy=True))


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
            state[key] = _tensor(value)
    return state, unmapped


def load_jax_variables(model: nn.Module, tree: Mapping) -> List[str]:
    """Load a JAX-package variable tree into `model` (every parameter and
    buffer must be covered; raises otherwise). Returns the unmapped leaves."""
    state, unmapped = from_jax_variables(tree, model)
    model.load_state_dict(state, strict=True)
    return unmapped
