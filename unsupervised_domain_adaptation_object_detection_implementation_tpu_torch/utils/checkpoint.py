"""Torch-native checkpoints of the train state (counterpart of the JAX
package's `utils/checkpoint.py`, whose orbax format the port cannot read).

A checkpoint is a directory `ckpt_<tag>` holding

- `state.pt`, one `torch.save` of a dict of tensors and ints: `params` and
  `buffers` (the model's state dict split in two; the buffers carry the
  frozen BN and the DA heads' BatchNorm statistics), `momentum` (SGD's, of
  the trainable parameters), `ema_params` (or None), `step` and
  `opt_count`;
- `graft_meta.json`, `{"epoch": ..., "classes": [...]}`, as the JAX package
  writes it.

It loads with `torch.load(weights_only=True)`: plain tensors, no pickled
code.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Union

import torch
from torch import nn

STATE_FILE = 'state.pt'
META_FILE = 'graft_meta.json'


def train_state_dict(model: nn.Module, state) -> Dict:
    """The checkpoint payload of a `TrainState` over `model`."""
    params = {n: p.detach() for n, p in state.params.items()}
    return dict(
        step=int(state.step),
        params=params,
        buffers={n: b for n, b in model.state_dict().items()
                 if n not in params},
        momentum=dict(state.opt_state.momentum),
        opt_count=int(state.opt_state.count),
        ema_params=None if state.ema_params is None
        else dict(state.ema_params))


def save_checkpoint(path: str, payload: Dict, meta: Optional[Dict] = None):
    """Write `payload` (see `train_state_dict`) and `meta` into the
    directory `path`; the state file is written under a temporary name and
    renamed, so a cut run leaves no half-written checkpoint."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if meta is not None:
        with open(os.path.join(path, META_FILE), 'w') as f:
            json.dump(meta, f)


def load_checkpoint(path: str,
                    map_location: Union[str, torch.device] = 'cpu') -> Dict:
    """The payload saved in the directory `path`, its tensors on
    `map_location`."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def load_meta(path: str) -> Dict:
    """The checkpoint's `graft_meta.json` ({} without one)."""
    meta = os.path.join(path, META_FILE)
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The `ckpt_<n>` directory of `work_dir` with the largest n, or None."""
    if not os.path.isdir(work_dir):
        return None
    ckpts = [d for d in os.listdir(work_dir) if re.fullmatch(r'ckpt_\d+', d)]
    if not ckpts:
        return None
    return os.path.join(work_dir, max(ckpts, key=lambda d: int(d[5:])))


@torch.no_grad()
def load_weights(model: nn.Module, ckpt: Dict, ema: bool = True):
    """Copy the checkpoint's parameters (its EMA ones when it has them and
    `ema`) and buffers into `model`, in place. Every name must match."""
    params = ckpt['ema_params'] if ema and ckpt.get('ema_params') is not None \
        else ckpt['params']
    state = dict(params, **ckpt['buffers'])
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f'checkpoint does not fit the model: missing '
                       f'{missing[:5]}, unexpected {unexpected[:5]}')


@torch.no_grad()
def restore_train_state(model: nn.Module, state, ckpt: Dict):
    """A `TrainState` over `model` with every tensor of the checkpoint
    copied in place (parameters, buffers, momentum, EMA) and its step and
    optimizer count."""
    load_weights(model, ckpt, ema=False)
    for n, m in state.opt_state.momentum.items():
        m.copy_(ckpt['momentum'][n])
    ema = state.ema_params
    if ema is not None:
        if ckpt.get('ema_params') is None:
            raise KeyError('the trainer keeps an EMA, the checkpoint has none')
        for n, e in ema.items():
            e.copy_(ckpt['ema_params'][n])
    return state._replace(
        step=int(ckpt['step']),
        opt_state=state.opt_state._replace(count=int(ckpt['opt_count'])))
