"""Torch-native checkpoints of the train state (counterpart of the JAX
package's `utils/checkpoint.py`, whose orbax format the port cannot read).

A checkpoint is a directory `ckpt_<tag>` holding

- `state.pt`, one `torch.save` of a dict of tensors and ints: `params` and
  `buffers` (the model's state dict split in two; the buffers carry the
  frozen BN and the DA heads' BatchNorm statistics), `momentum` (SGD's
  momentum or Adam's first moment, of the trainable parameters; for the
  CycleGAN detectors' two optimizers, both groups' buffers under their
  parameters' names, which do not overlap), `nu` (Adam's second moment,
  None for SGD), `ema_params` (or None), `step` and `opt_count` (the
  optimizers' step count; the two groups count together);
- `graft_meta.json`, `{"epoch": ..., "classes": [...]}`, as the JAX package
  writes it.

It loads with `torch.load(weights_only=True)`: plain tensors, no pickled
code.

`load_pretrained_backbone(model, path)` loads a classification
checkpoint of the reference's trunks into the detector's trunk, as the
JAX package's does: the official Swin layout (`convert_torch_swin`) or a
torchvision ResNet (`convert_torch_resnet`), picked by its keys
(`detect_and_convert`); the PVT and pycls RegNet layouts raise, since the
port has neither trunk. The converters give the JAX package's variable
tree, which `utils/convert.py` maps onto the port's names.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from .convert import _convert_leaf, _leaves

STATE_FILE = 'state.pt'
META_FILE = 'graft_meta.json'


def train_state_dict(model: nn.Module, state) -> Dict:
    """The checkpoint payload of a `TrainState` over `model`."""
    # imported here: `apis` imports this module
    from ..apis.train_state import optimizer_states
    params = {n: p.detach() for n, p in state.params.items()}
    opts = optimizer_states(state.opt_state)
    if len({o.count for o in opts}) != 1:
        raise ValueError(f'optimizer counts differ: {[o.count for o in opts]}')
    return dict(
        step=int(state.step),
        params=params,
        buffers={n: b for n, b in model.state_dict().items()
                 if n not in params},
        momentum={n: m for o in opts for n, m in o.momentum.items()},
        nu={n: v for o in opts for n, v in o.nu.items()}
        if hasattr(opts[0], 'nu') else None,
        opt_count=int(opts[0].count),
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
    copied in place (parameters, buffers, momentum and Adam's second
    moment, EMA) and its step and optimizer count."""
    from ..apis.train_state import at_count, optimizer_states
    load_weights(model, ckpt, ema=False)
    opts = optimizer_states(state.opt_state)
    for field in ('momentum', 'nu'):
        mine = [getattr(o, field) for o in opts if hasattr(o, field)]
        saved = ckpt.get(field)
        if bool(mine) != (saved is not None) or set(
                n for m in mine for n in m) != set(saved or ()):
            raise KeyError(f'the checkpoint\'s {field} does not fit the '
                           'trainer\'s optimizer')
        for m in mine:
            for n, t in m.items():
                t.copy_(saved[n])
    ema = state.ema_params
    if ema is not None:
        if ckpt.get('ema_params') is None:
            raise KeyError('the trainer keeps an EMA, the checkpoint has none')
        for n, e in ema.items():
            e.copy_(ckpt['ema_params'][n])
    return state._replace(step=int(ckpt['step']), opt_state=at_count(
        state.opt_state, int(ckpt['opt_count'])))


# -- the reference's classification checkpoints ------------------------------

def _put(tree: Dict, keys, value):
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def convert_torch_resnet(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A torchvision ResNet state dict as the JAX package's variable tree
    (`{'conv1': {'kernel'}, 'layer1/0': {'conv1': ..., 'bn1': ...}}`,
    kernels OIHW → HWIO, BN statistics under `batch_stats`); `fc` drops."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, w in state_dict.items():
        w = np.asarray(w)
        parts = name.split('.')
        leaf = parts[-1]
        if parts[0] in ('conv1', 'bn1'):
            mod_path = [parts[0]]
        elif parts[0].startswith('layer'):
            sub = parts[2]
            if sub == 'downsample':
                sub = 'downsample_conv' if parts[3] == '0' else 'downsample_bn'
            mod_path = [f'{parts[0]}/{parts[1]}', sub]
        else:
            continue
        if 'bn' in mod_path[-1]:
            tree, key = {'weight': (params, 'scale'), 'bias': (params, 'bias'),
                         'running_mean': (stats, 'mean'),
                         'running_var': (stats, 'var')}.get(leaf, (None, None))
            if tree is not None:
                _put(tree, mod_path + [key], w)
        elif leaf == 'weight':
            _put(params, mod_path + ['kernel'], w.transpose(2, 3, 1, 0))
        elif leaf == 'bias':
            _put(params, mod_path + ['bias'], w)
    return dict(params=params, batch_stats=stats)


def _swin_merge_reorder(w: np.ndarray) -> np.ndarray:
    """The 4 patch-merging channel blocks from the official concat order
    (h0,w0), (h1,w0), (h0,w1), (h1,w1) to the trunk's dy-major one (h0,w0),
    (h0,w1), (h1,w0), (h1,w1)."""
    c4 = w.shape[-1]
    w = w.reshape(*w.shape[:-1], 4, c4 // 4)
    return w[..., [0, 2, 1, 3], :].reshape(*w.shape[:-2], c4)


def convert_torch_swin(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """An official (microsoft) Swin classification state dict as the JAX
    package's Swin variable tree: `patch_embed.proj` → `patch_embed`
    (OIHW → HWIO), `patch_embed.norm` → `patch_norm`,
    `layers.{i}.blocks.{j}` → `stage{i}/block{j}` (qkv, proj, mlp fc1/fc2
    transposed; `relative_position_bias_table` → `attn.rel_bias`),
    `layers.{i}.downsample.{norm,reduction}` → `merge_norm{i}` /
    `merge_reduce{i}` with the channel blocks reordered. The head and the
    final `norm` drop (the per-stage `out_norm{i}` stay as they are); the
    index and mask buffers are recomputed by the trunk."""
    params: Dict[str, Any] = {}

    def scale_or_bias(leaf):
        return 'scale' if leaf == 'weight' else 'bias'

    for name, w in state_dict.items():
        w = np.asarray(w)
        parts = name.split('.')
        if parts[0] == 'patch_embed':
            if parts[1] == 'proj':
                _put(params, ['patch_embed', 'kernel' if parts[2] == 'weight'
                              else 'bias'],
                     w.transpose(2, 3, 1, 0) if parts[2] == 'weight' else w)
            elif parts[1] == 'norm':
                _put(params, ['patch_norm', scale_or_bias(parts[2])], w)
            continue
        if parts[0] != 'layers':
            continue
        i = int(parts[1])
        if parts[2] == 'downsample':
            sub, leaf = parts[3], parts[4]
            if sub == 'norm':
                _put(params, [f'merge_norm{i}', scale_or_bias(leaf)],
                     _swin_merge_reorder(w))
            elif sub == 'reduction' and leaf == 'weight':
                _put(params, [f'merge_reduce{i}', 'kernel'],
                     _swin_merge_reorder(w).T)
            continue
        if parts[2] != 'blocks':
            continue
        blk = f'stage{i}/block{int(parts[3])}'
        sub, leaf = parts[4], parts[-1]
        if sub in ('norm1', 'norm2'):
            _put(params, [blk, sub, scale_or_bias(leaf)], w)
        elif sub == 'attn':
            a = parts[5]
            if a == 'relative_position_bias_table':
                _put(params, [blk, 'attn', 'rel_bias'], w)
            elif a in ('qkv', 'proj'):
                _put(params, [blk, 'attn', a, 'kernel' if leaf == 'weight'
                              else 'bias'], w.T if leaf == 'weight' else w)
        elif sub == 'mlp':
            _put(params, [blk, f'mlp_{parts[5]}', 'kernel' if leaf == 'weight'
                          else 'bias'], w.T if leaf == 'weight' else w)
    return dict(params=params, batch_stats={})


def detect_and_convert(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Route a torch state dict to its converter by its keys, as the JAX
    package does; the PVT and pycls RegNet layouts raise (the port has
    neither trunk)."""
    if any('relative_position_bias_table' in k for k in sd):
        return convert_torch_swin(sd)
    if any(k.startswith('patch_embed1.') for k in sd):
        raise NotImplementedError('a PVT checkpoint: the PVT trunk is not '
                                  'ported')
    if any(k.startswith('stem.') for k in sd):
        raise NotImplementedError('a pycls RegNet checkpoint: the RegNet '
                                  'trunk is not ported')
    return convert_torch_resnet(sd)


def read_pretrained_backbone(torch_ckpt_path: str) -> Dict[str, Any]:
    """A classification checkpoint (`.pth`, read with `weights_only=True`;
    unwrapped from `state_dict`, `model_state` or `model`) converted to the
    JAX package's variable tree (`detect_and_convert`)."""
    sd = torch.load(torch_ckpt_path, map_location='cpu', weights_only=True)
    for wrapper in ('state_dict', 'model_state', 'model'):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    return detect_and_convert({k: v.numpy() for k, v in sd.items()
                               if isinstance(v, torch.Tensor)})


@torch.no_grad()
def load_pretrained_backbone(model: nn.Module,
                             checkpoint: Union[str, Dict[str, Any]]
                             ) -> nn.Module:
    """Copy a classification checkpoint (a path, or the tree
    `read_pretrained_backbone` made of one) into `model`'s trunk
    (`model.backbone.trunk`, or `model.backbone` without one), in place. A
    converted leaf the trunk lacks, or whose shape differs, is skipped with
    a warning, as mmcv's non-strict load skips it."""
    converted = read_pretrained_backbone(checkpoint) \
        if isinstance(checkpoint, str) else checkpoint
    root = model.backbone
    root = getattr(root, 'trunk', root)
    target = root.state_dict()
    for collection, tree in converted.items():
        for path, leaf in _leaves(tree):
            key, value = _convert_leaf(collection, path, leaf)
            where = '/'.join(path)
            if key not in target:
                warnings.warn(
                    f'load_pretrained_backbone: skip missing {where}')
            elif tuple(target[key].shape) != value.shape:
                warnings.warn(f'load_pretrained_backbone: shape mismatch '
                              f'{where}: {tuple(target[key].shape)} vs '
                              f'{value.shape}')
            else:
                target[key].copy_(torch.from_numpy(np.ascontiguousarray(
                    value)).to(target[key].dtype))
    return model
