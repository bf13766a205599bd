"""Trainer set-up from a config (counterpart of the part of the JAX
package's `apis/train.py:train_detector` that builds the model, the
optimizer spec and the train step).

`init_trainer(config)` → `Trainer(model, state, step, optimizer, spec, cfg,
device)`;
`trainer.step(trainer.state, batch)` runs one step. The dataset, the
two-stream loader, checkpoints, evaluation and the command-line tool are
not ported yet: the caller brings the batches (the padded dict of
`FasterRCNN.loss`).
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Union

import torch

from ..models.builder import build_detector
from ..models.weight_init import init_random_weights_
from ..utils.config import Config
from ..utils.convert import load_jax_variables
from ..utils.device import resolve_device
from .train_state import (OptimizerSpec, TrainState, _FusedSGD,
                          create_train_state, make_train_step)

# detector types whose adversarial game gets the NaN guard by default
_ADVERSARIAL = {'DAFasterRCNN', 'DAFasterRCNN_Org', 'MAFasterRCNN',
                'FasterRCNN_SWDA', 'DAFasterRCNN_Deep', 'DAFasterRCNN_Tri',
                'CyDAFasterRCNN', 'CyCADA'}


class Trainer(NamedTuple):
    model: torch.nn.Module
    state: TrainState
    step: Callable
    optimizer: _FusedSGD
    spec: OptimizerSpec
    cfg: Config
    device: torch.device


def resolve_runner(runner_cfg, lr_cfg, steps_per_epoch: Optional[int]):
    """(iter_based, epochs, max_iters or None, milestones in steps) from the
    runner block; `lr_config.step` counts epochs for the epoch-based runner
    and steps for the iteration-based one. The epoch-based runner (and
    `warmup_by_epoch`) needs `steps_per_epoch`, the length of the loader:
    without it raises."""
    iter_based = 'Iter' in str(runner_cfg.get('type', ''))
    if steps_per_epoch is None and (not iter_based
                                    or lr_cfg.get('warmup_by_epoch')):
        raise ValueError('this config counts its schedule in epochs: pass '
                         'steps_per_epoch, the number of steps in an epoch')
    if iter_based:
        max_iters = int(runner_cfg.get('max_iters', 90000))
        epochs = -(-max_iters // steps_per_epoch) if steps_per_epoch else None
    else:
        max_iters = None
        epochs = runner_cfg.get('max_epochs', 12)
    step_cfg = lr_cfg.get('step', [])
    if isinstance(step_cfg, (int, float)):
        step_cfg = [step_cfg]
    milestones = tuple(int(m) * (1 if iter_based else steps_per_epoch)
                       for m in step_cfg)
    return iter_based, epochs, max_iters, milestones


def optimizer_spec(cfg: Config,
                   steps_per_epoch: Optional[int]) -> OptimizerSpec:
    """The optimizer spec of `optimizer`, `optimizer_config`, `lr_config`
    and `runner`, read as the JAX package reads them."""
    opt_cfg = cfg.get('optimizer', {}) or {}
    lr_cfg = cfg.get('lr_config', {}) or {}
    _, epochs, max_iters, milestones = resolve_runner(
        cfg.get('runner', {}) or {}, lr_cfg, steps_per_epoch)
    grad_clip = (cfg.get('optimizer_config', {}) or {}).get('grad_clip')
    if isinstance(grad_clip, dict):        # mmdet: dict(max_norm=35, ...)
        grad_clip = grad_clip.get('max_norm')
    warmup_iters = lr_cfg.get('warmup_iters', 500)
    if lr_cfg.get('warmup_by_epoch'):
        warmup_iters = int(warmup_iters) * steps_per_epoch
    return OptimizerSpec(
        lr=opt_cfg.get('lr', 1e-3),
        momentum=opt_cfg.get('momentum', 0.9),
        weight_decay=opt_cfg.get('weight_decay', 5e-4),
        warmup_iters=warmup_iters,
        warmup_ratio=lr_cfg.get('warmup_ratio', 1e-4),
        decay_steps=milestones,
        policy=str(lr_cfg.get('policy', 'step')).lower(),
        warmup=str(lr_cfg.get('warmup', 'linear') or 'constant').lower(),
        total_steps=max_iters or epochs * steps_per_epoch,
        grad_clip=grad_clip,
        opt_type=str(opt_cfg.get('type', 'SGD')).lower(),
        paramwise=opt_cfg.get('paramwise_cfg'))


def ema_momentum_of(cfg: Config) -> Optional[float]:
    """The EMA decay: `custom_hooks=[dict(type='ExpMomentumEMAHook',
    momentum=m)]` gives 1 − m (mmcv's m weighs the new value), a native
    `ema=dict(momentum=d)` block gives d; None without either."""
    momentum = None
    for hook in cfg.get('custom_hooks', []) or []:
        if 'EMA' in str(hook.get('type', '')):
            momentum = 1.0 - hook.get('momentum', 2e-4)
    if cfg.get('ema'):
        momentum = cfg['ema'].get('momentum', 0.9998)
    return momentum


def init_trainer(config: Union[str, Config],
                 variables: Optional[Mapping] = None,
                 device: Union[str, torch.device] = 'cuda',
                 seed: int = 0,
                 steps_per_epoch: Optional[int] = None) -> Trainer:
    """Build the config's detector on `device` (CUDA unless the caller asks
    for the CPU; raises without a card), with `variables` converted from
    the JAX package or seeded random weights, in train mode and with
    channels_last convolution weights; then its train state and step: SGD
    per the config, the stem and `backbone.frozen_stages` stages frozen,
    the EMA when the config asks for one, and the NaN guard by default for
    the adversarial detectors (`optimizer_config.nan_guard` overrides).
    `steps_per_epoch`, the loader's length, turns epoch milestones into
    steps; a config with the epoch-based runner raises without it."""
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    spec = optimizer_spec(cfg, steps_per_epoch)
    model = build_detector(cfg.model, device='meta')
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    if variables is not None:
        load_jax_variables(model, variables)
    else:
        init_random_weights_(
            model, torch.Generator(device=device).manual_seed(seed))
    model.train()

    frozen = cfg.model.get('backbone', {}).get('frozen_stages', 1)
    ema_momentum = ema_momentum_of(cfg)
    state, tx = create_train_state(model, spec, frozen_stages=frozen,
                                   ema=ema_momentum is not None)
    nan_guard = bool((cfg.get('optimizer_config', {}) or {}).get(
        'nan_guard', cfg.model.get('type', '') in _ADVERSARIAL))
    step = make_train_step(model, tx, skip_nonfinite=nan_guard,
                           ema_momentum=ema_momentum)
    return Trainer(model, state, step, tx, spec, cfg, device)
