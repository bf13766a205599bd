"""Train state, optimizers and the train step (counterpart of the JAX
package's `apis/train_state.py`).

One step: the detector's loss dict → the gradient of its sum → the fused
optimizer update (lr schedule, frozen mask, paramwise groups, optional
global-norm clip) → the optional NaN guard and EMA. The optimizers are the
JAX package's `make_optimizer`: SGD with momentum and coupled weight
decay (`_FusedSGD`), and Adam (L2 added to the gradient before the
moments) and AdamW (decoupled decay scaled by the scheduled lr) as
`optax.adam` / `optax.adamw` compute them (`_FusedAdam`).

Where the JAX state is an immutable tree, here the parameters are the
model's own `nn.Parameter`s, keyed by their state-dict names, and are
written in place; the batch statistics are the model's buffers, which the
forward updates. `TrainState.params` holds the same Parameter objects, so
after a step both show the new values. The optimizer's moments are updated
in place. Only the 'step' lr policy with linear warmup is ported; the
other policies and warmups raise.

The CycleGAN detectors train two parameter groups in one step
(`make_gan_train_step`): the discriminators (`disc_s`, `disc_t`) on the
`disc_*` loss terms, every other parameter on the rest, each group with
its own optimizer; `opt_state` is then the pair (main, discriminators).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple, Union)

import torch
from torch import nn
from torch.profiler import record_function

from ..models.detectors.cyda_faster_rcnn import DISC_KEYS
from .hooks import ema_update, guard_nonfinite_update


class TrainState(NamedTuple):
    step: int
    params: Dict[str, nn.Parameter]
    opt_state: Union['FusedSGDState', 'AdamState', Tuple]
    ema_params: Optional[Dict[str, torch.Tensor]] = None


class OptimizerSpec(NamedTuple):
    """The JAX package's spec, field for field (the reference's SGD
    lr=1e-3, momentum 0.9, weight decay 5e-4, linear warmup over 500 steps
    from ratio 1e-4, ×0.1 at the milestones)."""
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_iters: int = 500
    warmup_ratio: float = 1e-4
    decay_steps: Tuple[int, ...] = ()      # absolute step milestones
    decay_factor: float = 0.1
    policy: str = 'step'
    warmup: str = 'linear'
    total_steps: int = 0
    min_lr_ratio: float = 0.0
    fixed_last_steps: int = 0
    grad_clip: Optional[float] = None
    opt_type: str = 'sgd'
    paramwise: object = None


def make_lr_schedule(spec: OptimizerSpec) -> Callable[[int], float]:
    """The lr at a step count (read before the count is incremented):
    linear warmup from `warmup_ratio` over `warmup_iters` steps, times
    `decay_factor` per milestone passed."""
    if spec.policy.lower() != 'step':
        raise NotImplementedError(f'lr policy {spec.policy!r}: only the '
                                  "'step' policy is ported")
    if spec.warmup_iters > 0 and spec.warmup.lower() != 'linear':
        raise NotImplementedError(f'warmup {spec.warmup!r}: only linear '
                                  'warmup is ported')

    def schedule(step: int) -> float:
        warm = 1.0
        if spec.warmup_iters > 0:
            frac = min(max(step / spec.warmup_iters, 0.0), 1.0)
            warm = spec.warmup_ratio + (1 - spec.warmup_ratio) * frac
        decay = spec.decay_factor ** sum(step >= m for m in spec.decay_steps)
        return spec.lr * warm * decay
    return schedule


def frozen_mask(params: Dict[str, torch.Tensor], frozen_stages: int,
                extra_frozen=()) -> Dict[str, bool]:
    """True = trainable. Freezes the trunk's stem (`conv1`, `bn1`) and its
    first `frozen_stages` stages, matched on the name directly under
    `trunk`/`backbone`, so that blocks' own conv1/bn1 stay trainable."""
    frozen = []
    if frozen_stages >= 0:
        frozen += ['conv1', 'bn1']
        frozen += [f'layer{i}' for i in range(1, frozen_stages + 1)]
    frozen += list(extra_frozen)

    def trainable(name: str) -> bool:
        keys = name.split('.')
        for i, part in enumerate(keys[:-1]):
            if part in ('trunk', 'backbone') and keys[i + 1] != 'trunk' \
                    and keys[i + 1] in frozen:
                return False
        return True

    return {n: trainable(n) for n in params}


def flax_path(name: str) -> str:
    """The JAX package's '.'-joined path of a port parameter: '/' inside
    the flax names that hold one (`layer1/0`, `stage0/block1`) and
    `kernel` for `weight`; the names `utils/convert.py` maps."""
    name = re.sub(r'\b(layer\d+)\.(\d+)\b', r'\1/\2', name)
    name = re.sub(r'\b(stage\d+)\.(block\d+)\b', r'\1/\2', name)
    return re.sub(r'(^|\.)weight$', r'\1kernel', name)


def paramwise_groups(names: Iterable[str], pw_cfg
                     ) -> Dict[str, Tuple[float, float]]:
    """(lr_mult, decay_mult) of each parameter under mmcv's
    `paramwise_cfg`, by the JAX package's `paramwise_labels` rules on each
    parameter's flax path (`flax_path`), in order: the longest
    `custom_keys` key that is a substring of the path; a norm's `scale` or
    `bias` (its module has a `scale` and no `kernel`) gets
    `norm_decay_mult`; another `bias` gets `bias_lr_mult` /
    `bias_decay_mult`; the rest (1, 1). Without a `paramwise_cfg` every
    parameter gets (1, 1). The Swin configs' `relative_position_bias_table`
    matches no path (the table is `rel_bias`), so it is decayed, as in
    the JAX package."""
    names = list(names)
    if not pw_cfg:
        return dict.fromkeys(names, (1.0, 1.0))
    pw = dict(pw_cfg)
    custom = {k: dict(v) for k, v in dict(pw.get('custom_keys', {})).items()}
    custom_sorted = sorted(custom, key=len, reverse=True)
    bias_lr = float(pw.get('bias_lr_mult', 1.0))
    bias_wd = float(pw.get('bias_decay_mult', 1.0))
    norm_wd = float(pw.get('norm_decay_mult', 1.0))
    paths = {n: flax_path(n) for n in names}
    siblings = defaultdict(set)
    for path in paths.values():
        parent, _, leaf = path.rpartition('.')
        siblings[parent].add(leaf)

    def group(path: str) -> Tuple[float, float]:
        for k in custom_sorted:
            if k in path:
                return (float(custom[k].get('lr_mult', 1.0)),
                        float(custom[k].get('decay_mult', 1.0)))
        parent, _, leaf = path.rpartition('.')
        if leaf in ('scale', 'bias') and 'scale' in siblings[parent] \
                and 'kernel' not in siblings[parent]:
            return (1.0, norm_wd)
        if leaf == 'bias':
            return (bias_lr, bias_wd)
        return (1.0, 1.0)

    return {n: group(paths[n]) for n in names}


class FusedSGDState(NamedTuple):
    count: int
    momentum: Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: int
    momentum: Dict[str, torch.Tensor]     # the first moment (optax `mu`)
    nu: Dict[str, torch.Tensor]           # the second moment


def optimizer_states(opt_state) -> Tuple:
    """The optimizer states of a `TrainState.opt_state`: itself, or the GAN
    step's (main, disc) pair, a plain tuple."""
    return opt_state if type(opt_state) is tuple else (opt_state,)


def at_count(opt_state, count: int):
    """`opt_state` (one state or the GAN step's pair) at step `count`."""
    states = tuple(o._replace(count=count)
                   for o in optimizer_states(opt_state))
    return states if type(opt_state) is tuple else states[0]


def _zeros_like(params: Dict[str, torch.Tensor], names: List[str]
                ) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(params[n], memory_format=torch
                                .preserve_format) for n in names}


class _FusedOptimizer:
    """What the fused optimizers share: the spec's lr schedule, the
    trainable mask (frozen parameters get no update, no decay and no
    state), the paramwise groups and the global-norm clip."""

    kinds: Tuple[str, ...] = ()

    def __init__(self, spec: OptimizerSpec, trainable: Dict[str, bool]):
        if spec.opt_type.lower() not in self.kinds:
            raise NotImplementedError(
                f'optimizer {spec.opt_type!r}: {type(self).__name__} '
                f'runs {self.kinds}')
        self.spec = spec
        self.schedule = make_lr_schedule(spec)
        self.trainable = dict(trainable)
        mults = paramwise_groups(self.trainable, spec.paramwise)
        self.groups: Dict[Tuple[float, float], List[str]] = defaultdict(list)
        for n, on in self.trainable.items():
            if on:
                self.groups[mults[n]].append(n)

    def grad_scale(self, grads) -> Optional[torch.Tensor]:
        """The clip factor over the global norm of every gradient given,
        frozen ones included; None without a clip. The norm is the JAX
        package's `optax.global_norm`. On the card one foreach norm, whose
        reductions run as trees; on the CPU each tensor's squares go through
        `sum`, because the CPU's vector norm adds a long tensor's squares
        one by one in f32 (1e-3 off at 25 M elements)."""
        if not self.spec.grad_clip:
            return None
        gs = [g for g in grads if g is not None]
        norms = torch._foreach_norm(gs) if gs[0].is_cuda else \
            [g.square().sum().sqrt() for g in gs]
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
        return torch.clamp(self.spec.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)

    def _clipped(self, grads, params, names):
        """The gradients of `names` (zeros where a parameter got none),
        scaled by the clip factor; `grads` may be overwritten."""
        gs = [grads[n] if grads.get(n) is not None
              else torch.zeros_like(params[n]) for n in names]
        s = self.grad_scale(grads.values())
        if s is not None:
            torch._foreach_mul_(gs, s)
        return dict(zip(names, gs))


class _FusedSGD(_FusedOptimizer):
    """SGD with momentum and coupled weight decay in one pass over each
    group of trainable parameters: m ← μ·m + s·g + wd·d·p, p ← p − lr·l·m,
    with s the global-norm clip factor min(1, clip / max(‖g‖₂, 1e-12)) (1
    without a clip) and (l, d) the group's (lr_mult, decay_mult). A group
    at (0, 0) is frozen, as in the JAX package's fused SGD. Weight decay
    reaches every trainable parameter, FrozenBN scale and bias included,
    unless paramwise groups say otherwise."""

    kinds = ('sgd',)

    def init(self, params: Dict[str, torch.Tensor]) -> FusedSGDState:
        return FusedSGDState(0, _zeros_like(
            params, [n for n in params if self.trainable[n]]))

    @torch.no_grad()
    def fused_apply(self, grads: Dict[str, Optional[torch.Tensor]],
                    state: FusedSGDState, params: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], FusedSGDState]:
        """Returns (new params, new state): new tensors for the trainable
        parameters, the same ones for the frozen. The momentum buffers are
        updated in place and `grads` may be overwritten. A trainable
        parameter without a gradient counts as a zero gradient."""
        lr = self.schedule(state.count)
        mu, wd = self.spec.momentum, self.spec.weight_decay
        gs = self._clipped(grads, params, list(state.momentum))
        new = {}
        for (lr_m, wd_m), names in self.groups.items():
            if lr_m == 0.0 and wd_m == 0.0:
                continue
            ps = [params[n].detach() for n in names]
            ms = [state.momentum[n] for n in names]
            torch._foreach_mul_(ms, mu)
            torch._foreach_add_(ms, [gs[n] for n in names])
            torch._foreach_add_(ms, ps, alpha=wd * wd_m)
            new.update(zip(names, torch._foreach_add(ps, ms,
                                                     alpha=-lr * lr_m)))
        out = {n: new.get(n, p) for n, p in params.items()}
        return out, FusedSGDState(state.count + 1, state.momentum)


class _FusedAdam(_FusedOptimizer):
    """Adam and AdamW as optax computes them (b1 0.9, b2 0.999, ε 1e-8),
    per group of trainable parameters with (lr_mult l, decay_mult d):
    g ← s·g (the global-norm clip), for Adam g ← g + wd·d·p (L2, before
    the moments); m ← b1·m + (1 − b1)·g, v ← b2·v + (1 − b2)·g²; u =
    (m / (1 − b1^t)) / (sqrt(v / (1 − b2^t)) + ε), for AdamW u ← u +
    wd·d·p (decoupled); p ← p − lr·l·u, with t the count after the step
    and lr the schedule at the count before it."""

    kinds = ('adam', 'adamw')
    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        names = [n for n in params if self.trainable[n]]
        return AdamState(0, _zeros_like(params, names),
                         _zeros_like(params, names))

    @torch.no_grad()
    def fused_apply(self, grads: Dict[str, Optional[torch.Tensor]],
                    state: AdamState, params: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        """As `_FusedSGD.fused_apply`; both moments update in place."""
        lr = self.schedule(state.count)
        t = state.count + 1
        b1, b2 = self.b1, self.b2
        decoupled = self.spec.opt_type.lower() == 'adamw'
        gs = self._clipped(grads, params, list(state.momentum))
        new = {}
        for (lr_m, wd_m), names in self.groups.items():
            wd = self.spec.weight_decay * wd_m
            ps = [params[n].detach() for n in names]
            g = [gs[n] for n in names]
            if wd and not decoupled:
                torch._foreach_add_(g, ps, alpha=wd)
            ms = [state.momentum[n] for n in names]
            vs = [state.nu[n] for n in names]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, g, alpha=1 - b1)
            torch._foreach_mul_(vs, b2)
            torch._foreach_addcmul_(vs, g, g, value=1 - b2)
            den = torch._foreach_div(vs, 1 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(ms, 1 - b1 ** t)
            torch._foreach_div_(upd, den)
            if wd and decoupled:
                torch._foreach_add_(upd, ps, alpha=wd)
            new.update(zip(names, torch._foreach_add(ps, upd,
                                                     alpha=-lr * lr_m)))
        out = {n: new.get(n, p) for n, p in params.items()}
        return out, AdamState(t, state.momentum, state.nu)


def make_optimizer(spec: OptimizerSpec, params: Dict[str, torch.Tensor],
                   frozen_stages: int = -1) -> _FusedOptimizer:
    """The spec's optimizer over `params` (SGD, Adam or AdamW), the stem
    and the first `frozen_stages` trunk stages frozen; another type
    raises."""
    kind = spec.opt_type.lower()
    cls = {'sgd': _FusedSGD, 'adam': _FusedAdam, 'adamw': _FusedAdam}.get(kind)
    if cls is None:
        raise NotImplementedError(f'optimizer {spec.opt_type!r}: only SGD, '
                                  'Adam and AdamW are ported')
    return cls(spec, frozen_mask(params, frozen_stages))


def create_train_state(model: nn.Module, spec: OptimizerSpec,
                       frozen_stages: int = -1, ema: bool = False
                       ) -> Tuple[TrainState, _FusedOptimizer]:
    """The state over `model`'s parameters and the spec's optimizer: the
    stem and the first `frozen_stages` trunk stages frozen, and with `ema` a
    shadow copy of every parameter."""
    params = dict(model.named_parameters())
    tx = make_optimizer(spec, params, frozen_stages)
    ema_params = {n: p.detach().clone() for n, p in params.items()} \
        if ema else None
    return TrainState(0, params, tx.init(params), ema_params), tx


def make_train_step(model: nn.Module, tx: _FusedOptimizer,
                    skip_nonfinite: bool = False,
                    ema_momentum: Optional[float] = None) -> Callable:
    """The step (state, batch, generator=None, sampler_priorities=None) →
    (state, metrics). `generator` draws the samplers' priorities, or
    `sampler_priorities` gives them (see `FasterRCNN.loss`); dropout draws
    from torch's default generator. With `skip_nonfinite` a step whose loss
    or new parameters are not finite keeps the old parameters, while the
    momentum and batch statistics still advance. Metrics stay on the device
    (no read-back): `loss`, each loss term and `skipped_nonfinite`. The
    stages of the step are `step/...` profiler ranges (free without a
    profiler), which `tools/profile_train.py` reads."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        losses = model(batch, train=True, generator=generator,
                       sampler_priorities=sampler_priorities)
        total = sum(losses.values())
        wrt = [n for n, p in state.params.items() if p.requires_grad]
        with record_function('step/backward'):
            grads = dict(zip(wrt, torch.autograd.grad(
                total, [state.params[n] for n in wrt], allow_unused=True)))
        with record_function('step/sgd_guard_ema'):
            new_params, new_opt = tx.fused_apply(grads, state.opt_state,
                                                 state.params)
            metrics = {k: v.detach() for k, v in losses.items()}
            if skip_nonfinite:
                new_params, skipped = guard_nonfinite_update(
                    state.params, new_params, total.detach())
                metrics['skipped_nonfinite'] = skipped.float()
            with torch.no_grad():
                for n, p in state.params.items():
                    if new_params[n] is not p:
                        p.copy_(new_params[n])
            ema = state.ema_params
            if ema_momentum is not None and ema is not None:
                ema = ema_update(ema, state.params, ema_momentum,
                                 step=state.step)
        metrics = dict(loss=total.detach(), **metrics)
        return state._replace(step=state.step + 1, opt_state=new_opt,
                              ema_params=ema), metrics

    return step_fn


# ---- adversarial (two-parameter-group) training ---------------------------

def split_params(params: Dict[str, torch.Tensor]):
    """(main, disc): the parameters outside and under the discriminators
    (the top-level modules `DISC_KEYS`)."""
    def is_disc(name):
        return name.split('.', 1)[0] in DISC_KEYS
    main = {n: p for n, p in params.items() if not is_disc(n)}
    disc = {n: p for n, p in params.items() if is_disc(n)}
    return main, disc


def create_gan_train_state(model: nn.Module, spec: OptimizerSpec,
                           frozen_stages: int = -1
                           ) -> Tuple[TrainState, _FusedOptimizer,
                                      _FusedOptimizer]:
    """The state over `model`'s parameters, with `opt_state` the pair
    (main, disc), and the two optimizers, both of `spec`: the main group
    with the stem and the first `frozen_stages` trunk stages frozen, the
    discriminators with nothing frozen. No EMA."""
    params = dict(model.named_parameters())
    main, disc = split_params(params)
    tx_main = make_optimizer(spec, main, frozen_stages)
    tx_disc = make_optimizer(spec, disc)
    state = TrainState(0, params, (tx_main.init(main), tx_disc.init(disc)))
    return state, tx_main, tx_disc


def make_gan_train_step(model: nn.Module, tx_main: _FusedOptimizer,
                        tx_disc: _FusedOptimizer) -> Callable:
    """The step of the CycleGAN detectors (CyDA / CyCADA), with
    `make_train_step`'s signature: one forward, then two gradients of it —
    the sum of the terms not named `disc_*` with respect to the main
    parameters only, and the sum of the `disc_*` terms with respect to the
    discriminators only (the generator's GAN term reaches the
    discriminators too, and must not train them) — each applied by its own
    optimizer, global-norm clip included. The batch statistics are the forward's.
    Metric `loss` is the sum of both totals. Like the JAX step it has no
    NaN guard and no EMA. The two backwards are the profiler ranges
    `step/backward` and `step/backward_disc`."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.train()
        losses = model(batch, train=True, generator=generator,
                       sampler_priorities=sampler_priorities)
        g_total = sum(v for k, v in losses.items()
                      if not k.startswith('disc_'))
        d_total = sum(v for k, v in losses.items() if k.startswith('disc_'))
        main, disc = split_params(state.params)
        opt_main, opt_disc = state.opt_state
        groups = []
        for total, group, retain, stage in (
                (g_total, main, True, 'step/backward'),
                (d_total, disc, False, 'step/backward_disc')):
            with record_function(stage):
                wrt = [n for n, p in group.items() if p.requires_grad]
                grads = torch.autograd.grad(
                    total, [group[n] for n in wrt], retain_graph=retain,
                    allow_unused=True)
                groups.append(dict(zip(wrt, grads)))
        with record_function('step/sgd_guard_ema'):
            new_main, opt_main = tx_main.fused_apply(groups[0], opt_main,
                                                     main)
            new_disc, opt_disc = tx_disc.fused_apply(groups[1], opt_disc,
                                                     disc)
            with torch.no_grad():
                for new in (new_main, new_disc):
                    for n, p in new.items():
                        if p is not state.params[n]:
                            state.params[n].copy_(p)
        metrics = dict(loss=(g_total + d_total).detach(),
                       **{k: v.detach() for k, v in losses.items()})
        return state._replace(step=state.step + 1,
                              opt_state=(opt_main, opt_disc)), metrics

    return step_fn
