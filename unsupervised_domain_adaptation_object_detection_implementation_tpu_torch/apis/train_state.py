"""Train state, SGD and the train step (counterpart of the JAX package's
`apis/train_state.py`).

One step: the detector's loss dict → the gradient of its sum → the fused
SGD update (momentum, coupled weight decay, lr schedule, frozen mask,
optional global-norm clip) → the optional NaN guard and EMA.

Where the JAX state is an immutable tree, here the parameters are the
model's own `nn.Parameter`s, keyed by their state-dict names, and are
written in place; the batch statistics are the model's buffers, which the
forward updates. `TrainState.params` holds the same Parameter objects, so
after a step both show the new values. The momentum is updated in place.
Only the SGD with the 'step' lr policy and linear warmup is ported; other
optimizers and policies raise.

The CycleGAN detectors train two parameter groups in one step
(`make_gan_train_step`): the discriminators (`disc_s`, `disc_t`) on the
`disc_*` loss terms, every other parameter on the rest, each group with
its own SGD; `opt_state` is then the pair (main, discriminators).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.profiler import record_function

from ..models.detectors.cyda_faster_rcnn import DISC_KEYS
from .hooks import ema_update, guard_nonfinite_update


class TrainState(NamedTuple):
    step: int
    params: Dict[str, nn.Parameter]
    opt_state: Union['FusedSGDState', Tuple['FusedSGDState', ...]]
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


class FusedSGDState(NamedTuple):
    count: int
    momentum: Dict[str, torch.Tensor]


def optimizer_states(opt_state) -> Tuple[FusedSGDState, ...]:
    """The `FusedSGDState`s of a `TrainState.opt_state`: itself, or the GAN
    step's (main, disc) pair, a plain tuple."""
    return opt_state if type(opt_state) is tuple else (opt_state,)


def at_count(opt_state, count: int):
    """`opt_state` (one state or the GAN step's pair) at step `count`."""
    states = tuple(o._replace(count=count)
                   for o in optimizer_states(opt_state))
    return states if type(opt_state) is tuple else states[0]


class _FusedSGD:
    """SGD with momentum and coupled weight decay in one pass over the
    trainable parameters: m ← μ·m + s·g + wd·p, p ← p − lr·m, with s the
    global-norm clip factor min(1, clip / max(‖g‖₂, 1e-12)) (1 without a
    clip). Frozen parameters get no update and keep their momentum. Weight
    decay reaches every trainable parameter, FrozenBN scale and bias
    included, as in the JAX package."""

    def __init__(self, spec: OptimizerSpec, trainable: Dict[str, bool]):
        if spec.opt_type.lower() != 'sgd' or spec.paramwise:
            raise NotImplementedError(
                f'optimizer {spec.opt_type!r} with paramwise '
                f'{spec.paramwise!r}: only plain SGD is ported')
        self.spec = spec
        self.schedule = make_lr_schedule(spec)
        self.trainable = dict(trainable)

    def init(self, params: Dict[str, torch.Tensor]) -> FusedSGDState:
        return FusedSGDState(0, {n: torch.zeros_like(p, memory_format=torch
                                                     .preserve_format)
                                 for n, p in params.items()
                                 if self.trainable[n]})

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
        names = list(state.momentum)
        ps = [params[n].detach() for n in names]
        gs = [grads[n] if grads.get(n) is not None else torch.zeros_like(p)
              for n, p in zip(names, ps)]
        ms = [state.momentum[n] for n in names]
        s = self.grad_scale(grads.values())
        if s is not None:
            torch._foreach_mul_(gs, s)
        torch._foreach_mul_(ms, mu)
        torch._foreach_add_(ms, gs)
        torch._foreach_add_(ms, ps, alpha=wd)
        new = dict(zip(names, torch._foreach_add(ps, ms, alpha=-lr)))
        out = {n: new.get(n, p) for n, p in params.items()}
        return out, FusedSGDState(state.count + 1, state.momentum)


def create_train_state(model: nn.Module, spec: OptimizerSpec,
                       frozen_stages: int = -1, ema: bool = False
                       ) -> Tuple[TrainState, _FusedSGD]:
    """The state over `model`'s parameters and the optimizer: the stem and
    the first `frozen_stages` trunk stages frozen, and with `ema` a shadow
    copy of every parameter."""
    params = dict(model.named_parameters())
    tx = _FusedSGD(spec, frozen_mask(params, frozen_stages))
    ema_params = {n: p.detach().clone() for n, p in params.items()} \
        if ema else None
    return TrainState(0, params, tx.init(params), ema_params), tx


def make_train_step(model: nn.Module, tx: _FusedSGD,
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
                           ) -> Tuple[TrainState, _FusedSGD, _FusedSGD]:
    """The state over `model`'s parameters, with `opt_state` the pair
    (main, disc), and the two optimizers, both of `spec`: the main group
    with the stem and the first `frozen_stages` trunk stages frozen, the
    discriminators with nothing frozen. No EMA."""
    params = dict(model.named_parameters())
    main, disc = split_params(params)
    tx_main = _FusedSGD(spec, frozen_mask(main, frozen_stages))
    tx_disc = _FusedSGD(spec, frozen_mask(disc, -1))
    state = TrainState(0, params, (tx_main.init(main), tx_disc.init(disc)))
    return state, tx_main, tx_disc


def make_gan_train_step(model: nn.Module, tx_main: _FusedSGD,
                        tx_disc: _FusedSGD) -> Callable:
    """The step of the CycleGAN detectors (CyDA / CyCADA), with
    `make_train_step`'s signature: one forward, then two gradients of it —
    the sum of the terms not named `disc_*` with respect to the main
    parameters only, and the sum of the `disc_*` terms with respect to the
    discriminators only (the generator's GAN term reaches the
    discriminators too, and must not train them) — each applied by its own
    SGD, global-norm clip included. The batch statistics are the forward's.
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
