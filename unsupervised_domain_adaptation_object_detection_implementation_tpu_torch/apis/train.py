"""Training (counterpart of the JAX package's `apis/train.py`).

`init_trainer(config)` → `Trainer(model, state, step, optimizer, spec, cfg,
device)`; `trainer.step(trainer.state, batch)` runs one step on the padded
batch dict of `FasterRCNN.loss`. The CycleGAN detectors (CyDA, CyCADA)
get the two-group step `make_gan_train_step`, whose optimizer is the pair
(main, discriminators) and which, as in the JAX loop, keeps no EMA and has
no NaN guard, whatever the config asks; evaluation then uses the live
parameters.

A config's `fp16` block (`fp16 = dict(loss_scale=...)`) trains in bf16
when the model config names no `dtype`, as the JAX package's fp16 gate
does; `loss_scale` is ignored (bf16 has f32's exponent range). Serving
(`apis.init_detector`) reads no `fp16`, as in the JAX package.

`train_detector(cfg, work_dir)` is the config-driven loop: the train set
and its loader (two-stream for a source/target `ConcatDataset`), the
trainer with the loader's epoch length, resume or weight loading, then per
epoch (or per `max_iters` for the iteration-based runner) the steps,
`train_log.jsonl` records, `ckpt_<tag>` checkpoints and evaluation on the
val set with the EMA parameters.

On several ranks (`n_devices`, `launcher='jax'` or a `dist_params` block;
`parallel/`) it runs the JAX mesh loop's global-batch step: a global batch
of `samples_per_gpu` rows a data rank, each rank fed its contiguous rows,
the schedule counted in global steps, the box head split over a `mesh`
block's model axis; rank 0 writes the log and the checkpoints, in the
one-device layout.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import torch
import torch.distributed as dist

from ..data import DataLoader, build_dataset
from ..data.builder import load_loader_state, loader_state
from ..models.builder import build_detector, train_canvas
from ..models.layers.precision import compute_dtype
from ..models.weight_init import head_scale_of, init_random_weights_
from ..parallel.mesh import Layout, mesh_from_cfg, mesh_shape
from ..parallel.multihost import init_multihost, rank_device, run_ranks
from ..parallel.shardings import gather_payload, shard_train_state_
from ..utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                load_meta, load_pretrained_backbone,
                                load_weights,
                                read_pretrained_backbone,
                                restore_train_state, save_checkpoint,
                                train_state_dict)
from ..utils.config import Config
from ..utils.convert import load_jax_variables
from ..utils.device import resolve_device
from .test import evaluate_dataset
from .train_state import (OptimizerSpec, TrainState, _FusedOptimizer,
                          create_gan_train_state, create_train_state,
                          make_gan_train_step, make_train_step)

# detector types whose adversarial game gets the NaN guard by default
_ADVERSARIAL = {'DAFasterRCNN', 'DAFasterRCNN_Org', 'MAFasterRCNN',
                'FasterRCNN_SWDA', 'DAFasterRCNN_Deep', 'DAFasterRCNN_Tri',
                'CyDAFasterRCNN', 'CyCADA'}


# detector types whose adversarial generator/discriminator game has its own
# two-group step
_GAN = {'CyDAFasterRCNN', 'CyCADA'}
# detectors that train on one device only (their multi-rank step is not
# ported: the semantic and global-context losses, the variants' IoU, grid
# and point losses and Dynamic R-CNN's batch statistics have no
# global-batch form)
_ONE_DEVICE = {'CascadeRCNN', 'CascadeMaskRCNN', 'HTC', 'SCNet',
               'DoubleHeadRCNN', 'DynamicRCNN', 'GridRCNN',
               'MaskScoringRCNN', 'PointRend'}


class Trainer(NamedTuple):
    model: torch.nn.Module
    state: TrainState
    step: Callable
    optimizer: Union[_FusedOptimizer, Tuple[_FusedOptimizer, ...]]
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


def train_model_cfg(cfg: Config) -> Dict:
    """The model config a trainer builds: `cfg.model`, with
    `dtype='bfloat16'` when the config has an `fp16` block and the model
    names no dtype (the JAX package's fp16 gate)."""
    model_cfg = dict(cfg.model)
    if cfg.get('fp16') is not None and 'dtype' not in model_cfg:
        model_cfg['dtype'] = 'bfloat16'
    return model_cfg


def init_trainer(config: Union[str, Config],
                 variables: Optional[Mapping] = None,
                 device: Union[str, torch.device] = 'cuda',
                 seed: int = 0,
                 steps_per_epoch: Optional[int] = None,
                 layout: Optional[Layout] = None) -> Trainer:
    """Build the config's detector on `device` (CUDA unless the caller asks
    for the CPU; raises without a card), with `variables` converted from
    the JAX package or seeded random weights, in train mode and with
    channels_last convolution weights; then its train state and step: the
    optimizer of `optimizer.type` (SGD, Adam or AdamW, with its
    `paramwise_cfg`), the stem and `backbone.frozen_stages` stages frozen,
    the EMA when the config asks for one, and the NaN guard by default for
    the adversarial detectors (`optimizer_config.nan_guard` overrides).
    The CycleGAN detectors get the two-group step instead, with no EMA
    and no guard. The MHSA heads are sized for the train pipeline's `Pad`
    canvas (`train_canvas`). The compute type is the model config's
    `dtype`, else bf16 under an `fp16` block (`train_model_cfg`).
    `steps_per_epoch`, the loader's length, turns epoch milestones into
    steps; a config with the epoch-based runner raises without it. With a
    `layout` (`parallel/mesh.py`) the step is a rank's part of the
    global-batch step; the state stays in the one-device layout until
    `parallel/shardings.py:shard_train_state_` splits it over a model
    axis."""
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    if layout is not None:
        _refuse_ranks(cfg)
    spec = optimizer_spec(cfg, steps_per_epoch)
    model = build_detector(train_model_cfg(cfg), device='meta',
                           canvas=train_canvas(cfg))
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    if variables is not None:
        load_jax_variables(model, variables)
    else:
        init_random_weights_(
            model, torch.Generator(device=device).manual_seed(seed),
            head_scale_of(cfg))
    model.train()

    frozen = cfg.model.get('backbone', {}).get('frozen_stages', 1)
    if cfg.model.get('type') in _GAN:
        state, tx_main, tx_disc = create_gan_train_state(
            model, spec, frozen_stages=frozen)
        step = make_gan_train_step(model, tx_main, tx_disc, layout)
        return Trainer(model, state, step, (tx_main, tx_disc), spec, cfg,
                       device)
    ema_momentum = ema_momentum_of(cfg)
    state, tx = create_train_state(model, spec, frozen_stages=frozen,
                                   ema=ema_momentum is not None)
    nan_guard = bool((cfg.get('optimizer_config', {}) or {}).get(
        'nan_guard', cfg.model.get('type', '') in _ADVERSARIAL))
    step = make_train_step(model, tx, skip_nonfinite=nan_guard,
                           ema_momentum=ema_momentum, layout=layout)
    return Trainer(model, state, step, tx, spec, cfg, device)


def _refuse_ranks(cfg: Config):
    """Raise for a detector whose multi-rank step is not ported."""
    if cfg.model.get('type') == 'SABLFasterRCNN' and cfg.model.get('cascade'):
        raise NotImplementedError(
            'SABLFasterRCNN(cascade=True) on several ranks: the multi-rank '
            'step of the cascade family is not ported (ROADMAP.md); train '
            'it on one device')
    if cfg.model.get('type') in _ONE_DEVICE:
        raise NotImplementedError(
            f"{cfg.model['type']} on several ranks: the multi-rank step of "
            'the cascade family and the RoI-head variants is not ported '
            '(ROADMAP.md); train it on one device')


def _refuse_unported(cfg: Config, launcher, n_devices=None):
    """Raise on what the loop does not port, each with its reason, before
    the loop makes its work dir: an unported compute type (float16) and a
    multi-rank run of a one-device detector among them."""
    if launcher not in (None, 'none', 'jax'):
        raise ValueError(f"launcher={launcher!r}: 'jax' (or 'none')")
    if n_devices not in (None, 1) or launcher == 'jax' or \
            cfg.get('dist_params'):
        _refuse_ranks(cfg)
    if cfg.get('load_submodule'):
        raise NotImplementedError('a `load_submodule` block: grafting a '
                                  'donor checkpoint into a submodule is not '
                                  'ported yet')
    compute_dtype(train_model_cfg(cfg).get('dtype'))


def _train_rank(cfg: Config, work_dir: str, kwargs: Dict) -> Dict[str, float]:
    """One rank of `train_detector(n_devices=k)` (a spawned process whose
    process group is set up)."""
    return train_detector(cfg, work_dir, **kwargs)


def _join_process_group(cfg: Config, n_devices, launcher, device
                        ) -> Optional[Layout]:
    """The layout of this process's rank: `launcher='jax'` or a
    `dist_params` block initialise the default process group
    (`parallel/multihost.py:init_multihost`), a spawned rank has one
    already; None for a single process, where a `mesh` block must hold one
    rank."""
    if launcher == 'jax' or cfg.get('dist_params'):
        params = dict(cfg.get('dist_params') or {})
        init_multihost(params.get('coordinator_address'),
                       params.get('num_processes'), params.get('process_id'),
                       params.get('backend'), device)
    if not dist.is_initialized():
        mesh_shape(cfg, 1)
        return None
    if n_devices not in (None, dist.get_world_size()):
        raise ValueError(f'n_devices={n_devices} in a process group of '
                         f'{dist.get_world_size()} ranks')
    return mesh_from_cfg(cfg)


@contextlib.contextmanager
def _eval_weights(model: torch.nn.Module, state: TrainState):
    """`model` in eval mode with the EMA parameters (the live ones without
    an EMA) for the duration; the live parameters are copied back, bit for
    bit, and train mode restored afterwards."""
    live = None
    with torch.no_grad():
        if state.ema_params is not None:
            live = {n: p.detach().clone() for n, p in state.params.items()}
            for n, p in state.params.items():
                p.copy_(state.ema_params[n])
    model.eval()
    try:
        yield
    finally:
        model.train()
        if live is not None:
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(live[n])


@torch.no_grad()
def _restart_ema(state: TrainState):
    """The EMA (when the trainer keeps one) restarted from the live
    parameters."""
    if state.ema_params is not None:
        for n, p in state.params.items():
            state.ema_params[n].copy_(p)


def _sampler_seed(seed: int, step: int) -> int:
    """The samplers' seed at `step`: a function of `seed + 1` and the step
    alone, as the JAX loop's `fold_in(key(seed + 1), step)` is."""
    return ((seed + 1) << 32) + step


def _dropout_seed(seed: int, step: int) -> int:
    """The seed of torch's default generators, which dropout draws from, at
    `step`: a function of `seed` and the step alone, so that a run, and a
    resumed one, draw the same masks in every process (the JAX loop splits
    its dropout key from the step's key)."""
    return (seed << 32) + step


def train_detector(cfg: Config, work_dir: str,
                   resume_from: Optional[str] = None,
                   load_from: Optional[str] = None,
                   pretrained_backbone: Optional[str] = None,
                   seed: int = 0, log_interval: int = 50,
                   max_epochs: Optional[int] = None,
                   eval_interval: int = 1,
                   checkpoint_interval: int = 1,
                   n_devices: Optional[int] = None,
                   launcher: Optional[str] = None,
                   device: Union[str, torch.device] = 'cuda'
                   ) -> Dict[str, float]:
    """Config-driven training on `device` (CUDA unless the caller asks for
    the CPU). Returns the last evaluation's metrics ({} without one).

    The loader's length sets the epoch; `evaluation.interval` and
    `checkpoint_config.interval` (epochs, or steps for the iteration-based
    runner) override `eval_interval` and `checkpoint_interval`. Every
    `log_interval` steps and at an epoch's end a `mode='train'` record goes
    to `work_dir/train_log.jsonl`; each evaluation (with the EMA parameters
    when the trainer keeps them) writes a `mode='val'` record. Checkpoints
    go to `work_dir/ckpt_<epoch or step>`, at the interval and at the end.
    `resume_from` (a checkpoint, or 'auto' for the work dir's latest)
    restores the whole state and starts at epoch step // steps per epoch,
    with the loader's random state of the epoch's end when the checkpoint
    holds it (`data/builder.py:loader_state`, kept by the epoch-based
    runner), so that the resumed epochs draw the batches an uninterrupted
    run draws;
    `load_from` loads the weights alone (the EMA restarts from them);
    `pretrained_backbone`, a classification checkpoint of the trunk
    (`utils/checkpoint.py:load_pretrained_backbone`: official Swin or
    torchvision ResNet), is loaded before either, and the EMA restarts
    from it. The
    samplers draw from a `torch.Generator` on `device` seeded at every step
    from `seed + 1` and the step (`_sampler_seed`), and dropout from torch's
    default generators, seeded at every step from `seed` and the step
    (`_dropout_seed`), so a resumed run draws what an uninterrupted one
    does in any process; the loader's sampler and the datasets draw from
    `seed` (their state at an epoch's end goes into the checkpoint).

    Several ranks: `n_devices=k` (k > 1) in a single process starts k ranks
    itself (`parallel/multihost.py:run_ranks`: one card each, more than
    the machine has raises; gloo ranks on the CPU) and returns rank 0's
    metrics; `launcher='jax'` or a `dist_params` block joins this process
    to a process group as one rank (`init_multihost`). The ranks form the
    `mesh` block's (data, model) layout. Each rank walks the global
    sampler (`samples_per_gpu` rows a data rank, so the epoch and the
    schedule count global steps, as in the JAX loop) and keeps its own
    rows; a two-stream loader needs an even share a rank. Every rank seeds
    its generators alike, so the run computes what one process computes
    on the global batch. Rank 0 writes the records and the checkpoints
    (the one-device layout, the model axis's shards gathered), and
    `resume_from` restores any checkpoint onto any layout. Submodule
    grafting raises NotImplementedError."""
    _refuse_unported(cfg, launcher, n_devices)
    if n_devices not in (None, 1) and not dist.is_initialized():
        kwargs = dict(resume_from=resume_from, load_from=load_from,
                      pretrained_backbone=pretrained_backbone, seed=seed,
                      log_interval=log_interval, max_epochs=max_epochs,
                      eval_interval=eval_interval,
                      checkpoint_interval=checkpoint_interval, device=device)
        threads = max(1, torch.get_num_threads() // n_devices)
        return run_ranks(_train_rank, n_devices, (cfg, work_dir, kwargs),
                         device=device, threads=threads,
                         timeout_s=None)[0]
    pretrained = None
    if pretrained_backbone:
        # read first: a layout the port has no trunk for raises before the
        # work dir is made
        try:
            pretrained = read_pretrained_backbone(pretrained_backbone)
        except NotImplementedError as err:
            raise NotImplementedError(
                f'pretrained_backbone={pretrained_backbone!r}: {err}') from err
    device = resolve_device(device)
    layout = _join_process_group(cfg, n_devices, launcher, device)
    main = layout is None or layout.rank == 0
    if layout is not None:
        device = rank_device(device, layout.rank)
    os.makedirs(work_dir, exist_ok=True)
    if max_epochs and 'Iter' not in str((cfg.get('runner') or {}).get(
            'type', '')):
        cfg = Config(cfg.to_dict(), cfg.filename)
        cfg.merge_from_dict({'runner.max_epochs': max_epochs})
    train_ds = build_dataset(cfg.data['train'], device)
    samples_per_batch = cfg.data.get('samples_per_gpu', 2)
    ranks = 1 if layout is None else layout.data.size
    rows = None
    if ranks > 1:
        r = layout.data.rank
        rows = (r * samples_per_batch, (r + 1) * samples_per_batch)
    loader = DataLoader(train_ds, samples_per_batch * ranks, seed=seed,
                        rows=rows)
    if ranks > 1 and loader.two_stream and samples_per_batch % 2:
        raise ValueError(f'samples_per_gpu={samples_per_batch}: a rank of a '
                         'two-stream loader needs as many source rows as '
                         'target rows, an even share')
    steps_per_epoch = len(loader)
    trainer = init_trainer(cfg, device=device, seed=seed,
                           steps_per_epoch=steps_per_epoch, layout=layout)
    model, state = trainer.model, trainer.state
    # the reference's NumClassCheckHook
    ds_classes = getattr(train_ds, 'CLASSES', None)
    if ds_classes and len(ds_classes) != model.num_classes:
        warnings.warn(
            f'model.num_classes={model.num_classes} != len(dataset.CLASSES)='
            f'{len(ds_classes)} ({ds_classes[:5]}…) — check the config '
            f'(reference NumClassCheckHook)')
    iter_based, epochs, max_iters, _ = resolve_runner(
        cfg.get('runner', {}) or {}, cfg.get('lr_config', {}) or {},
        steps_per_epoch)
    eval_interval = (cfg.get('evaluation', {}) or {}).get(
        'interval', eval_interval)
    checkpoint_interval = (cfg.get('checkpoint_config', {}) or {}).get(
        'interval', checkpoint_interval)

    if pretrained is not None:
        load_pretrained_backbone(model, pretrained)
        _restart_ema(state)
    start_epoch = 0
    if resume_from:
        path = latest_checkpoint(work_dir) if resume_from == 'auto' \
            else resume_from
        if path:
            state = restore_train_state(model, state,
                                        load_checkpoint(path, device))
            start_epoch = state.step // max(steps_per_epoch, 1)
            drawn = load_meta(path).get('loader')
            if drawn is not None and not iter_based:
                load_loader_state(loader, drawn)
            if main:
                print(f'[train] resumed from {path} (epoch {start_epoch})')
    elif load_from:
        load_weights(model, load_checkpoint(load_from, device), ema=False)
        _restart_ema(state)
        if main:
            print(f'[train] loaded weights from {load_from}')
    if layout is not None:
        shard_train_state_(model, state, trainer.optimizer, layout)

    gen = torch.Generator(device=device)
    classes = list(ds_classes or [])
    val_ds = None
    metrics_out: Dict[str, float] = {}

    def log(rec: Dict, tag: str):
        if main:
            print(f'[{tag}] {rec}')
            log_f.write(json.dumps(rec) + '\n')
            log_f.flush()

    def do_ckpt(tag: int):
        payload = gather_payload(train_state_dict(model, state), layout)
        meta = dict(epoch=tag, classes=classes)
        if not iter_based:          # at an epoch's end: the loader's draws
            meta['loader'] = loader_state(loader)
        if main:
            save_checkpoint(os.path.join(work_dir, f'ckpt_{tag}'), payload,
                            meta=meta)

    def do_eval(tag_key: str, tag: int):
        nonlocal metrics_out, val_ds
        if val_ds is None:
            val_ds = build_dataset(cfg.data['val'], device)
        with _eval_weights(model, state):
            metrics_out = evaluate_dataset(model, val_ds, samples_per_batch,
                                           layout=layout)
        log(dict(mode='val', **{tag_key: tag},
                 **{k: round(float(v), 4) for k, v in metrics_out.items()}),
            'eval')

    log_path = os.path.join(work_dir, 'train_log.jsonl')
    with (open(log_path, 'a') if main
          else contextlib.nullcontext()) as log_f:
        done = False
        for epoch in range(start_epoch, epochs):
            t_epoch = time.time()
            for it, batch in enumerate(loader):
                gen.manual_seed(_sampler_seed(seed, state.step))
                torch.manual_seed(_dropout_seed(seed, state.step))
                state, metrics = trainer.step(state, batch, gen)
                g_it = epoch * steps_per_epoch + it + 1
                if (it + 1) % log_interval == 0 or it + 1 == steps_per_epoch:
                    m = {k: float(v) for k, v in metrics.items()}
                    log(dict(mode='train', epoch=epoch + 1, iter=it + 1,
                             **{k: round(v, 5) for k, v in m.items()}),
                        'train')
                if iter_based:
                    done = g_it >= max_iters
                    if g_it % checkpoint_interval == 0 or done:
                        do_ckpt(g_it)
                    if 'val' in cfg.data and (g_it % eval_interval == 0
                                              or done):
                        do_eval('iter', g_it)
                    if done:
                        break
            if main:
                print(f'[train] epoch {epoch + 1} done in '
                      f'{time.time() - t_epoch:.1f}s')
            if done:
                break
            if iter_based:
                continue
            if (epoch + 1) % checkpoint_interval == 0 or epoch + 1 == epochs:
                do_ckpt(epoch + 1)
            if 'val' in cfg.data and (epoch + 1) % eval_interval == 0:
                do_eval('epoch', epoch + 1)
    if layout is not None:
        dist.barrier()       # rank 0's files are written when any returns
    return metrics_out
