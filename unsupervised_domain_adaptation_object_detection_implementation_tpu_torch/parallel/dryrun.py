"""Multi-rank train steps of the three structurally different programs
(counterpart of the JAX `__graft_entry__.py:dryrun_multichip`): the DA
flagship (single-level DC5 with the adversarial heads), Faster R-CNN FPN
(multi-level proposals and RoI levels) and CyDA's two-optimizer GAN step,
each on R18 trunks at a 64x96 canvas, on dp x tp = 2 x 2 ranks when the
rank count is even and at least 4, else dp = n. Each data rank takes one
source and one target image of the two-stream batch.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.parallel.dryrun 4

runs them on 4 gloo ranks on the CPU (`--device cuda` on the card, one
card a rank).

`rank_steps` is the per-rank step runner that the dry run, the CPU tests
and `chip_smoke.py` share: it builds a config's trainer on this rank's
device, takes this rank's contiguous rows of a global batch, seeds the
samplers and dropout at every step as the loop does, and returns the
global metrics of each step (and, from rank 0, the state in the one-device
layout, the model axis's shards gathered).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.config import Config
from .mesh import Layout, make_layout

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_CONFIG = 'configs/da/faster_rcnn_r18_tiny_fixture.py'
FPN_CONFIG = 'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py'

# the three programs: (config, overrides) at R18 width and a 64x96 canvas
PROGRAMS = {
    'daf': (TINY_CONFIG, {}),
    'fpn': (FPN_CONFIG, {'model.backbone_depth': 18,
                         'model.neck_channels': 64, 'model.num_classes': 2,
                         'model.rpn_proposal_cfg': dict(nms_pre=256,
                                                        max_per_img=64),
                         'model.roi_train_cfg': dict(num_samples=32)}),
    'cyda': (TINY_CONFIG, {'model.type': 'CyDAFasterRCNN',
                           'model.gen_blocks': 1}),
}


def program_config(program: str) -> Config:
    """The config of one of `PROGRAMS`, its overrides merged."""
    path, over = PROGRAMS[program]
    cfg = Config.fromfile(os.path.join(_REPO, path))
    cfg.merge_from_dict(dict(over))
    return cfg


def demo_batch(b: int, h: int = 64, w: int = 96, g: int = 6,
               num_classes: int = 2, seed: int = 0) -> Dict[str, np.ndarray]:
    """A global two-stream batch in numpy: `b` rows alternating source and
    target, random normal images, `g` gt slots of which each image has its
    own number valid (1 to g − 1), so the ranks' counts differ."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, min(h, w) * 0.6, (b, g, 2))
    wh = rs.uniform(8, min(h, w) * 0.4, (b, g, 2))
    return dict(
        image=rs.standard_normal((b, h, w, 3)).astype(np.float32),
        img_shape=np.array([[h, w]] * b, np.int32),
        gt_bboxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        gt_labels=rs.randint(0, num_classes, (b, g)).astype(np.int32),
        gt_valid=np.arange(g)[None, :] < rs.randint(1, g, (b, 1)),
        domain=np.array([i % 2 for i in range(b)], np.int32))


def state_digest(tensors: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """A bitwise digest of each tensor: the sum of its 32-bit words, each
    times a weight from its position, in int64 (equal digests on two ranks
    mean equal bits, up to a collision of the weighted sum)."""
    out = {}
    for n, t in tensors.items():
        words = t.detach().float().contiguous().view(torch.int32).reshape(-1)
        weight = torch.arange(words.numel(), device=words.device) % 65521 + 1
        out[n] = int((words.to(torch.int64) * weight).sum())
    return out


def rank_steps(cfg: Config, batch: Mapping[str, np.ndarray], steps: int,
               device: str = 'cpu', seed: int = 0, model_axis: int = 1,
               variables: Optional[Mapping] = None,
               sampler_priorities: Optional[Mapping[str, np.ndarray]] = None,
               no_dropout: bool = False, digests: bool = False,
               payload: bool = True, probe=None) -> Dict:
    """`steps` train steps of `cfg` on this rank's rows of the global
    `batch` (numpy; all of it without a process group). The process
    group's ranks form a layout with `model_axis` ranks on the model axis.
    Weights are `variables` (a JAX variable tree) or seeded from `seed`;
    the samplers and dropout are seeded at every step as the loop seeds
    them, unless `sampler_priorities` (global, numpy) fix the samplers;
    `no_dropout` sets every dropout rate to 0. Returns dict(metrics: each
    step's global metrics, launches: the RoIAlign pair's (forward,
    backward) launches each step, digests: with `digests`, each step's
    `state_digest` of the parameters, optimizer moments, EMA and buffers,
    payload: from rank 0 with `payload`, the final checkpoint payload in
    the one-device layout, probe: `probe(model, local batch)` after the
    steps, with no layout active, when given; ms: each step's host-clock
    ms, ending in a synchronize on a card)."""
    from ..apis.train import _dropout_seed, _sampler_seed, init_trainer
    from ..apis.train_state import optimizer_states
    from ..ops.roi_align import roi_align_pyramid_bwd_cuda, \
        roi_align_pyramid_cuda
    from ..utils.checkpoint import train_state_dict
    from .shardings import gather_payload, shard_train_state_
    layout: Optional[Layout] = make_layout(model_axis) \
        if dist.is_initialized() else None
    dev = torch.device(device)
    b = len(batch['image'])
    lo, hi = 0, b
    if layout is not None:
        per = b // layout.data.size
        lo, hi = layout.data.rank * per, (layout.data.rank + 1) * per
    local = {k: torch.from_numpy(np.asarray(v)[lo:hi]).to(dev)
             for k, v in batch.items()}
    pri = None if sampler_priorities is None else {
        k: torch.from_numpy(np.asarray(v)[lo:hi]).to(dev)
        for k, v in sampler_priorities.items()}
    trainer = init_trainer(cfg, variables=variables, device=dev, seed=seed,
                           steps_per_epoch=1, layout=layout)
    model, state = trainer.model, trainer.state
    if no_dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    if layout is not None:
        shard_train_state_(model, state, trainer.optimizer, layout)
    gen = torch.Generator(device=dev)
    out = dict(metrics=[], launches=[], digests=[], ms=[])
    for _ in range(steps):
        gen.manual_seed(_sampler_seed(seed, state.step))
        torch.manual_seed(_dropout_seed(seed, state.step))
        fwd0 = roi_align_pyramid_cuda.launches
        bwd0 = roi_align_pyramid_bwd_cuda.launches
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, local, gen,
                                      sampler_priorities=pri)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        out['ms'].append(1e3 * (time.perf_counter() - t0))
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        out['launches'].append((roi_align_pyramid_cuda.launches - fwd0,
                                roi_align_pyramid_bwd_cuda.launches - bwd0))
        if digests:
            tensors = dict(model.state_dict())
            for o in optimizer_states(state.opt_state):
                tensors.update({f'momentum.{n}': m
                                for n, m in o.momentum.items()})
                tensors.update({f'nu.{n}': v for n, v in
                                (getattr(o, 'nu', None) or {}).items()})
            tensors.update({f'ema.{n}': e for n, e in
                            (state.ema_params or {}).items()})
            out['digests'].append(state_digest(tensors))
    if payload:
        full = gather_payload(train_state_dict(model, state), layout)
        if layout is None or layout.rank == 0:
            out['payload'] = full
    if probe is not None:
        out['probe'] = probe(model, local)
    return out


def _dryrun_rank(program: str, batch, model_axis: int, device: str):
    return rank_steps(program_config(program), batch, 1, device=device,
                      model_axis=model_axis, payload=False)['metrics'][0]


def dryrun_multichip(n_devices: int, device: str = 'cpu') -> None:
    """One train step of each of the three programs on `n_devices` ranks
    (gloo on the CPU, NCCL on the card); prints each program's layout and
    global loss."""
    from .multihost import run_ranks
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // tp
    batch = demo_batch(2 * dp)
    threads = max(1, (os.cpu_count() or 1) // n_devices) \
        if device == 'cpu' else None
    for program in PROGRAMS:
        metrics = run_ranks(_dryrun_rank, n_devices,
                            (program, batch, tp, device), device=device,
                            threads=threads)[0]
        if not np.isfinite(metrics['loss']):
            raise FloatingPointError(f'{program}: loss {metrics["loss"]}')
        print(f'dryrun_multichip({n_devices}): {program} dp={dp} tp={tp} '
              f'loss={metrics["loss"]:.4f} OK', flush=True)


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('n_devices', type=int)
    p.add_argument('--device', default='cpu')
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == '__main__':
    main()
