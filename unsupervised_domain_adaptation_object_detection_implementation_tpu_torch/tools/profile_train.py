"""Where a train step's time goes on a CUDA card.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.profile_train \
        [--config configs/da/faster_rcnn_r50_daf_c2f.py] [--steps 5] \
        [--size 512 1024] [--batch 2] [--out build/profile/profile_train.json]

Builds the trainer with seeded random weights (past the lr warmup, as
`chip_smoke.py` runs it) and a seeded batch, by default of one source and
one target image of 512x1024 (`--batch 8 --size 128 192` is the synth
loop's step; the domains matter to the DA detectors only; the FPN
and Mask R-CNN configs, configs/cityscapes/*_r50_fpn_1x_cityscapes.py and
configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py, train on both images; a
detector with a mask head also gets seeded 112x112 box-frame rasters),
and reports:

- the whole `trainer.step` on the host clock, ending in a synchronize, and
  the process's CPU time in it, over all its threads (autograd runs the
  backward on a thread of its own; waits on the device spin), so CPU time
  near the wall time means the host was busy the whole step;
- a `torch.profiler` trace of whole steps, read per stage from the
  `step/...` ranges that the step itself opens (trunk with the GRL heads,
  or trunk and FPN neck; RPN head and loss, proposals, RoI sampling,
  RoIAlign, C4's res5 head, box head and loss, the mask branch's RoIAlign,
  targets and head with its loss, DA losses, backward, SGD with the guard
  and the EMA): each
  stage's host time (the profiler roughly doubles it), and the device
  time of the work launched while it was open; then the device busy time
  per step, its idle share of the unprofiled step, and the kernels that
  take the most device time.

Runs on the card; `--device cpu --config <tiny> --size 64 96` runs the same
code without one (no device times).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..apis import init_trainer

STAGE = 'step/'
PROFILED_STEPS = 3
# the loader's length (Cityscapes: 2975 steps of one source and one target
# image); it only places the lr milestones, far beyond the profiled steps
STEPS_PER_EPOCH = 2975
# box-frame raster size of the mask detectors' batch (`LoadAnnotations`'
# default mask_size)
MASK_SIZE = 112


def demo_batch(b=2, h=512, w=1024, g=16, num_classes=8, seed=0,
               device='cuda', mask_size=None):
    """The JAX package's `__graft_entry__._demo_batch` in numpy, on
    `device`: random normal images, `g` gt slots of which the first 4 are
    valid, domains alternating source, target. With `mask_size` M, also
    `gt_masks` (b, g, M, M): seeded box-frame ellipses (`ellipse_masks`)."""
    rng = np.random.RandomState(seed)
    boxes = rng.uniform(0, min(h, w) // 2, (b, g, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + 8
    batch = dict(
        image=rng.randn(b, h, w, 3).astype(np.float32),
        img_shape=np.array([[h, w]] * b, np.int32),
        gt_bboxes=boxes,
        gt_labels=rng.randint(0, num_classes, (b, g)).astype(np.int32),
        gt_valid=np.arange(g)[None, :] < 4 + np.zeros((b, 1)),
        domain=np.array([i % 2 for i in range(b)], np.int32))
    if mask_size:
        batch['gt_masks'] = ellipse_masks(np.random.RandomState(seed + 1),
                                          (b, g), mask_size)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def ellipse_masks(rng, shape, m):
    """(*shape, m, m) uint8 box-frame rasters: one filled ellipse each, its
    centre in the middle 40% of the frame and its semi-axes 20–50% of it,
    so the targets vary across RoIs and within each."""
    c = rng.uniform(0.3, 0.7, shape + (2,)) * m
    r = rng.uniform(0.2, 0.5, shape + (2,)) * m
    px = np.arange(m) + 0.5
    dx = (px - c[..., 0, None]) / r[..., 0, None]
    dy = (px - c[..., 1, None]) / r[..., 1, None]
    return (dy[..., :, None] ** 2 + dx[..., None, :] ** 2 <= 1).astype(
        np.uint8)


def stage_split(prof, steps):
    """(host ms, device ms) per stage and step, from the `step/...` ranges
    of a finished `torch.profiler.profile`. Host: the range's wall time.
    Device: the kernels, copies and sets whose launch fell inside the range,
    from any thread (autograd launches the backward from its own); work
    launched outside every range is `other`, and device work whose launch
    the trace does not show is `unattributed`."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launched_at, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith(STAGE):      # not the ranges' device copy
                device.append((e.correlation_id(), dur))
        elif name.startswith(STAGE):
            ranges.append((start, start + dur, name[len(STAGE):]))
        elif name.startswith('cu'):             # runtime/driver launch calls
            launched_at[e.correlation_id()] = start
    ranges.sort()
    starts = [r[0] for r in ranges]
    host, dev = collections.Counter(), collections.Counter()
    for t0, t1, name in ranges:
        host[name] += (t1 - t0) / 1e6 / steps
        dev[name] += 0.0
    for corr, dur in device:
        t, stage = launched_at.get(corr), 'unattributed'
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            stage = ranges[i][2] if i >= 0 and t <= ranges[i][1] else 'other'
        dev[stage] += dur / 1e6 / steps
    return ({k: (host.get(k, 0.0), dev[k]) for k in dev},
            sum(d for _, d in device) / 1e6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default='configs/da/faster_rcnn_r50_daf_c2f.py')
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--size', type=int, nargs=2, default=(512, 1024))
    ap.add_argument('--batch', type=int, default=2,
                    help='images a step, half source and half target')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default='build/profile/profile_train.json')
    args = ap.parse_args(argv)

    on_card = torch.device(args.device).type == 'cuda'
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0] \
        if on_card else 'cpu'
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = init_trainer(args.config, device=args.device, seed=args.seed,
                           steps_per_epoch=STEPS_PER_EPOCH)
    state = trainer.state
    state = state._replace(opt_state=state.opt_state._replace(count=500))
    batch = demo_batch(b=args.batch, h=args.size[0], w=args.size[1],
                       num_classes=trainer.model.num_classes, seed=args.seed,
                       device=args.device,
                       mask_size=MASK_SIZE if hasattr(trainer.model,
                                                      'mask_head') else None)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    for _ in range(2):                                       # warm-up
        state, _ = trainer.step(state, batch, gen)
    sync()

    step_ms, cpu_ms = [], []
    for _ in range(args.steps):
        t0, c0 = time.perf_counter(), time.process_time()
        state, _ = trainer.step(state, batch, gen)
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        cpu_ms.append(1e3 * (time.process_time() - c0))

    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    n = PROFILED_STEPS
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = trainer.step(state, batch, gen)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    stages, busy_ms = stage_split(prof, n)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, 'self_device_time_total', 0) > 0
            and str(e.device_type).endswith('CUDA')
            and not e.key.startswith(STAGE)]
    rows.sort(key=lambda r: -r[1])
    result = dict(
        card=card, config=args.config, steps=args.steps,
        images_per_step=args.batch,
        step_ms=step_ms, step_ms_median=float(np.median(step_ms)),
        host_cpu_ms=cpu_ms, host_cpu_ms_median=float(np.median(cpu_ms)),
        profiled_steps=n, profiled_wall_ms=wall_ms,
        stage_host_ms={k: v[0] for k, v in stages.items()},
        stage_device_ms={k: v[1] for k, v in stages.items()},
        device_busy_ms_per_step=busy_ms / n,
        device_idle_share=1 - busy_ms / n / float(np.median(step_ms)),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card
        else None,
        top_device_ops=[dict(name=k, device_ms=ms, count=c)
                        for k, ms, c in rows[:30]])
    print(card)
    print(f'step ms {[round(x, 3) for x in step_ms]} median '
          f'{result["step_ms_median"]:.3f}; host CPU ms '
          f'{[round(x, 3) for x in cpu_ms]} median '
          f'{result["host_cpu_ms_median"]:.3f}')
    print(f'profiled {n} steps: {wall_ms / n:.3f} ms wall per step; per '
          'step and stage, host ms / device ms:')
    for k, (h, d) in stages.items():
        print(f'stage {k:22s} {h:9.3f} {d:9.3f}')
    print(f'device busy {busy_ms / n:.3f} ms per step; idle share of the '
          f'unprofiled step {result["device_idle_share"]:.3f}')
    for r in result['top_device_ops']:
        print(f'  {r["device_ms"]:9.3f} ms  x{r["count"]:<5d} '
              f'{r["name"][:100]}')
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    main()
