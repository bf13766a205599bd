"""Time the RoIAlign kernels of two checkouts of the port on one card, on
the same inputs, in turns.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.compare_roi_align \
        --other build/parent [--dtype bfloat16] \
        [--out build/profile/compare_roi_align.json]

Run from the root of a checkout; `--other` is the root of another checkout
(for example the parent commit, unpacked with `git archive` into a
directory that `.gitignore` lists). The other checkout's package is loaded
under another name, so both live in one process; each builds its own CUDA
sources into its own `build/kernels/`. Both are reached through the entry
points that every version of the port has, `ops.roi_align.batched_roi_align`
and `batched_roi_align_fpn`: the forward under `no_grad`, the backward as
`torch.autograd.grad` of a kept forward graph (the zeroing of the gradient
buffer included, as a train step runs it). Cases, at the shapes of
`chip_smoke.py` phase 3, in f32 or (`--dtype bfloat16`) with the features
and the output gradient in bf16:

- `dc5_fwd`: feats (2, 38, 64, 2048), 2 x 1000 RoIs, flat output;
- `dc5_bwd`: feats (2, 32, 64, 2048), 2 x 512 RoIs, flat g;
- `dc5_bwd_step`: the RoIs that a train step of the seeded full-width
  R50-DC5 flagship samples from `demo_batch` after 6 steps, on its own map;
- `fpn_fwd`, `fpn_bwd`: the pyramids of the 608x1024 serving and 512x1024
  training canvases, C = 256, 2 x 1000 and 2 x 512 RoIs on all four levels.

Each case times this checkout, the other, the other, this, 20 calls each
after a warm-up: the RoIAlign kernels' own device time from a
`torch.profiler` trace (`kernel_ms`: the host's launch overhead and the
small kernels around them, such as the FPN path's level computation, do not
count), and CUDA events around the calls (`call_ms`, which the host can
hold back where a call is short). It checks that the two agree within 1e-4
of the output's scale in f32 (`TOL`), within `chip_smoke.TOL_BF16` in bf16
(the backward's f32 sums, added in another order, round to bf16 an ulp
apart), prints the card's name and power limit and
one line a case, and writes the numbers as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..apis import init_trainer
from ..ops import roi_align

PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'
FLAGSHIP = 'configs/da/faster_rcnn_r50_daf_c2f.py'
# the two checkouts' results apart, of the output's scale: forwards sum the
# same taps in other orders (a few f32 ulps); backwards add thousands of
# terms into a crowded pixel with f32 atomics in run-dependent orders
# (1.3e-5 measured on a DC5 step's RoIs between two designs)
TOL = 1e-4


def load_roi_align(root: str, alias: str):
    """`ops.roi_align` of the port in checkout `root`, imported as package
    `alias`."""
    pkg_dir = Path(root).resolve() / PKG
    spec = importlib.util.spec_from_file_location(
        alias, pkg_dir / '__init__.py',
        submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f'{alias}.ops.roi_align')


def step_rois(smoke):
    """The flagship's sampled RoIs after 6 train steps past the warmup, as
    `chip_smoke.py` phase 5 takes them, and the map they are read from."""
    trainer = init_trainer(FLAGSHIP, device='cuda', seed=0,
                           steps_per_epoch=smoke.CITYSCAPES_STEPS)
    state = trainer.state
    state = state._replace(opt_state=state.opt_state._replace(count=500))
    batch = smoke.demo_batch()
    gen = torch.Generator(device='cuda').manual_seed(0)
    for _ in range(6):
        state, _ = trainer.step(state, batch, gen)
    feats, sampled, _ = smoke.sample_step_rois(trainer.model, batch, 3)
    return feats, sampled.rois


def cases(smoke, dtype=torch.float32):
    """name → (make(ra): a function of no arguments that launches the kernel
    of `ra` once and returns its result); features and output gradients in
    `dtype`."""
    gen = torch.Generator(device='cuda').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device='cuda').to(dtype)

    def fwd(feats, rois):
        def make(ra):
            def run():
                with torch.no_grad():
                    return ra.batched_roi_align(feats, rois, 1 / 16,
                                                flatten=True)
            return run
        return make

    def bwd(feats, rois, grad):
        def make(ra):
            f = feats.clone().requires_grad_()
            out = ra.batched_roi_align(f, rois, 1 / 16, flatten=True)
            return lambda: torch.autograd.grad(out, f, grad,
                                               retain_graph=True)[0]
        return make

    def fpn_fwd(feats, rois):
        def make(ra):
            def run():
                with torch.no_grad():
                    return ra.batched_roi_align_fpn(feats, rois, flatten=True)
            return run
        return make

    def fpn_bwd(feats, rois, grad):
        def make(ra):
            fs = [f.clone().requires_grad_() for f in feats]
            out = ra.batched_roi_align_fpn(fs, rois, flatten=True)
            return lambda: torch.cat([g.flatten() for g in torch.autograd.grad(
                out, fs, grad, retain_graph=True)])
        return make

    out = {}
    feats = randn(2, 38, 64, 2048)
    out['dc5_fwd'] = fwd(feats, smoke.make_rois(gen, 2, 1000, 38, 64))
    feats = randn(2, 32, 64, 2048)
    rois = smoke.make_rois(gen, 2, 512, 32, 64)
    grad = randn(2, 512, 49 * 2048)
    out['dc5_bwd'] = bwd(feats, rois, grad)
    feats, rois = step_rois(smoke)
    feats = feats.to(dtype)
    grad = randn(2, rois.shape[1], 49 * feats.shape[-1])
    out['dc5_bwd_step'] = bwd(feats, rois, grad)
    for name, (ih, n) in (('fpn_fwd', (608, 1000)), ('fpn_bwd', (512, 512))):
        feats = [randn(2, ih // s, 1024 // s, 256) for s in smoke.FPN_STRIDES]
        rois = smoke.make_fpn_rois(gen, 2, n, ih, 1024)
        if name == 'fpn_fwd':
            out[name] = fpn_fwd(feats, rois)
        else:
            out[name] = fpn_bwd(feats, rois, randn(2, n, 49 * 256))
    return out


def kernel_ms(fn, iters=20):
    """Device ms of the RoIAlign kernels per call of `fn`, from a profiler
    trace of `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, 'self_device_time_total', 0)
             for e in prof.key_averages() if 'roi_align' in e.key)
    if not us:
        raise RuntimeError('no RoIAlign kernel in the profiler trace')
    return us / iters / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--other', required=True,
                    help='root of the other checkout')
    ap.add_argument('--dtype', default='float32',
                    choices=['float32', 'bfloat16'])
    ap.add_argument('--out', default='build/profile/compare_roi_align.json')
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit('compare_roi_align needs a CUDA card')
    sys.path.insert(0, os.getcwd())
    smoke = importlib.import_module('chip_smoke')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = {'this': roi_align, 'other': load_roi_align(args.other,
                                                        'other_port')}
    tol = TOL if dtype == torch.float32 else smoke.TOL_BF16
    result = dict(card=card, other=args.other, dtype=args.dtype, cases={})
    for name, make in cases(smoke, dtype).items():
        runs = {k: make(ra) for k, ra in sides.items()}
        got, ref = runs['this'](), runs['other']()
        torch.cuda.synchronize()
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((got.float() - ref.float()).abs().max())
        if not err <= tol * scale:
            raise RuntimeError(f'{name}: the checkouts disagree, {err} at '
                               f'scale {scale}')
        kernel = {k: [] for k in sides}
        call = {k: [] for k in sides}
        for k in ('this', 'other', 'other', 'this'):
            kernel[k].append(kernel_ms(runs[k]))
            call[k].append(smoke.time_ms(runs[k], 20))
        result['cases'][name] = dict(kernel_ms=kernel, call_ms=call,
                                     max_abs_diff=err, scale=scale)
        print(f'{name} {args.dtype}: kernel ms this {kernel["this"]} other '
              f'{kernel["other"]}; call ms this {call["this"]} other '
              f'{call["other"]}; apart by {err:.3e} at scale {scale:.3f}',
              flush=True)
        del runs, got, ref
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    main()
