#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device — refuse to run without CUDA; print `nvidia-smi`'s name and power
   limit line.
2. build — compile every `csrc/*.cu` of the port for sm_90a (one `nvcc` per
   source, in parallel) into `build/kernels/`.
3. kernels — call each kernel's wrapper at its main path's shapes, hold it
   against its plain torch version (f32 with TF32 off, and bf16; both
   layouts), and time kernel and plain version with CUDA events: the
   RoIAlign forward at the serving shape, its backward at the training
   shape.
4. serving — `init_detector` on the flagship config
   (configs/da/faster_rcnn_r50_daf_c2f.py: DAFasterRCNN, R50-DC5, full
   width) with seeded random weights, then 4 requests of 2 Cityscapes-size
   images through `inference_detector`. The kernel launch counts are set to
   0 just before and read just after; every request must go through each
   kernel. Outputs must be well-formed and finite, and on the last request's
   proposals the kernel's RoI features must match the plain version's.
5. train — `init_trainer` on the same config (R50-DC5, 'daf', full width,
   f32) with seeded random weights; 1 warm-up and 5 timed steps, past the
   lr warmup, on a seeded batch of 2 images of 512x1024 (one source, one
   target). Every step must
   give finite losses and launch the RoIAlign forward and backward kernels
   once each (counts set to 0 before the step, read after). Afterwards the
   frozen stem and layer1 are bit-identical, every other parameter, the DA
   heads' BatchNorm statistics and the EMA have moved.
6. reference — the tiny-fixture detector on the card against the same
   weights on the CPU (plain versions), TF32 off: inference, and one train
   step with dropout off and the same sampler priorities.

The line before the last is `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis import (
    inference_detector, init_detector, init_trainer, prepare_batch)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.dense_heads.rpn_head import \
    rpn_proposals
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.layers.norm import \
    BatchNorm
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.ops import (
    cuda_build, roi_align)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.profile_train import \
    demo_batch
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.utils.config import \
    Config

PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'
FLAGSHIP = 'configs/da/faster_rcnn_r50_daf_c2f.py'
TINY = 'configs/da/faster_rcnn_r18_tiny_fixture.py'
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# f32: kernel and plain version sum the same few (<= 16) weighted taps per
# bin in another order, from bit-identical sample positions: a few f32 ulps
# of the output's scale, so 1e-5 of it leaves ~100x headroom.
TOL_F32 = 1e-5
# bf16: the plain version rounds the weights, the x-interpolated
# intermediate and the result to bf16 (as the JAX package does); the kernel
# rounds once. Three roundings of 2^-8 each, plus cancellation: 2e-2.
TOL_BF16 = 2e-2
# the backward adds up to 16 weighted taps per gradient element into each
# feature pixel with f32 atomics, in an order that changes from run to run;
# a pixel sums a few hundred such terms: still a few ulps of the gradient's
# scale, so the same 1e-5 and 2e-2 hold
# steps per epoch of the flagship's two-stream loader: Cityscapes' 2975
# training images, one source and one target image per step
CITYSCAPES_STEPS = 2975
FROZEN = ('backbone.trunk.conv1', 'backbone.trunk.bn1',
          'backbone.trunk.layer1.')


def log(*parts):
    print(*parts, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'device: torch {torch.__version__} cuda {torch.version.cuda} '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    return card


def phase_build():
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    if not built:
        raise RuntimeError('no CUDA sources found to build')
    for src, (lib, seconds, compiler_log) in built.items():
        log(f'build: {src} -> {lib.name} in {seconds:.2f} s')
        for line in compiler_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'build:   {line.strip()}')
    log(f'build: all kernels in {time.perf_counter() - t0:.2f} s')


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_rois(gen, b, n, h, w, stride=16):
    """Seeded RoIs over an (h, w) stride-16 map, with edge cases: boxes
    crossing and beyond the border, under one pixel, and zero (padded)."""
    ih, iw = h * stride, w * stride
    u = torch.rand(b, n, 4, generator=gen, device='cuda')
    x1 = u[..., 0] * 1.2 * iw - 0.2 * iw
    y1 = u[..., 1] * 1.2 * ih - 0.2 * ih
    rois = torch.stack([x1, y1, x1 + 0.5 + u[..., 2] * 0.6 * iw,
                        y1 + 0.5 + u[..., 3] * 0.6 * ih], -1)
    special = torch.tensor([
        [0, 0, 0, 0], [0, 0, 0, 0],
        [-48, -32, 32, 48],
        [iw - 16, ih - 16, iw + 64, ih + 48],
        [iw + 16, ih + 16, iw + 80, ih + 96],
        [-144, -144, -32, -48],
        [5.3, 7.1, 5.9, 7.4],
        [iw / 2, ih / 2, iw / 2 + 3, ih / 2 + 2]], device='cuda')
    rois[:, :len(special)] = special
    return rois.contiguous()


def roi_align_taps(rois, h, w, out_size=7, sr=2, scale=1 / 16):
    """What this run's RoIs make RoIAlign touch: the feature pixels any
    nonzero tap reads, and the nonzero (sample, tap) products over all
    bins, per channel."""
    wx, wy = zip(*(roi_align._roi_weights(r, scale, out_size, sr, True, h, w)
                   for r in rois))
    touched = sum(int(((y.sum(1) != 0).float().T @ (x.sum(1) != 0).float()
                       > 0).sum()) for x, y in zip(wx, wy))

    def taps_per_bin(lo, size, length):      # nonzero taps per bin, (R, o)
        s = (torch.arange(sr, device=lo.device) + 0.5) / sr
        o = torch.arange(out_size, device=lo.device)
        pos = lo[:, None, None] + (o[None, :, None] + s) * size[:, None, None]
        valid = (pos >= -1) & (pos <= length)
        pc = pos.clamp(0, length - 1)
        frac = pc - pc.floor()
        return (valid * ((frac < 1).int() + (frac > 0).int())).sum(-1)

    sc = rois.reshape(-1, 4) * scale
    nx = taps_per_bin(sc[:, 0] - 0.5, (sc[:, 2] - sc[:, 0]) / out_size, w)
    ny = taps_per_bin(sc[:, 1] - 0.5, (sc[:, 3] - sc[:, 1]) / out_size, h)
    return touched, int((nx.sum(1) * ny.sum(1)).sum())


def roi_align_work(rois, h, w, c, out_size=7, backward=False):
    """Bytes and operations this run's RoIAlign needs. Forward: the output
    written once, each touched feature pixel read once, the RoIs; one FMA
    per nonzero product and channel, one scale per output. Backward: the
    output gradient read once, the feature gradient written once, the
    RoIs (the zeroing pass that the kernel's atomics need is its own
    overhead, not part of the function); one scale per gradient element,
    one multiply and one add per nonzero product and channel."""
    touched, products = roi_align_taps(rois, h, w, out_size)
    b, n = rois.shape[:2]
    n_out = b * n * out_size * out_size * c
    feat_bytes = b * h * w * c if backward else touched * c
    return 4 * (n_out + feat_bytes) + rois.numel() * 4, \
        2 * products * c + n_out


def _entry(name, replaces, nbytes, ops, **numbers):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return dict(
        name=name, route='cuda', source=f'{PKG}/csrc/roi_align.cu',
        replaces='unsupervised_domain_adaptation_object_detection_'
                 f'implementation_tpu/ops/roi_align_pallas.py:{replaces}',
        launches=None, **numbers, bound_ms=max(bytes_ms, ops_ms),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
        library_ms=None)


def _check(name, got, ref, tol, what):
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f'{name} {what}: shape {tuple(got.shape)} or '
                           'non-finite')
    err = float((got.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    log(f'kernels: {name} {what} max_abs_err={err:.3e} scale={scale:.3f} '
        f'tol={tol * scale:.3e}')
    if not err <= tol * scale:
        raise RuntimeError(f'{name} disagrees with its plain version: '
                           f'{err} > {tol * scale}')
    return err


def plain_backward(feats, rois, grad, flatten):
    """d feats of the plain version, by its autograd."""
    f = feats.detach().requires_grad_()
    out = roi_align.batched_roi_align_plain(f, rois, 1 / 16, flatten=flatten)
    return torch.autograd.grad(out, f, grad)[0]


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)

    # forward, at the serving shape
    b, h, w, c, n = 2, 38, 64, 2048, 1000
    feats = torch.randn(b, h, w, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, n, h, w)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f = feats.to(dtype).contiguous()
        for flatten in (True, False):
            err = _check('roi_align_fwd', roi_align.roi_align_cuda(
                f, rois, 1 / 16, 7, 2, True, flatten),
                roi_align.batched_roi_align_plain(
                    f, rois, 1 / 16, 7, 2, True, flatten),
                tol, f'{str(dtype)[6:]} flatten={flatten}')
            if dtype == torch.float32:
                worst = max(worst, err)
    ms = time_ms(lambda: roi_align.roi_align_cuda(feats, rois, 1 / 16,
                                                  flatten=True), 20)
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), 3, warmup=1)
    nbytes, ops = roi_align_work(rois, h, w, c)
    fwd = _entry('roi_align_fwd', 63, nbytes, ops, max_abs_err=worst,
                 ms=ms, plain_ms=plain_ms)
    log(f'kernels: roi_align_fwd f32 (2,38,64,2048) x 2x1000 rois flat: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd["bound_ms"]:.4f}'
        f' ms ({fwd["bound_by"]}: {nbytes / 1e6:.1f} MB, '
        f'{ops / 1e9:.2f} GFLOP)')
    del feats, rois

    # backward, at the training shape: 512 sampled RoIs per image
    b, h, w, c, n = 2, 32, 64, 2048, 512
    feats = torch.randn(b, h, w, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, n, h, w)
    grad = torch.randn(b, n, 7 * 7 * c, generator=gen, device='cuda')
    shape = (b, h, w, c)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f, g = feats.to(dtype), grad.to(dtype)
        for flatten in (True, False):
            gl = g if flatten else \
                g.reshape(b, n, 7, 7, c).transpose(2, 3).contiguous()
            err = _check('roi_align_bwd', roi_align.roi_align_bwd_cuda(
                gl, rois, shape, 1 / 16, flatten=flatten),
                plain_backward(f, rois, gl, flatten), tol,
                f'{str(dtype)[6:]} flatten={flatten}')
            if dtype == torch.float32:
                worst = max(worst, err)
            del gl
    del f, g
    ms = time_ms(lambda: roi_align.roi_align_bwd_cuda(
        grad, rois, shape, 1 / 16, flatten=True), 20)
    f = feats.detach().requires_grad_()
    out = roi_align.batched_roi_align_plain(f, rois, 1 / 16, flatten=True)
    plain_ms = time_ms(lambda: torch.autograd.grad(out, f, grad,
                                                   retain_graph=True),
                       3, warmup=1)
    del out, f
    nbytes, ops = roi_align_work(rois, h, w, c, backward=True)
    bwd = _entry('roi_align_bwd', 303, nbytes, ops, max_abs_err=worst,
                 ms=ms, plain_ms=plain_ms)
    log(f'kernels: roi_align_bwd f32 (2,32,64,2048) x 2x512 rois flat g: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bwd["bound_ms"]:.4f}'
        f' ms ({bwd["bound_by"]}: {nbytes / 1e6:.1f} MB, '
        f'{ops / 1e9:.2f} GFLOP; {(ops - grad.numel()) / 2e9:.2f} G f32 '
        'atomic adds)')
    return [fwd, bwd]


def _check_result(res, shape_hw, num_classes, max_det):
    h, w = shape_hw
    if len(res) != num_classes:
        raise RuntimeError(f'{len(res)} class arrays, expected {num_classes}')
    total = 0
    for det in res:
        if det.dtype != np.float32 or det.ndim != 2 or det.shape[1] != 5:
            raise RuntimeError(f'malformed dets {det.dtype} {det.shape}')
        if not np.isfinite(det).all():
            raise RuntimeError('non-finite dets')
        boxes, scores = det[:, :4], det[:, 4]
        if (boxes < -1e-3).any() or (boxes[:, 0::2] > w + 1e-2).any() \
                or (boxes[:, 1::2] > h + 1e-2).any() \
                or (boxes[:, 2:] < boxes[:, :2]).any():
            raise RuntimeError('dets outside the image or inverted')
        if ((scores <= 0.05) | (scores > 1.0)).any():
            raise RuntimeError('scores outside (score_thr, 1]')
        total += len(det)
    if total > max_det:
        raise RuntimeError(f'{total} dets > max_per_img {max_det}')
    return total


def phase_main_path(card, kernels):
    # serving runs with PyTorch's defaults: cuDNN convolutions in TF32,
    # matrix products in full f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    bundle = init_detector(FLAGSHIP, device='cuda', seed=0)
    torch.cuda.synchronize()
    log(f'main: init_detector {FLAGSHIP} on cuda in '
        f'{time.perf_counter() - t0:.2f} s; canvas {bundle.canvas}, '
        f'{sum(p.numel() for p in bundle.model.parameters()) / 1e6:.1f} M '
        'params')
    if bundle.canvas != (608, 1024):
        raise RuntimeError(f'canvas {bundle.canvas}, expected (608, 1024)')
    rs = np.random.RandomState(0)
    requests = [[rs.randint(0, 256, (1024, 2048, 3), dtype=np.uint8)
                 for _ in range(2)] for _ in range(5)]
    t0 = time.perf_counter()
    inference_detector(bundle, requests[0])          # warm-up, set-up cost
    log(f'main: warm-up request {1e3 * (time.perf_counter() - t0):.1f} ms')

    counters = {'roi_align_fwd': roi_align.batched_roi_align}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, n_dets = [], 0
    for i, req in enumerate(requests[1:], 1):
        t0 = time.perf_counter()
        res = inference_detector(bundle, req)
        latencies.append(1e3 * (time.perf_counter() - t0))
        for r in res:
            n_dets += _check_result(r, (1024, 2048), 8, 100)
        for name, fn in counters.items():     # each request ran each kernel
            if fn.launches != i:
                raise RuntimeError(f'{name}: {fn.launches} launches after '
                                   f'{i} requests')
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for entry in kernels:
        if entry['name'] in launches:
            entry['launches'] = launches[entry['name']]
    total_s = sum(latencies) / 1e3
    log(f'main: 4 requests x 2 images 1024x2048 -> {n_dets} dets; latency '
        f'ms {[round(x, 2) for x in latencies]} mean '
        f'{np.mean(latencies):.2f}; {8 / total_s:.2f} img/s; peak memory '
        f'{peak / 2**30:.2f} GiB; launches {launches} [{card}]')

    # the kernel's RoI features on the last request's real proposals
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, requests[-1])
        model = bundle.model
        feat = model.extract_feat(batch['image'])
        rpn_cls, rpn_reg = model.rpn_head(feat)
        proposals, _, valid = rpn_proposals(
            rpn_cls, rpn_reg, model._anchors_for(feat), batch['img_shape'],
            model.rpn_test_cfg)
        feats = feat.permute(0, 2, 3, 1).contiguous()
        got = roi_align.roi_align_cuda(feats, proposals, 1 / 16,
                                       flatten=True)
        ref = roi_align.batched_roi_align_plain(feats, proposals, 1 / 16,
                                                flatten=True)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    log(f'main: RoI features on the last request ({int(valid.sum())} valid '
        f'proposals): max_abs_err {err:.3e} scale {scale:.3f}')
    if not err <= TOL_F32 * scale:
        raise RuntimeError(f'RoI features disagree: {err} > {TOL_F32 * scale}')
    return dict(latency_ms=latencies, img_per_s=8 / total_s,
                peak_bytes=peak)


def phase_train(card, kernels):
    # training runs with PyTorch's defaults, as serving does: cuDNN
    # convolutions in TF32, matrix products in full f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    trainer = init_trainer(FLAGSHIP, device='cuda', seed=0,
                           steps_per_epoch=CITYSCAPES_STEPS)
    model, params = trainer.model, trainer.state.params
    torch.cuda.synchronize()
    log(f'train: init_trainer {FLAGSHIP} on cuda in '
        f'{time.perf_counter() - t0:.2f} s; '
        f'{sum(p.numel() for p in params.values()) / 1e6:.1f} M params, '
        f'{sum(p.numel() for p in params.values() if p.requires_grad) / 1e6:.1f}'
        f' M trainable; {trainer.spec}')
    batch = demo_batch()                # 2 images of 512x1024, on the card
    gen = torch.Generator(device='cuda').manual_seed(0)
    start = {n: p.detach().clone() for n, p in params.items()}
    da_stats = {f'{m_name}.{b}': getattr(m, b).clone()
                for m_name, m in model.named_modules()
                if isinstance(m, BatchNorm) for b in ('mean', 'var')}
    if not da_stats:
        raise RuntimeError('no DA-head BatchNorm in the model')

    counters = {'roi_align_fwd': roi_align.batched_roi_align,
                'roi_align_bwd': roi_align.roi_align_bwd_cuda}
    totals = dict.fromkeys(counters, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # past the 500-step warmup, at the schedule's full lr: an update at the
    # first steps' lr (1e-7) is below f32 resolution for many parameters
    state, times = trainer.state, []
    state = state._replace(opt_state=state.opt_state._replace(count=500))
    for i in range(6):                  # 1 warm-up + 5 timed steps
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch, gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        for name, fn in counters.items():
            if fn.launches != 1:
                raise RuntimeError(f'train step {i}: {name} launched '
                                   f'{fn.launches} times, expected 1')
            totals[name] += fn.launches
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()) \
                or values['skipped_nonfinite']:
            raise RuntimeError(f'train step {i}: {values}')
        if i:
            times.append(ms)
        log(f'train: step {i} {ms:.1f} ms ' + ' '.join(
            f'{k}={v:.4f}' for k, v in values.items()))
    peak = torch.cuda.max_memory_allocated()

    # the EMA follows the parameters (its decay ramps up from ~0, so after 6
    # steps it sits within a few ulps of them on many leaves) but is not them
    moved = ema_apart = 0
    for n, p in params.items():
        same = torch.equal(p.detach(), start[n])
        if n.startswith(FROZEN) != same:
            raise RuntimeError(f'{n}: {"unchanged" if same else "changed"} '
                               'after 6 steps')
        moved += not same
        if not same and torch.equal(state.ema_params[n], start[n]):
            raise RuntimeError(f'{n}: the EMA did not follow the parameter')
        ema_apart += not same and \
            not torch.equal(state.ema_params[n], p.detach())
    if not ema_apart:
        raise RuntimeError('the EMA equals the parameters on every leaf')
    for n, v in da_stats.items():
        if torch.equal(model.get_buffer(n), v):
            raise RuntimeError(f'{n}: DA-head BatchNorm statistic unchanged')
    for entry in kernels:
        if entry['name'] == 'roi_align_bwd':
            entry['launches'] = totals['roi_align_bwd']
    med = float(np.median(times))
    log(f'train: 5 steps x 2 images 512x1024 (R50-DC5 daf f32): step ms '
        f'{[round(t, 2) for t in times]} median {med:.2f} min '
        f'{min(times):.2f} max {max(times):.2f}; {2e3 / med:.2f} img/s; '
        f'peak memory {peak / 2**30:.2f} GiB; launches {totals} over 6 '
        f'steps; {moved} parameters moved, stem and layer1 unchanged, EMA '
        f'apart from {ema_apart} of them, {len(da_stats)} DA BatchNorm '
        f'statistics moved [{card}]')
    return dict(step_ms=times, img_per_s=2e3 / med, peak_bytes=peak)


def phase_reference():
    """Tiny fixture detector: card (kernels) vs CPU (plain versions)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 256, (64, 96, 3), dtype=np.uint8)
            for _ in range(2)]
    outs = []
    for device in ('cuda', 'cpu'):
        bundle = init_detector(TINY, device='cpu', seed=3)
        if device == 'cuda':
            bundle = bundle._replace(model=bundle.model.to('cuda'),
                                     device=torch.device('cuda'))
        outs.append(inference_detector(bundle, imgs))
    worst = 0.0
    for g_img, r_img in zip(*outs):
        for g, r in zip(g_img, r_img):
            if g.shape != r.shape:
                raise RuntimeError(f'card vs CPU: {g.shape} vs {r.shape}')
            if len(g):
                worst = max(worst, float(np.abs(g - r).max()))
    log(f'reference: tiny fixture card vs CPU, '
        f'{sum(len(d) for r in outs[1] for d in r)} dets, max_abs_err '
        f'{worst:.3e}')
    if not worst <= 1e-3:
        raise RuntimeError(f'card and CPU disagree: {worst}')


def phase_reference_train():
    """One tiny-fixture train step on the card (kernels) against the same
    step on the CPU (plain versions), from the same weights, TF32 off,
    dropout off and the same sampler priorities. Per-term losses within
    1e-4 relative and updated parameters within 1e-4 of scale: the two
    sides sum in other orders, the RoIAlign backward with atomics."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(TINY)
    cfg.merge_from_dict({'optimizer.lr': 0.002,
                         'lr_config.warmup_ratio': 0.5})
    # one step at step count 0: the epoch length only places the decay
    trainers = [init_trainer(cfg, device=d, seed=3, steps_per_epoch=1)
                for d in ('cpu', 'cuda')]
    trainers[1].model.load_state_dict(trainers[0].model.state_dict())
    batch = demo_batch(2, 64, 96, g=6, num_classes=2, seed=4, device='cpu')
    gen = torch.Generator().manual_seed(5)
    pri = dict(rpn=torch.rand(2, 4 * 6 * 6, generator=gen),
               rcnn=torch.rand(2, 6 + 64, generator=gen))
    results = []
    for trainer in trainers:
        for m in trainer.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        dev = trainer.device
        _, metrics = trainer.step(
            trainer.state, {k: v.to(dev) for k, v in batch.items()},
            sampler_priorities={k: v.to(dev) for k, v in pri.items()})
        results.append(({k: float(v) for k, v in metrics.items()},
                        {n: t.detach().cpu() for n, t in
                         trainer.model.state_dict().items()}))
    (ref_l, ref_p), (got_l, got_p) = results
    rel = max(abs(got_l[k] - v) / max(abs(v), 1e-6) for k, v in ref_l.items())
    err = max(float((got_p[n] - v).abs().max()) /
              max(1.0, float(v.abs().max())) for n, v in ref_p.items())
    log(f'reference: tiny fixture train step card vs CPU: losses '
        f'{ {k: round(v, 5) for k, v in got_l.items()} }, worst relative '
        f'loss difference {rel:.3e}, worst parameter difference {err:.3e} '
        'of scale')
    if set(got_l) != set(ref_l) or not rel <= 1e-4 or not err <= 1e-4:
        raise RuntimeError(f'train step card vs CPU: losses {rel}, '
                           f'params {err}')


def main():
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_main_path(card, kernels)
    phase_train(card, kernels)
    phase_reference()
    phase_reference_train()
    for k in kernels:
        if not k['launches']:
            raise RuntimeError(f'{k["name"]} was not launched on its path')
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise RuntimeError(f'{k["name"]}.{key} = {v}')
    log(card)
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
