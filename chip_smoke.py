#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device — refuse to run without CUDA; print `nvidia-smi`'s name and power
   limit line.
2. build — compile every `csrc/*.cu` of the port for sm_90a (one `nvcc` per
   source, in parallel) into `build/kernels/`.
3. kernels — call each kernel's wrapper at the main path's shapes, hold it
   against its plain torch version (f32 with TF32 off, and bf16; both output
   layouts), and time kernel and plain version with CUDA events.
4. main path — `init_detector` on the flagship config
   (configs/da/faster_rcnn_r50_daf_c2f.py: DAFasterRCNN, R50-DC5, full
   width) with seeded random weights, then 4 requests of 2 Cityscapes-size
   images through `inference_detector`. The kernel launch counts are set to
   0 just before and read just after; every request must go through each
   kernel. Outputs must be well-formed and finite, and on the last request's
   proposals the kernel's RoI features must match the plain version's.
5. reference — the tiny-fixture detector on the card against the same
   weights on the CPU (plain versions), TF32 off.

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
    inference_detector, init_detector, prepare_batch)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.dense_heads.rpn_head import \
    rpn_proposals
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.ops import (
    cuda_build, roi_align)

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


def roi_align_work(rois, h, w, c, out_size=7, sr=2, scale=1 / 16):
    """Bytes and operations this run's RoIAlign needs: output written once,
    each feature pixel that any nonzero tap reads once, the RoIs; one FMA
    per nonzero (sample, tap) product and channel, one scale per output."""
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
    products = int((nx.sum(1) * ny.sum(1)).sum())
    n_out = rois.shape[0] * rois.shape[1] * out_size * out_size * c
    nbytes = 4 * (n_out + touched * c) + rois.numel() * 4
    ops = 2 * products * c + n_out
    return nbytes, ops


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    b, h, w, c, n = 2, 38, 64, 2048, 1000
    feats = torch.randn(b, h, w, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, n, h, w)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f = feats.to(dtype).contiguous()
        for flatten in (True, False):
            got = roi_align.roi_align_cuda(f, rois, 1 / 16, 7, 2, True,
                                           flatten).float()
            ref = roi_align.batched_roi_align_plain(f, rois, 1 / 16, 7, 2,
                                                    True, flatten).float()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise RuntimeError(f'roi_align_fwd {dtype} flatten={flatten}'
                                   f': shape {tuple(got.shape)} or non-finite')
            err = float((got - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            log(f'kernels: roi_align_fwd {str(dtype)[6:]} flatten={flatten} '
                f'max_abs_err={err:.3e} scale={scale:.3f} '
                f'tol={tol * scale:.3e}')
            if not err <= tol * scale:
                raise RuntimeError(f'roi_align_fwd disagrees with its plain '
                                   f'version: {err} > {tol * scale}')
            if dtype == torch.float32:
                worst = max(worst, err)
    ms = time_ms(lambda: roi_align.roi_align_cuda(feats, rois, 1 / 16,
                                                  flatten=True), 20)
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), 3, warmup=1)
    nbytes, ops = roi_align_work(rois, h, w, c)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    entry = dict(
        name='roi_align_fwd', route='cuda', source=f'{PKG}/csrc/roi_align.cu',
        replaces='unsupervised_domain_adaptation_object_detection_'
                 'implementation_tpu/ops/roi_align_pallas.py:63',
        launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
        library_ms=None)
    log(f'kernels: roi_align_fwd f32 (2,38,64,2048) x 2x1000 rois flat: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {entry["bound_ms"]:.4f}'
        f' ms ({entry["bound_by"]}: {nbytes / 1e6:.1f} MB, '
        f'{ops / 1e9:.2f} GFLOP)')
    return [entry]


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


def main():
    card = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_main_path(card, kernels)
    phase_reference()
    for k in kernels:
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
