"""Where the serving path's time goes on a CUDA card.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.profile_serving \
        [--config configs/da/faster_rcnn_r50_daf_c2f.py] [--requests 5] \
        [--cfg-options model.dtype=bfloat16] \
        [--out chiprun_out/profile_serving.json]

Builds the detector with seeded random weights (`--cfg-options` merges
dotted overrides into the config, as the command lines do), answers
requests of two seeded 1024x2048 images, and reports:

- per-stage times on the host clock, each stage ending in a synchronize:
  preprocess (pipeline on the card), trunk (with the FPN neck for the FPN
  detectors), RPN head (over every level), proposals (top-k, decode, NMS),
  RoI head (RoIAlign + box head + decode + multiclass NMS; C4's box head
  runs res5 first; the cascade family's three stages, with HTC's and
  SCNet's semantic and global-context heads), for the mask detectors the
  mask branch on the detections (RoIAlign, mask head(s), own-class
  sigmoid), and inside the RoI head RoIAlign and the (first) box head
  alone;
- the whole `inference_detector` call per request, and the same request
  split into pipeline, `predict`, and copy-back with per-class packing;
- a `torch.profiler` trace of whole requests: device busy time (sum of
  device time of all kernels and copies), the idle share of the wall time,
  and the kernels that take the most device time; the peak memory of the
  requests.

Stage times add a synchronize per stage, so their sum exceeds the plain
request time by the overlap the syncs remove. Needs a card; raises without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..apis import inference_detector, init_detector, prepare_batch
from ..core.bbox.transforms import bbox2result
from ..models.dense_heads.rpn_head import rpn_proposals
from .train import load_config
from ..models.roi_heads.standard_roi_head import roi_head_predict


def _stages(model, image, results=None):
    """The detector's serving stages as (name, fn) pairs; each fn takes the
    previous stage's output. Every detector splits alike through the
    surface they share (`rpn_outputs`, `roi_maps`, `roi_extract`, and
    `roi_box_head` where the box head is more than `bbox_head`): trunk (with
    the neck), RPN head, proposals, RoI head, and `mask_predict` where the
    detector has a mask head. The cascade family's RoI head is its
    `roi_context` (semantic map, global context) and `cascade_detect`, and
    its split times the first stage's box head. `results`, where given,
    receives the RoI head's detections and the mask branch's `masks`."""
    img_shape = image['img_shape']
    cascade = hasattr(model, 'cascade_detect')
    head = model.bbox_heads[0] if cascade else \
        getattr(model, 'roi_box_head', model.bbox_head)
    dets = {} if results is None else results

    def proposals(out):
        feats, cls, reg, anchors = out
        props, _, valid = rpn_proposals(cls, reg, anchors, img_shape,
                                        model.rpn_test_cfg)
        maps = model.roi_maps(feats)
        if cascade:
            return maps, props, valid, model.roi_context(feats)
        return maps, props, valid

    def roi_head(out):
        feats, props, valid = out[:3]
        if cascade:
            dets.update(model.cascade_detect(feats, out[3], props, valid,
                                             img_shape))
            return out
        dets.update(roi_head_predict(
            head, feats, props, valid, img_shape, model.num_classes,
            target_stds=model.roi_train_cfg.target_stds,
            use_sigmoid_cls=model.roi_train_cfg.use_sigmoid_cls,
            cfg=model.roi_test_cfg, roi_extractor=model.roi_extract))
        return out

    def mask_branch(out):
        dets['masks'] = model.mask_predict(out[0], dets, *out[3:])
        return out

    def roi_align(out):
        feats, props = out[:2]
        return model.roi_extract(feats, props)

    stages = [('trunk', lambda _: model.extract_feat(image['image'])),
              ('rpn_head', lambda feats: (feats, *model.rpn_outputs(feats))),
              ('proposals', proposals), ('roi_head', roi_head)]
    if getattr(model, 'with_mask', False):
        stages.append(('mask_branch', mask_branch))
    return stages + [('roi_head.roi_align', roi_align),
                     ('roi_head.bbox_head', head)]


def _stage_times(bundle, imgs):
    times = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = 1e3 * (now - t0)
        return now

    torch.cuda.synchronize()
    t = time.perf_counter()
    batch, _ = prepare_batch(bundle, imgs)
    t = mark('preprocess', t)
    with torch.inference_mode():
        out = None
        for name, fn in _stages(bundle.model, batch):
            out = fn(out)
            t = mark(name, t)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default='configs/da/faster_rcnn_r50_daf_c2f.py')
    ap.add_argument('--requests', type=int, default=5)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default='chiprun_out/profile_serving.json')
    ap.add_argument('--cfg-options', nargs='+', default=[],
                    help='dotted config overrides: key=value')
    args = ap.parse_args(argv)

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bundle = init_detector(load_config(args), device='cuda', seed=args.seed)
    torch.cuda.reset_peak_memory_stats()
    rs = np.random.RandomState(args.seed)
    reqs = [[rs.randint(0, 256, (1024, 2048, 3), dtype=np.uint8)
             for _ in range(2)] for _ in range(args.requests)]
    for req in reqs[:2]:                                   # warm-up
        inference_detector(bundle, req)

    stage_runs = [_stage_times(bundle, req) for req in reqs]
    stages = {k: float(np.median([r[k] for r in stage_runs]))
              for k in stage_runs[0]}
    request_ms = []
    for req in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference_detector(bundle, req)
        request_ms.append(1e3 * (time.perf_counter() - t0))
    # the same request in three synchronized parts: pipeline, predict,
    # copy-back and per-class packing
    split_runs = []
    for req in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, samples = prepare_batch(bundle, req)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = bundle.model.predict(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for i, sample in enumerate(samples):
            bbox2result(out['dets'][i, :, :4] / sample['scale_factor'],
                        out['labels'][i], out['dets'][i, :, 4],
                        out['valid'][i], bundle.model.num_classes)
        t3 = time.perf_counter()
        split_runs.append(dict(prepare_batch=1e3 * (t1 - t0),
                               predict=1e3 * (t2 - t1),
                               to_host=1e3 * (t3 - t2)))
    split = {k: float(np.median([r[k] for r in split_runs]))
             for k in split_runs[0]}

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for req in reqs[:3]:
            inference_detector(bundle, req)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side rows (kernels, copies) where the profiler lists them on
    # their own; else the host ops' self device time
    events = [e for e in prof.key_averages()
              if getattr(e, 'self_device_time_total', 0) > 0]
    on_device = [e for e in events if str(e.device_type).endswith('CUDA')]
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in (on_device or events)]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    result = dict(
        card=card, config=args.config, cfg_options=args.cfg_options,
        dtype=str(bundle.model.dtype), requests=args.requests,
        images_per_request=2, stage_ms_median=stages,
        request_ms=request_ms, request_ms_median=float(np.median(request_ms)),
        request_split_ms_median=split,
        profiled_requests=3, profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        top_device_ops=[dict(name=k, device_ms=ms, count=c)
                        for k, ms, c in rows[:25]])
    print(card)
    for k, v in stages.items():
        print(f'stage {k:22s} {v:9.3f} ms (median of {args.requests})')
    print(f'request (inference_detector) ms {[round(x, 3) for x in request_ms]}'
          f' median {result["request_ms_median"]:.3f}')
    for k, v in split.items():
        print(f'request split {k:14s} {v:9.3f} ms (median of {args.requests})')
    print(f'profiled {wall_ms:.3f} ms wall for 3 requests; device busy '
          f'{busy_ms:.3f} ms; idle share {result["device_idle_share"]:.3f}; '
          f'peak {result["peak_gib"]:.3f} GiB')
    for r in result['top_device_ops']:
        print(f'  {r["device_ms"]:9.3f} ms  x{r["count"]:<5d} '
              f'{r["name"][:100]}')
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    main()
