"""Mask detectors trained from COCO-format polygon data on a CUDA card:
the synth rows and the full-width COCO configs, with their times.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.coco_mask_runs \
        synth [--config configs/da/synth_htc_smoke.py] [--epochs 15] \
        [--out build/coco_runs/synth.json]
    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.coco_mask_runs \
        coco [--out build/coco_runs/coco.json]

`synth` trains configs/da/synth_mask_smoke.py (Mask R-CNN R18-FPN, 56²
box-frame rasters, batch 8 of 128x192, SGD lr 0.01, an evaluation every 5
epochs), or with `--config` one of the configs built on it
(`SYNTH_CONFIGS`: the HTC and SCNet rows, semantic branch off, 128 RoIs
an image; the Mask Scoring R-CNN and PointRend rows), through `apis.train_detector` on the committed polygon split
(tests/data/synth_seg: 200 training images; its 50 test images for the
evaluations), for the config's 15 epochs unless `--epochs` says, and
reports each evaluation's metrics (box AP50 by the loop's VOC protocol),
the mask loss (`mask_loss_of`) of every epoch (the mean over its steps,
and the last step's, which the log records), the wall time, and the step
and loader medians: each step ends in a synchronize, and the loader time
is the wait from one step's end to the next one's start.

`coco` trains each full-width COCO config (Mask R-CNN R50-FPN 1x, its
mstrain-poly 3x variant through `RepeatDataset` and the 'range'
multi-scale resize, R50-C4 1x and Swin-T 1x: 80 classes, 112² rasters,
the 1333x800 scale padded to 800x1344) for one epoch of 2 steps of 2
images (the first 4 training images of the split; the first 2 for the 3x
config, whose dataset repeats them 3 times, so 3 steps), evaluates on 4
test images after it, then runs `tools.test --eval bbox` on the
checkpoint; reports the step times, the evaluation and test seconds and
the metrics.

Every run works in `--work-dir` (build/coco_runs by default) and empties
its run directory when it is done. `--cfg-options` merges dotted
overrides into every config it trains; `--device cpu` rehearses a run
without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ..apis import train as train_api
from ..utils.config import Config, parse_option_value
from . import test as test_cli

SEG_DIR = 'tests/data/synth_seg'
SYNTH_MASK = 'configs/da/synth_mask_smoke.py'
SYNTH_CONFIGS = (SYNTH_MASK, 'configs/da/synth_htc_smoke.py',
                 'configs/da/synth_scnet_smoke.py',
                 'configs/da/synth_maskscoring_smoke.py',
                 'configs/da/synth_pointrend_smoke.py')
COCO_CONFIGS = (
    'configs/mask_rcnn/mask_rcnn_r50_fpn_1x.py',
    'configs/mask_rcnn/mask_rcnn_r50_fpn_mstrain-poly_3x.py',
    'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py',
    'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_1x.py',
)


def card_line(device: str) -> str:
    """`nvidia-smi`'s name and power limit of the card ('cpu' without
    one)."""
    if device == 'cpu':
        return 'cpu'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def mask_loss_of(metrics: Dict[str, float]) -> float:
    """The mask loss of a step's metrics: `loss_mask`, or for a cascade
    the sum of its stages' weighted `s<i>.loss_mask`."""
    return float(sum(v for k, v in metrics.items()
                     if k.split('.')[-1] == 'loss_mask'))


def write_subset(split: str, n: int, path: str) -> str:
    """The first `n` images of the committed split's `split` json and their
    annotations, written to `path`."""
    with open(os.path.join(SEG_DIR, f'{split}.json')) as f:
        coco = json.load(f)
    coco['images'] = coco['images'][:n]
    keep = {im['id'] for im in coco['images']}
    coco['annotations'] = [a for a in coco['annotations']
                           if a['image_id'] in keep]
    with open(path, 'w') as f:
        json.dump(coco, f)
    return path


def split_options(keys_to_ann: Dict[str, str]) -> Dict[str, str]:
    """Dotted overrides that point each dataset key (`data.train`,
    `data.train.dataset`, ...) at an annotation json of the split."""
    out = {}
    for key, ann in keys_to_ann.items():
        out[f'{key}.ann_file'] = ann
        out[f'{key}.img_prefix'] = f'{SEG_DIR}/images/'
    return out


class StepTimer:
    """While entered, spies on the loop (`apis.train`'s `init_trainer` and
    `evaluate_dataset`): each step ends in a synchronize and is timed, its
    metrics read back; the wait before a step is the loader's; each
    evaluation is timed and its metrics kept."""

    def __init__(self, device: str):
        self.sync = torch.cuda.synchronize if device == 'cuda' \
            else (lambda: None)
        self.step_ms: List[float] = []
        self.wait_ms: List[float] = []
        self.metrics: List[Dict[str, float]] = []
        self.eval_s: List[float] = []
        self.evals: List[Dict[str, float]] = []
        self._last = None

    def __enter__(self):
        self._init = train_api.init_trainer
        self._eval = train_api.evaluate_dataset

        def init_trainer(*args, **kwargs):
            trainer = self._init(*args, **kwargs)

            def step(state, batch, generator=None, **kw):
                t0 = time.perf_counter()
                if self._last is not None:
                    self.wait_ms.append(1e3 * (t0 - self._last))
                state, metrics = trainer.step(state, batch, generator, **kw)
                self.sync()
                self._last = time.perf_counter()
                self.step_ms.append(1e3 * (self._last - t0))
                self.metrics.append({k: float(v) for k, v in metrics.items()})
                return state, metrics
            return trainer._replace(step=step)

        def evaluate_dataset(*args, **kwargs):
            t0 = time.perf_counter()
            out = self._eval(*args, **kwargs)
            self.sync()
            self.eval_s.append(time.perf_counter() - t0)
            self.evals.append(out)
            self._last = time.perf_counter()
            return out

        train_api.init_trainer = init_trainer
        train_api.evaluate_dataset = evaluate_dataset
        return self

    def __exit__(self, *exc):
        train_api.init_trainer = self._init
        train_api.evaluate_dataset = self._eval


def _train(cfg: Config, work_dir: str, device: str):
    """`train_detector` under a `StepTimer`: (timer, seconds)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with StepTimer(device) as timer:
        t0 = time.perf_counter()
        train_api.train_detector(cfg, work_dir, device=device)
        seconds = time.perf_counter() - t0
    if not timer.metrics or not all(np.isfinite(v) for m in timer.metrics
                                    for v in m.values()):
        raise RuntimeError(f'{cfg.filename}: losses {timer.metrics}')
    return timer, seconds


def run_synth(work_dir: str, epochs: int, device: str,
              extra: Dict[str, object], config: str = SYNTH_MASK) -> dict:
    """A synth row (see the module docstring)."""
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(split_options({
        'data.train': f'{SEG_DIR}/train.json',
        'data.val': f'{SEG_DIR}/test.json',
        'data.test': f'{SEG_DIR}/test.json'}),
        **{'runner.max_epochs': epochs}, **extra))
    timer, wall_s = _train(cfg, work_dir, device)
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    steps = len(timer.step_ms) // epochs
    return dict(
        config=config, epochs=epochs, steps_per_epoch=steps,
        images_per_step=cfg.data['samples_per_gpu'], wall_s=wall_s,
        val_epochs=[r['epoch'] for r in recs if r['mode'] == 'val'],
        evals=timer.evals,
        loss_mask_epoch_mean=[
            float(np.mean([mask_loss_of(m) for m in
                           timer.metrics[e * steps:(e + 1) * steps]]))
            for e in range(epochs)],
        loss_mask_logged=[mask_loss_of(r) for r in recs
                          if r['mode'] == 'train'],
        step_ms_median=float(np.median(timer.step_ms)),
        step_ms_min=float(np.min(timer.step_ms)),
        loader_wait_ms_median=float(np.median(timer.wait_ms)),
        eval_s=timer.eval_s)


def run_coco(work_dir: str, config: str, device: str,
             extra: Dict[str, object]) -> dict:
    """One full-width COCO config (see the module docstring)."""
    os.makedirs(work_dir, exist_ok=True)
    repeat = 'RepeatDataset' in open(config).read()
    train_json = write_subset('train', 2 if repeat else 4,
                              os.path.join(work_dir, 'train.json'))
    test_json = write_subset('test', 4, os.path.join(work_dir, 'test.json'))
    test_options = split_options({'data.test': test_json})
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(dict(
        split_options({'data.train.dataset' if repeat else 'data.train':
                       train_json, 'data.val': test_json}),
        **test_options, **{'runner.max_epochs': 1, 'evaluation.interval': 1,
                           'checkpoint_config.interval': 1}, **extra))
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    timer, train_s = _train(cfg, work_dir, device)
    t0 = time.perf_counter()
    bbox = test_cli.main([
        config, os.path.join(work_dir, 'ckpt_1'), '--eval', 'bbox',
        '--device', device, '--cfg-options',
        *[f'{k}={v}' for k, v in test_options.items()],
        *[f'{k}={v!r}' for k, v in extra.items()]])
    return dict(config=config, steps=len(timer.step_ms),
                step_ms=timer.step_ms,
                loss_mask=[mask_loss_of(m) for m in timer.metrics],
                train_s=train_s, eval_s=timer.eval_s, evals=timer.evals,
                test_s=time.perf_counter() - t0, bbox=bbox,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30
                if device == 'cuda' else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('what', choices=('synth', 'coco'))
    ap.add_argument('--config', default=SYNTH_MASK, choices=SYNTH_CONFIGS,
                    help='the synth row to train (synth only)')
    ap.add_argument('--epochs', type=int, default=15)
    ap.add_argument('--work-dir', default='build/coco_runs')
    ap.add_argument('--out', default=None,
                    help='json of the results (default: <work-dir>/'
                         '<what>.json, kept)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--cfg-options', nargs='+', default=[],
                    help='dotted config overrides: key=value')
    args = ap.parse_args(argv)
    extra = {kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1])
             for kv in args.cfg_options}
    card = card_line(args.device)
    print(card, flush=True)
    run_dir = os.path.join(args.work_dir, 'run')
    shutil.rmtree(run_dir, ignore_errors=True)
    if args.what == 'synth':
        results = [run_synth(run_dir, args.epochs, args.device, extra,
                             args.config)]
    else:
        results = []
        for config in COCO_CONFIGS:
            results.append(run_coco(run_dir, config, args.device, extra))
            shutil.rmtree(run_dir)
            gc.collect()
            if args.device == 'cuda':
                torch.cuda.empty_cache()
    shutil.rmtree(run_dir, ignore_errors=True)
    for r in results:
        print(json.dumps(r), flush=True)
    out = args.out or os.path.join(args.work_dir, f'{args.what}.json')
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out, 'w') as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    return results


if __name__ == '__main__':
    main()
