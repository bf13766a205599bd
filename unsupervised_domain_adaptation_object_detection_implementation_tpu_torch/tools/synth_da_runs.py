"""The synth clear→foggy rows on a CUDA card: the three-row UDAOD
protocol (source-only, DAF + clip + EMA, oracle), SWDA, and the zoo rows
(Cascade R-CNN, R18-FPN, Double-Head, Grid and Dynamic R-CNN, CRPN-Faster
R-CNN, GA-Faster R-CNN, GA-RetinaNet, the one-stage core: RetinaNet,
FCOS, ATSS, GFL and PAA, RetinaNet and GFL also with anchors fitted to the
set's 24–34 px shapes, and the RetinaNet-derived heads: FreeAnchor, FSAF,
FoveaBox, SABL-RetinaNet, PISA-RetinaNet, SABL and PISA Faster R-CNN),
each beside the JAX package's figure.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.synth_da_runs \
        <row> [<row> ...] [--seed 0] [--max-epochs k] [--resume-from <ckpt>] \
        [--data-dir tests/data/synth_da] [--work-dir build/synth_da_runs] \
        [--cfg-options key=value ...] [--device cuda]

Each row (`ROWS`) is a config of `configs/da/` with its overrides,
trained through the port's own command line (`tools.DA_train` for the DA
rows, `tools.train` for the zoo rows) on the committed synth set
(`tests/data/synth_da/`: `tools/misc/make_synthetic_da_dataset.py <out>`,
seed 0, 200 train + 50 test images a domain), from seeded random weights
(R18 from scratch; the DA rows' RPN and box heads at the lecun scale,
`LECUN`) in f32. The configs build their paths from
`/tmp/synth_da/` when they are parsed, so every dataset's `ann_file` and
`img_prefix` is redirected (`data_options`); `--data-dir` points them at
another set of the same layout (`tests/data/synth_da_small` for a CPU
rehearsal).

A row reports the target AP50 of every evaluation (the loop's VOC
protocol, every 5 epochs), the mean of each loss term over every epoch's
steps, the wall seconds, the step median (each step ends in a
synchronize), the loader-wait median (from one step's end to the next
one's start) and the card line (`nvidia-smi`'s name and power limit).

A row can be split: `--max-epochs k` stops it after epoch k with a
checkpoint `ckpt_k` in its run directory (`<work-dir>/<row>/`), and
`--resume-from <work-dir>/<row>/ckpt_k` goes on from there to the
config's last epoch (the loop's resume is bit-exact; the log of the
whole row is read back from the run directory). A row that reaches its
last epoch empties its run directory; its report is `<work-dir>/<row>.json`
(or `--out`, with one row) and is printed as a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..utils import checkpoint as ckpt_io
from ..utils.config import Config
from . import DA_train, train as train_cli
from .coco_mask_runs import StepTimer, card_line

DATA_DIR = 'tests/data/synth_da'
CONFIG_ROOT = '/tmp/synth_da/'
WORK_DIR = 'build/synth_da_runs'


class Row(NamedTuple):
    config: str
    options: Dict[str, str]     # --cfg-options beside the data redirect
    cli: str                    # 'DA_train' or 'train'
    trains_on: tuple            # (domain, split) of each training dataset
    evaluates_on: str           # the domain of the 50 test images
    jax_ap50: float
    source: str                 # where the JAX figure stands


SYNTH = 'configs/da/faster_rcnn_r18_synth_shapes.py'
ZOO = 'configs/da/synth_zoo_smoke.py'
# the DA rows draw the RPN and box heads at the lecun scale, as the JAX
# rows did (flax's default for every layer): at mmdet's scale the port's
# DAF and oracle rows missed their JAX figures and DAF fell to source-only
# (PERF.md, gate 3); the zoo rows keep mmdet's (their lr is 0.01), but
# for Grid R-CNN, GA-Faster R-CNN and the one-stage core
LECUN = {'random_init.heads': 'lecun'}
ROWS = {
    'source_only': Row('configs/da/faster_rcnn_r18_synth_source_only.py',
                       LECUN, 'DA_train', (('shapes_clear', 'train'),),
                       'shapes_foggy', 0.167, 'docs/RESULTS.md:40'),
    'daf': Row(SYNTH, LECUN, 'DA_train',
               (('shapes_clear', 'train'), ('shapes_foggy', 'train')),
               'shapes_foggy', 0.373, 'docs/RESULTS.md:41'),
    'oracle': Row('configs/da/faster_rcnn_r18_synth_oracle.py', LECUN,
                  'DA_train', (('shapes_foggy', 'train'),), 'shapes_foggy',
                  0.488, 'docs/RESULTS.md:42'),
    'swda': Row(SYNTH, dict(LECUN, **{'model.type': 'FasterRCNN_SWDA',
                                      'runner.max_epochs': '60',
                                      'lr_config.step': '[45, 55]'}),
                'DA_train',
                (('shapes_clear', 'train'), ('shapes_foggy', 'train')),
                'shapes_foggy', 0.307, 'docs/RESULTS.md:261-266'),
    'cascade': Row(ZOO, {'model.type': 'CascadeRCNN'}, 'train',
                   (('shapes_clear', 'train'),), 'shapes_clear', 0.973,
                   'docs/RESULTS.md:281'),
    'fpn': Row(ZOO, {'model.type': 'FasterRCNNFPN'}, 'train',
               (('shapes_clear', 'train'),), 'shapes_clear', 0.943,
               'docs/RESULTS.md:293'),
    'double_head': Row(ZOO, {'model.type': 'DoubleHeadRCNN'}, 'train',
                       (('shapes_clear', 'train'),), 'shapes_clear', 0.950,
                       'docs/RESULTS.md:291'),
    # Grid R-CNN's heads at the lecun scale: at mmdet's its grid head
    # learned late and the row missed (PERF.md §6, the RoI-head variants)
    'grid': Row(ZOO, dict(LECUN, **{'model.type': 'GridRCNN'}), 'train',
                (('shapes_clear', 'train'),), 'shapes_clear', 0.801,
                'docs/RESULTS.md:296'),
    # the JAX record ran the zoo config for 30 epochs (docs/RESULTS.md:693)
    # with its lr step at epoch 12; a step at 24 left three seeds at 0.10
    # (PERF.md §6, the RoI-head variants)
    'dynamic': Row(ZOO, {'model.type': 'DynamicRCNN',
                         'runner.max_epochs': '30'},
                   'train', (('shapes_clear', 'train'),), 'shapes_clear',
                   0.366, 'docs/RESULTS.md:311, :693'),
    'crpn_faster': Row(ZOO, {'model.type': 'CRPNFasterRCNN'}, 'train',
                       (('shapes_clear', 'train'),), 'shapes_clear', 0.938,
                       'docs/RESULTS.md:696'),
    # GA-Faster R-CNN's heads at the lecun scale: at mmdet's its GA-RPN
    # learned unstably and the row missed (PERF.md §6, the proposal family)
    'ga_faster': Row(ZOO, dict(LECUN, **{'model.type': 'GAFasterRCNN'}),
                     'train',
                     (('shapes_clear', 'train'),), 'shapes_clear', 0.528,
                     'docs/RESULTS.md:681'),
    'ga_retina': Row('configs/da/synth_ga_retina_smoke.py', {}, 'train',
                     (('shapes_clear', 'train'),), 'shapes_clear', 0.554,
                     'docs/RESULTS.md:679'),
    # the one-stage core on the zoo config, its heads at the lecun scale:
    # at mmdet's std 0.01 its towers learned slowly and every row missed
    # (PERF.md §6, the one-stage core)
    'retinanet': Row(ZOO, dict(LECUN, **{'model.type': 'RetinaNet'}),
                     'train', (('shapes_clear', 'train'),), 'shapes_clear',
                     0.412, 'docs/RESULTS.md:308'),
    'retinanet_fit': Row(ZOO, dict(LECUN, **{
        'model.type': 'RetinaNet',
        'model.anchor_cfg.octave_base_scale': '2'}), 'train',
        (('shapes_clear', 'train'),), 'shapes_clear', 0.712,
        'docs/RESULTS.md:309'),
    'fcos': Row(ZOO, dict(LECUN, **{'model.type': 'FCOS'}), 'train',
                (('shapes_clear', 'train'),), 'shapes_clear', 0.808,
                'docs/RESULTS.md:301'),
    'atss': Row(ZOO, dict(LECUN, **{'model.type': 'ATSS'}), 'train',
                (('shapes_clear', 'train'),), 'shapes_clear', 0.829,
                'docs/RESULTS.md:300'),
    'gfl': Row(ZOO, dict(LECUN, **{'model.type': 'GFL'}), 'train',
               (('shapes_clear', 'train'),), 'shapes_clear', 0.463,
               'docs/RESULTS.md:306'),
    'gfl_fit': Row(ZOO, dict(LECUN, **{'model.type': 'GFL',
                                       'model.anchor_scale': '3'}),
                   'train', (('shapes_clear', 'train'),), 'shapes_clear',
                   0.777, 'docs/RESULTS.md:307'),
    'paa': Row(ZOO, dict(LECUN, **{'model.type': 'PAA'}), 'train',
               (('shapes_clear', 'train'),), 'shapes_clear', 0.722,
               'docs/RESULTS.md:303'),
    # the RetinaNet-derived heads: the one-stage rows on the zoo config at
    # the lecun head scale, as the one-stage core's; the two-stage rows on
    # their own smoke configs at mmdet's, as the FPN and cascade rows
    'free_anchor': Row(ZOO, dict(LECUN, **{'model.type': 'FreeAnchor'}),
                       'train', (('shapes_clear', 'train'),), 'shapes_clear',
                       0.963, 'docs/RESULTS.md:287'),
    'fsaf': Row(ZOO, dict(LECUN, **{'model.type': 'FSAF'}), 'train',
                (('shapes_clear', 'train'),), 'shapes_clear', 0.838,
                'docs/RESULTS.md:299'),
    'fovea': Row(ZOO, dict(LECUN, **{'model.type': 'FoveaBox'}), 'train',
                 (('shapes_clear', 'train'),), 'shapes_clear', 0.917,
                 'docs/RESULTS.md:295'),
    'sabl_retina': Row(ZOO, dict(LECUN, **{'model.type': 'SABLRetinaNet'}),
                       'train', (('shapes_clear', 'train'),), 'shapes_clear',
                       0.952, 'docs/RESULTS.md:290'),
    'pisa_retina': Row(ZOO, dict(LECUN, **{'model.type': 'PISARetinaNet'}),
                       'train', (('shapes_clear', 'train'),), 'shapes_clear',
                       0.880, 'docs/RESULTS.md:680'),
    'sabl_faster': Row('configs/da/synth_sabl_smoke.py', {}, 'train',
                       (('shapes_clear', 'train'),), 'shapes_clear', 0.939,
                       'docs/RESULTS.md:678'),
    'pisa_faster': Row('configs/da/synth_pisa_faster_smoke.py', {}, 'train',
                       (('shapes_clear', 'train'),), 'shapes_clear', 0.912,
                       'docs/RESULTS.md:677'),
}


def _datasets(data: dict):
    """(dotted key, dataset dict) of every dataset of a config's `data`
    block: the train split's (each of a `ConcatDataset`'s), val and test."""
    for split in ('train', 'val', 'test'):
        ds = data.get(split)
        if ds is None:
            continue
        if ds.get('type') == 'ConcatDataset':
            for i, sub in enumerate(ds['datasets']):
                yield f'data.{split}.datasets.{i}', sub
        else:
            yield f'data.{split}', ds


def data_options(cfg: Config, data_dir: str = DATA_DIR) -> Dict[str, str]:
    """Dotted overrides that move every dataset's `ann_file` and
    `img_prefix` from the configs' /tmp/synth_da/ to `data_dir`; raises on
    a path elsewhere."""
    out = {}
    for key, ds in _datasets(cfg.data):
        for field in ('ann_file', 'img_prefix'):
            path = ds[field]
            if not path.startswith(CONFIG_ROOT):
                raise ValueError(f'{key}.{field}={path!r} is not under '
                                 f'{CONFIG_ROOT}')
            out[f'{key}.{field}'] = \
                f'{data_dir.rstrip("/")}/{path[len(CONFIG_ROOT):]}'
    return out


def row_argv(name: str, work_dir: str, data_dir: str = DATA_DIR,
             extra: Optional[List[str]] = None) -> List[str]:
    """The command line of row `name`: its config, work dir, and the
    --cfg-options of the row, the data redirect and `extra` (key=value)."""
    row = ROWS[name]
    options = [f'{k}={v}' for k, v in row.options.items()] + list(extra or [])
    cfg = train_cli.load_config(train_cli.parse_args(
        [row.config, '--cfg-options', *options] if options
        else [row.config]))
    options += [f'{k}={v}' for k, v in data_options(cfg, data_dir).items()]
    return [row.config, '--work-dir', work_dir, '--cfg-options', *options]


def _epoch_means(metrics: List[Dict[str, float]], first: int, epochs: int):
    """{epoch: {term: mean over the epoch's steps}} of a run's steps."""
    steps = len(metrics) // max(epochs, 1)
    return {first + e: {k: float(np.mean([m[k] for m in
                                          metrics[e * steps:(e + 1) * steps]]))
                        for k in metrics[0]}
            for e in range(epochs)} if metrics else {}


def run_row(name: str, work_dir: str, device: str, seed: int = 0,
            max_epochs: Optional[int] = None,
            resume_from: Optional[str] = None, data_dir: str = DATA_DIR,
            extra: Optional[List[str]] = None) -> dict:
    """Train row `name` (see the module docstring) in `work_dir`; returns
    its report."""
    row = ROWS[name]
    cli = DA_train if row.cli == 'DA_train' else train_cli
    argv = row_argv(name, work_dir, data_dir, extra) + [
        '--seed', str(seed), '--device', device]
    if max_epochs:
        argv += ['--max-epochs', str(max_epochs)]
    if resume_from:
        argv += ['--resume-from', resume_from]
    else:
        shutil.rmtree(work_dir, ignore_errors=True)
    cfg = train_cli.load_config(train_cli.parse_args(argv))
    epochs = max_epochs or cfg.runner['max_epochs']
    first = ckpt_io.load_meta(resume_from)['epoch'] if resume_from else 0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with StepTimer(device) as timer:
        t0 = time.perf_counter()
        cli.main(argv)
        wall_s = time.perf_counter() - t0
    if not timer.metrics or not all(np.isfinite(v) for m in timer.metrics
                                    for v in m.values()):
        raise RuntimeError(f'{name}: losses {timer.metrics}')
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    val = [r for r in recs if r['mode'] == 'val']
    done = epochs == cfg.runner['max_epochs']
    return dict(
        row=name, config=row.config, options=row.options, seed=seed,
        device=device, data_dir=data_dir, extra=list(extra or []),
        trains_on=[f'{d}/{s}' for d, s in row.trains_on],
        evaluates_on=f'{row.evaluates_on}/test',
        jax_ap50=row.jax_ap50, jax_source=row.source,
        epochs=[first + 1, epochs], split=dict(
            resumed_from=resume_from,
            stopped_after=None if done else epochs),
        steps_per_epoch=len(timer.step_ms) // max(epochs - first, 1),
        ap50={r['epoch']: r['AP50'] for r in val},
        final_ap50=val[-1]['AP50'] if done and val else None,
        loss_epoch_means=_epoch_means(timer.metrics, first + 1,
                                      epochs - first),
        wall_s=wall_s, eval_s=timer.eval_s,
        step_ms_median=float(np.median(timer.step_ms)),
        step_ms_min=float(np.min(timer.step_ms)),
        loader_wait_ms_median=float(np.median(timer.wait_ms))
        if timer.wait_ms else None,
        records=recs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('rows', nargs='+', choices=sorted(ROWS))
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--max-epochs', type=int, default=None,
                    help='stop after this epoch, keeping ckpt_<k>')
    ap.add_argument('--resume-from', default=None,
                    help='a ckpt_<k> of the row to go on from (one row)')
    ap.add_argument('--data-dir', default=DATA_DIR)
    ap.add_argument('--work-dir', default=WORK_DIR)
    ap.add_argument('--out', default=None,
                    help='json of the report (one row; default '
                         '<work-dir>/<row>.json)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--cfg-options', nargs='+', default=[],
                    help='dotted config overrides: key=value')
    args = ap.parse_args(argv)
    if (args.resume_from or args.out) and len(args.rows) > 1:
        raise SystemExit('--resume-from and --out take one row')
    card = card_line(args.device)
    print(card, flush=True)
    reports = []
    for name in args.rows:
        run_dir = os.path.join(args.work_dir, name)
        report = dict(run_row(name, run_dir, args.device, args.seed,
                              args.max_epochs, args.resume_from,
                              args.data_dir, args.cfg_options), card=card)
        if report['split']['stopped_after'] is None:
            shutil.rmtree(run_dir, ignore_errors=True)
        out = args.out or os.path.join(args.work_dir, f'{name}.json')
        os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
        with open(out, 'w') as f:
            json.dump(report, f, indent=1)
        print(json.dumps({k: v for k, v in report.items()
                          if k != 'records'}), flush=True)
        reports.append(report)
        if args.device == 'cuda':
            torch.cuda.empty_cache()
    return reports


if __name__ == '__main__':
    main()
