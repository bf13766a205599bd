"""Training command line (counterpart of the JAX package's `tools/train.py`,
same arguments, plus `--device`):

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.train \
        <config> --work-dir <dir> [--cfg-options key=value ...]

Writes the resolved config to `<work-dir>/config.py`, then runs
`apis.train_detector`. `load_from` and `resume_from` in the config count
where the flags are absent. `--device` defaults to cuda and raises without
a card.

Several ranks: `--n-devices k` starts k ranks from this one process (one
card each; gloo ranks with `--device cpu`); `--launcher jax` makes this
process one rank of a process group, which a `dist_params` block in the
config (or `--cfg-options dist_params.coordinator_address=host:port
dist_params.num_processes=N dist_params.process_id=i`) or the
`MASTER_ADDR` / `RANK` / `WORLD_SIZE` environment describes; a `mesh =
dict(data=-1, model=k)` block splits the box head over k ranks. Rank 0
alone writes the config and prints the work dir.
"""

from __future__ import annotations

import argparse
import os

from ..apis.train import train_detector
from ..parallel.multihost import process_index
from ..utils.config import Config, parse_option_value


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume-from', default=None,
                   help="a ckpt_<tag> directory, or 'auto' for the work "
                        "dir's latest")
    p.add_argument('--load-from', default=None,
                   help='a ckpt_<tag> directory whose weights to start from')
    p.add_argument('--pretrained-backbone', default=None,
                   help='not ported: raises')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-epochs', type=int, default=None)
    p.add_argument('--n-devices', type=int, default=None)
    p.add_argument('--launcher', choices=['none', 'jax'], default='none',
                   help="'jax': this process is one rank of a process group "
                        '(a dist_params block, or MASTER_ADDR/RANK/'
                        'WORLD_SIZE)')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='dotted config overrides: key=value')
    p.add_argument('--device', default='cuda',
                   help="the device to train on ('cuda' or 'cpu')")
    return p.parse_args(argv)


def load_config(args) -> Config:
    """The config file with the `--cfg-options` overrides applied."""
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict({
            kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1])
            for kv in args.cfg_options})
    return cfg


def main(argv=None):
    """Parse `argv` and train. Returns the last evaluation's metrics."""
    args = parse_args(argv)
    cfg = load_config(args)
    work_dir = args.work_dir or os.path.join(
        'work_dirs', os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    if process_index(cfg.get('dist_params')) == 0:
        cfg.dump(os.path.join(work_dir, 'config.py'))
        print(f'[train] work dir: {work_dir}')
    metrics = train_detector(
        cfg, work_dir,
        resume_from=args.resume_from or cfg.get('resume_from'),
        load_from=args.load_from or cfg.get('load_from'),
        pretrained_backbone=args.pretrained_backbone, seed=args.seed,
        max_epochs=args.max_epochs, n_devices=args.n_devices,
        launcher=None if args.launcher == 'none' else args.launcher,
        log_interval=(cfg.get('log_config') or {}).get('interval', 50),
        device=args.device)
    print('final metrics:', metrics)
    return metrics


if __name__ == '__main__':
    main()
