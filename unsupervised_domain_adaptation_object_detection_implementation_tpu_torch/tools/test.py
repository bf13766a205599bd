"""Evaluation command line (counterpart of the JAX package's
`tools/test.py`): a port checkpoint's detections on the config's test set
and their metrics.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.test \
        <config> <work_dir>/ckpt_<tag> --eval mAP

The checkpoint's EMA parameters are used when it holds them (as the
training loop evaluates); without a checkpoint the weights are seeded
random ones. Test-time augmentation and `--show-dir` are not ported and
raise. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
import pickle

from ..apis.inference import init_detector
from ..apis.test import run_inference
from ..data import build_dataset
from ..utils.config import Config, parse_option_value


def main(argv=None):
    p = argparse.ArgumentParser(description='Test a detector')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--eval', default='mAP', help='mAP | recall')
    p.add_argument('--out', default=None, help='save raw results (.pkl)')
    p.add_argument('--show-dir', default=None, help='not ported: raises')
    p.add_argument('--flip-tta', action='store_true',
                   help='not ported: raises')
    p.add_argument('--scale-tta', type=float, nargs='+', default=[],
                   help='not ported: raises')
    p.add_argument('--samples-per-batch', type=int, default=2)
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if args.show_dir:
        raise NotImplementedError('--show-dir: drawing detections is not '
                                  'ported')

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict({
            kv.split('=', 1)[0]: parse_option_value(kv.split('=', 1)[1])
            for kv in args.cfg_options})
    bundle = init_detector(cfg, device=args.device,
                           checkpoint=args.checkpoint)
    print(f'[test] loaded {args.checkpoint}' if args.checkpoint else
          '[test] WARNING: no checkpoint — random weights')
    dataset = build_dataset(dict(cfg.data['test'], test_mode=True),
                            bundle.device)
    results = run_inference(bundle.model, dataset, args.samples_per_batch,
                            flip_tta=args.flip_tta,
                            scale_tta=tuple(args.scale_tta))
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
        print(f'[test] raw results saved to {args.out}')
    metrics = dataset.evaluate(results, metric=args.eval)
    print('metrics:', {k: round(float(v), 4) for k, v in metrics.items()})
    return metrics


if __name__ == '__main__':
    main()
