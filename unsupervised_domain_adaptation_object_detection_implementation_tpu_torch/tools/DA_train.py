"""Domain-adaptation training command line (counterpart of the JAX
package's `tools/DA_train.py`): the arguments of `tools/train.py`; it
prints each domain's dataset size, then trains. The two-stream
source/target loader comes with a `ConcatDataset` of a source and a target
dataset.

    python -m unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.DA_train \
        configs/da/faster_rcnn_r18_synth_shapes.py --work-dir <dir>
"""

from __future__ import annotations

from ..data import build_dataset
from .train import load_config, main as train_main, parse_args


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args)
    train_cfg = cfg.data['train']
    if train_cfg.get('type') == 'ConcatDataset':
        for sub in train_cfg['datasets']:
            ds = build_dataset(sub, 'cpu')     # counted, never sampled
            print(f"[DA_train] {sub.get('domain', 'source')} dataset: "
                  f"{len(ds)} images")
    return train_main(argv)


if __name__ == '__main__':
    main()
