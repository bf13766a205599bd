"""AutoAugment (counterpart of the JAX package's
`data/pipelines/auto_augment.py`): the policy container, which the Swin
`ms-crop-3x` configs use with `Resize` and `RandomCrop` sub-policies. The
JAX package's own geometric and colour ops are registered here so that a
config naming them fails with the reason: they are not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...utils.registry import PIPELINES


@PIPELINES.register_module()
class AutoAugment:
    """One sub-policy (a list of transform configs) per image, picked with
    `results['_rng'].randint(len(policies))`, then applied in order."""

    def __init__(self, policies: List[List[dict]]):
        self.policies = [[PIPELINES.build(cfg) for cfg in policy]
                         for policy in policies]

    def __call__(self, results):
        rng = results.get('_rng', np.random)
        for t in self.policies[rng.randint(len(self.policies))]:
            results = t(results)
        return results


class _UnportedOp:
    """One of the JAX package's AutoAugment image ops: refused."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{type(self).__name__}: the AutoAugment image ops (affine warps '
            'and colour transforms) are not ported; AutoAugment runs Resize '
            'and RandomCrop sub-policies')


for _name in ('Shear', 'Rotate', 'Translate', 'ColorTransform',
              'BrightnessTransform', 'ContrastTransform', 'EqualizeTransform'):
    PIPELINES.register_module(module=type(_name, (_UnportedOp,), {}))
