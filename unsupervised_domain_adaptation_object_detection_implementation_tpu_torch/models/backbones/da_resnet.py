"""Domain-adaptive ResNet trunk (counterpart of the JAX package's
`models/backbones/da_resnet.py`), inference part.

The trunk is the JAX one's: a `ResNet` named `trunk`, so the converted
weights load as `backbone.trunk.*`. The GRL alignment heads that the `taps`
name (pixel / global / srm / image) are training-time only and are not
ported yet: `with_da=False` returns the trunk's outputs exactly as the JAX
module does at inference, and asking for the heads raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...utils.registry import BACKBONES
from .resnet import ResNet


class Tap(NamedTuple):
    stage: int                      # 0..3 (C2..C5)
    kind: str                       # 'global' | 'srm' | 'pixel' | 'image'
    attention: Optional[str] = None  # for 'global': 'cbam' | 'mhsa' | None


VARIANT_TAPS: Dict[str, Tuple[Tap, ...]] = {
    'daf': (Tap(1, 'pixel'), Tap(2, 'global', 'cbam'),
            Tap(3, 'global', 'cbam')),
    'daf_org': (Tap(3, 'image'),),
    'maf': (Tap(1, 'srm'), Tap(2, 'srm'), Tap(3, 'srm')),
    'swda': (Tap(1, 'pixel'), Tap(2, 'global', 'cbam')),
    'deep': (Tap(1, 'pixel'), Tap(2, 'pixel'), Tap(2, 'global', 'cbam'),
             Tap(3, 'global', 'cbam')),
    'tri': (Tap(1, 'pixel'), Tap(2, 'pixel'), Tap(2, 'global', 'mhsa'),
            Tap(3, 'global', 'mhsa')),
}


@BACKBONES.register_module()
class DAResNet(nn.Module):
    """Detection trunk; the per-stage alignment heads wait for the
    training slice."""

    def __init__(self, depth: int = 50,
                 strides: Sequence[int] = (1, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 2),
                 out_indices: Sequence[int] = (3,),
                 frozen_stages: int = 1,
                 taps: Tuple[Tap, ...] = VARIANT_TAPS['daf'],
                 trunk_type: str = 'resnet'):
        super().__init__()
        if trunk_type != 'resnet':
            raise NotImplementedError(
                f'trunk_type {trunk_type!r}: only the ResNet trunk is ported')
        self.out_indices = tuple(out_indices)
        self.taps = tuple(taps)
        self.trunk = ResNet(depth=depth, strides=tuple(strides),
                            dilations=tuple(dilations),
                            out_indices=self.out_indices,
                            frozen_stages=frozen_stages)

    def forward(self, x: torch.Tensor, with_da: bool = True):
        """x: (B, 3, H, W). Returns (outs, da_out); only `with_da=False`
        (inference: no alignment heads, `da_out` empty) is ported."""
        if with_da:
            raise NotImplementedError(
                'training slice: the DA alignment heads '
                f'{[t.kind for t in self.taps]} are not ported yet')
        stages = self.trunk(x, return_all_stages=True)
        return tuple(stages[i] for i in self.out_indices), {}
