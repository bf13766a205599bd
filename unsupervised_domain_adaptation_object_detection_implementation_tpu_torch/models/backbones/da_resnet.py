"""Domain-adaptive ResNet trunk (counterpart of the JAX package's
`models/backbones/da_resnet.py`).

The trunk is the JAX one's: a `ResNet` named `trunk`, so the converted
weights load as `backbone.trunk.*`. Each entry of `taps` puts a GRL
alignment head on a stage, named `{kind}_s{stage}_{i}` as in the JAX
module (so its weights load as `backbone.pixel_s1_0.*`). `with_da=False`
(inference) skips the heads. The 'pixel' and CBAM 'global' heads are ported
(the 'daf', 'swda' and 'deep' variants); 'srm', 'image' and MHSA 'global'
taps come with their variants, and `with_da=True` raises for them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..da.heads import GlobalAlignmentHead, PixelAlignmentHead
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
    """Detection trunk + per-stage GRL alignment heads."""

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
        channels = self.trunk.stage_channels()
        self.tap_names = tuple(f'{t.kind}_s{t.stage}_{i}'
                               for i, t in enumerate(self.taps))
        self._missing = []
        for name, tap in zip(self.tap_names, self.taps):
            if tap.kind == 'pixel':
                self.add_module(name, PixelAlignmentHead(channels[tap.stage]))
            elif tap.kind == 'global' and tap.attention in ('cbam', None):
                self.add_module(name, GlobalAlignmentHead(
                    channels[tap.stage], attention=tap.attention))
            else:
                self._missing.append(name)

    def forward(self, x: torch.Tensor, with_da: bool = True):
        """x: (B, 3, H, W). Returns (outs, da_out): the stage outputs at
        `out_indices` and, with `with_da`, each tap's head output by name —
        (B, 2) global logits or (B, H, W, 1) pixel logit maps."""
        if with_da and self._missing:
            raise NotImplementedError(
                f'DA taps {self._missing} (srm / image / MHSA heads) are not '
                'ported yet; they come with the other DA variants')
        stages = self.trunk(x, return_all_stages=True)
        outs = tuple(stages[i] for i in self.out_indices)
        if not with_da:
            return outs, {}
        return outs, {name: getattr(self, name)(stages[tap.stage])
                      for name, tap in zip(self.tap_names, self.taps)}
