"""Domain-adaptive ResNet trunk (counterpart of the JAX package's
`models/backbones/da_resnet.py`).

The trunk is the JAX one's: a `ResNet` named `trunk`, so the converted
weights load as `backbone.trunk.*`. Each entry of `taps` puts a GRL
alignment head on a stage, named `{kind}_s{stage}_{i}` as in the JAX
module (so its weights load as `backbone.pixel_s1_0.*`). `with_da=False`
(inference) skips the heads. Every tap kind of the JAX module is here:
'pixel', 'global' (CBAM, MHSA or no attention), 'srm' and 'image'.

An MHSA global head's relative position parameters have the size of its
attention map, which the JAX module takes from the first training batch.
Here they are made when the trunk is built, from `canvas`, the static
(H, W) training canvas (the config's `Pad` size): the head's map is the
tap's stage map halved by its stride-2 conv, e.g. 16x32 at C4 and at the
dilated C5 for a 512x1024 canvas. Training on another canvas raises;
inference never runs the heads and takes any.

`dtype` is the trunk's compute type. The heads have none, as in the JAX
module: on a bf16 trunk they run in f32 on the upcast tap, and the GRL's
gradient flows back into the bf16 trunk.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..da.heads import (GlobalAlignmentHead, ImageAlignmentHead,
                        PixelAlignmentHead, SRMHead)
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


def _halve(n: int) -> int:
    """The size after a stride-2 conv or pool padded by k // 2."""
    return -(-n // 2)


def stage_map_hw(canvas: Tuple[int, int], strides: Sequence[int],
                 stage: int) -> Tuple[int, int]:
    """The (h, w) of stage `stage`'s output for an image of `canvas`: the
    stride-2 stem and max-pool, then each stage's stride up to it."""
    h, w = canvas
    for _ in range(2 + sum(s == 2 for s in strides[:stage + 1])):
        h, w = _halve(h), _halve(w)
    return h, w


@BACKBONES.register_module()
class DAResNet(nn.Module):
    """Detection trunk + per-stage GRL alignment heads."""

    def __init__(self, depth: int = 50,
                 strides: Sequence[int] = (1, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 2),
                 out_indices: Sequence[int] = (3,),
                 frozen_stages: int = 1,
                 taps: Tuple[Tap, ...] = VARIANT_TAPS['daf'],
                 trunk_type: str = 'resnet',
                 canvas: Tuple[int, int] = (512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if trunk_type != 'resnet':
            raise NotImplementedError(
                f'trunk_type {trunk_type!r}: only the ResNet trunk is ported; '
                'the Swin trunk (DeepAlign-Swin) comes with the rest of the '
                'DA family, ROADMAP.md Queue 1')
        self.out_indices = tuple(out_indices)
        self.taps = tuple(taps)
        self.trunk = ResNet(depth=depth, strides=tuple(strides),
                            dilations=tuple(dilations),
                            out_indices=self.out_indices,
                            frozen_stages=frozen_stages, dtype=dtype)
        channels = self.trunk.stage_channels()
        self.tap_names = tuple(f'{t.kind}_s{t.stage}_{i}'
                               for i, t in enumerate(self.taps))
        for name, tap in zip(self.tap_names, self.taps):
            c = channels[tap.stage]
            if tap.kind == 'global':
                map_hw = None
                if tap.attention == 'mhsa':
                    map_hw = tuple(_halve(n) for n in stage_map_hw(
                        canvas, strides, tap.stage))
                head = GlobalAlignmentHead(c, attention=tap.attention,
                                           map_hw=map_hw)
            elif tap.kind == 'srm':
                head = SRMHead(c)
            elif tap.kind == 'pixel':
                head = PixelAlignmentHead(c)
            elif tap.kind == 'image':
                head = ImageAlignmentHead(c)
            else:
                raise ValueError(f'unknown tap kind {tap.kind!r}')
            self.add_module(name, head)

    def forward(self, x: torch.Tensor, with_da: bool = True):
        """x: (B, 3, H, W). Returns (outs, da_out): the stage outputs at
        `out_indices` and, with `with_da`, each tap's head output by name —
        (B, 2) global and SRM logits or (B, H, W, 1) pixel and image logit
        maps."""
        stages = self.trunk(x, return_all_stages=True)
        outs = tuple(stages[i] for i in self.out_indices)
        if not with_da:
            return outs, {}
        return outs, {name: getattr(self, name)(stages[tap.stage])
                      for name, tap in zip(self.tap_names, self.taps)}
