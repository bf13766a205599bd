"""Adversarial domain-alignment heads behind a GRL (counterpart of the JAX
package's `models/da/heads.py`: `GlobalAlignmentHead` with CBAM or MHSA
attention, `SRMHead`, `PixelAlignmentHead`, `ImageAlignmentHead` and
`InstanceAlignmentHead`).

Every head emits logits. The map heads take the trunk's NCHW stage output;
the pixel and image heads return their logit maps as (B, H, W, 1), the JAX
layout.
The heads compute in f32 whatever the trunk's type: their convs and
linears (`layers/precision.py`) upcast a bf16 tap, as flax promotes bf16
features and f32 parameters to f32 in a module given no `dtype`; the GRL
sits before that cast, so its gradient goes back in the tap's type.
Module names are the flax ones, and where flax gives a conv or dense a bias
by default, so has the port. Dropout is flax's: keep probability 1 - rate,
kept values scaled by 1 / (1 - rate); under data parallelism a rank's mask
is its rows of the global batch's (`parallel/batch.py:Dropout`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...parallel.batch import Dropout
from ..layers.attention import CBAM, MHSA, NonLocalBlock
from ..layers.grl import gradient_reverse
from ..layers.norm import BatchNorm
from ..layers.precision import Conv2d, Linear


class GlobalAlignmentHead(nn.Module):
    """GRL → stride-2 conv → residual conv pair with CBAM or MHSA → two
    stride-2 convs → global average pool → MLP → 2 domain logits.

    MHSA's relative position parameters have the size of the map after the
    stride-2 conv, so `attention='mhsa'` needs `map_hw`, that size."""

    def __init__(self, channels: int, attention: Optional[str] = 'cbam',
                 grl_weight: float = -1.0, dropout: float = 0.5,
                 map_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        if attention not in ('cbam', 'mhsa', None):
            raise ValueError(f'global head attention {attention!r}')
        if attention == 'mhsa' and map_hw is None:
            raise ValueError('an MHSA global head needs map_hw, the size of '
                             'its attention map')
        c2, c4 = channels // 2, channels // 4
        self.grl_weight = grl_weight
        self.conv1 = Conv2d(channels, c2, 3, stride=2, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(c2)
        self.conv2 = Conv2d(c2, c2, 3, padding=1)
        self.bn2 = BatchNorm(c2)
        self.conv3 = Conv2d(c2, c2, 3, padding=1)
        self.bn3 = BatchNorm(c2)
        self.cbam = CBAM(c2) if attention == 'cbam' else None
        self.mhsa = MHSA(c2, map_hw) if attention == 'mhsa' else None
        self.conv4 = Conv2d(c2, c4, 3, stride=2, padding=1, bias=False)
        self.bn4 = BatchNorm(c4)
        self.conv5 = Conv2d(c4, c4, 3, stride=2, padding=1, bias=False)
        self.bn5 = BatchNorm(c4)
        self.fc1 = Linear(c4, c4 // 2)
        self.fc2 = Linear(c4 // 2, 2)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, 2)."""
        x = gradient_reverse(x, self.grl_weight)
        res = self.drop(torch.relu(self.bn1(self.conv1(x))))
        t = self.drop(torch.relu(self.bn2(self.conv2(res))))
        t = self.drop(self.bn3(self.conv3(t)))
        if self.cbam is not None:
            t = self.cbam(t)
        elif self.mhsa is not None:
            t = self.mhsa(t)
        x = torch.relu(t + res)
        x = self.drop(torch.relu(self.bn4(self.conv4(x))))
        x = self.drop(torch.relu(self.bn5(self.conv5(x))))
        x = x.mean(dim=(2, 3))
        x = self.drop(torch.relu(self.fc1(x)))
        return self.fc2(x)


class SRMHead(nn.Module):
    """MAF's per-stage classifier: GRL → 1x1 conv to C/4 (BN, ReLU,
    dropout) → 3x3 conv to 9·C/4 padded by 3, so the map grows by 4 (BN,
    ReLU, dropout) → global average pool → FC → 2 domain logits."""

    def __init__(self, channels: int, grl_weight: float = -1.0,
                 dropout: float = 0.5):
        super().__init__()
        c4 = channels // 4
        self.grl_weight = grl_weight
        self.conv1 = Conv2d(channels, c4, 1)
        self.bn1 = BatchNorm(c4)
        self.conv2 = Conv2d(c4, c4 * 9, 3, padding=3)
        self.bn2 = BatchNorm(c4 * 9)
        self.fc = Linear(c4 * 9, 2)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, 2)."""
        x = gradient_reverse(x, self.grl_weight)
        x = self.drop(torch.relu(self.bn1(self.conv1(x))))
        x = self.drop(torch.relu(self.bn2(self.conv2(x))))
        return self.fc(x.mean(dim=(2, 3)))


class PixelAlignmentHead(nn.Module):
    """GRL → two 1x1 conv (+ BN, ReLU, dropout) → 1x1 conv to one logit per
    pixel. `use_norm=False` is the plain flavour without BN and dropout."""

    def __init__(self, channels: int, use_norm: bool = True,
                 grl_weight: float = -1.0, dropout: float = 0.5):
        super().__init__()
        self.use_norm = use_norm
        self.grl_weight = grl_weight
        self.conv1 = Conv2d(channels, channels, 1, bias=False)
        self.conv2 = Conv2d(channels, channels, 1, bias=False)
        if use_norm:
            self.bn1 = BatchNorm(channels)
            self.bn2 = BatchNorm(channels)
            self.drop = Dropout(dropout)
        self.conv_out = Conv2d(channels, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, H, W, 1) logits."""
        x = gradient_reverse(x, self.grl_weight)
        for conv, bn in ((self.conv1, 'bn1'), (self.conv2, 'bn2')):
            x = conv(x)
            if self.use_norm:
                x = self.drop(torch.relu(getattr(self, bn)(x)))
            else:
                x = torch.relu(x)
        return self.conv_out(x).permute(0, 2, 3, 1)


class ImageAlignmentHead(nn.Module):
    """DAF-original image-level map: GRL → 1x1 conv to 512, ReLU → 1x1
    conv to one logit per pixel."""

    def __init__(self, channels: int = 2048, grl_weight: float = -1.0):
        super().__init__()
        self.grl_weight = grl_weight
        self.conv1 = Conv2d(channels, 512, 1)
        self.conv2 = Conv2d(512, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, H, W, 1) logits."""
        x = gradient_reverse(x, self.grl_weight)
        return self.conv2(torch.relu(self.conv1(x))).permute(0, 2, 3, 1)


class InstanceAlignmentHead(nn.Module):
    """Per-RoI domain classifier over (N, feat_dim) shared-FC features:
    GRL → non-local block → two FC (ReLU, dropout) → 2 logits."""

    def __init__(self, feat_dim: int = 1024, use_nonlocal: bool = True,
                 grl_weight: float = -1.0, dropout: float = 0.5):
        super().__init__()
        self.grl_weight = grl_weight
        self.nlb = NonLocalBlock(feat_dim) if use_nonlocal else None
        hidden = (512, 512) if use_nonlocal else (feat_dim, feat_dim)
        self.fc1 = Linear(feat_dim, hidden[0])
        self.fc2 = Linear(hidden[0], hidden[1])
        self.fc_out = Linear(hidden[1], 2)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, feat_dim) → (N, 2)."""
        x = gradient_reverse(x, self.grl_weight)
        if self.nlb is not None:
            x = self.nlb(x)
        x = self.drop(torch.relu(self.fc1(x)))
        x = self.drop(torch.relu(self.fc2(x)))
        return self.fc_out(x)
