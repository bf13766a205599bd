"""Adversarial domain-alignment heads behind a GRL (counterpart of the JAX
package's `models/da/heads.py`: `GlobalAlignmentHead`, `PixelAlignmentHead`
and `InstanceAlignmentHead`; `SRMHead`, `ImageAlignmentHead` and the MHSA
attention belong to other variants and wait for them).

Every head emits logits. The map heads take the trunk's NCHW stage output;
the pixel head returns its logit map as (B, H, W, 1), the JAX layout.
Module names are the flax ones, and where flax gives a conv or dense a bias
by default, so has the port. Dropout is flax's: keep probability 1 - rate,
kept values scaled by 1 / (1 - rate).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.attention import CBAM, NonLocalBlock
from ..layers.grl import gradient_reverse
from ..layers.norm import BatchNorm


class GlobalAlignmentHead(nn.Module):
    """GRL → stride-2 conv → residual conv pair with CBAM → two stride-2
    convs → global average pool → MLP → 2 domain logits."""

    def __init__(self, channels: int, attention: Optional[str] = 'cbam',
                 grl_weight: float = -1.0, dropout: float = 0.5):
        super().__init__()
        if attention not in ('cbam', None):
            raise NotImplementedError(
                f'global head attention {attention!r}: only CBAM is ported '
                '(MHSA comes with the Tri-attention variant)')
        c2, c4 = channels // 2, channels // 4
        self.grl_weight = grl_weight
        self.conv1 = nn.Conv2d(channels, c2, 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(c2)
        self.conv2 = nn.Conv2d(c2, c2, 3, padding=1)
        self.bn2 = BatchNorm(c2)
        self.conv3 = nn.Conv2d(c2, c2, 3, padding=1)
        self.bn3 = BatchNorm(c2)
        self.cbam = CBAM(c2) if attention == 'cbam' else None
        self.conv4 = nn.Conv2d(c2, c4, 3, stride=2, padding=1, bias=False)
        self.bn4 = BatchNorm(c4)
        self.conv5 = nn.Conv2d(c4, c4, 3, stride=2, padding=1, bias=False)
        self.bn5 = BatchNorm(c4)
        self.fc1 = nn.Linear(c4, c4 // 2)
        self.fc2 = nn.Linear(c4 // 2, 2)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) → (B, 2)."""
        x = gradient_reverse(x, self.grl_weight)
        res = self.drop(torch.relu(self.bn1(self.conv1(x))))
        t = self.drop(torch.relu(self.bn2(self.conv2(res))))
        t = self.drop(self.bn3(self.conv3(t)))
        if self.cbam is not None:
            t = self.cbam(t)
        x = torch.relu(t + res)
        x = self.drop(torch.relu(self.bn4(self.conv4(x))))
        x = self.drop(torch.relu(self.bn5(self.conv5(x))))
        x = x.mean(dim=(2, 3))
        x = self.drop(torch.relu(self.fc1(x)))
        return self.fc2(x)


class PixelAlignmentHead(nn.Module):
    """GRL → two 1x1 conv (+ BN, ReLU, dropout) → 1x1 conv to one logit per
    pixel. `use_norm=False` is the plain flavour without BN and dropout."""

    def __init__(self, channels: int, use_norm: bool = True,
                 grl_weight: float = -1.0, dropout: float = 0.5):
        super().__init__()
        self.use_norm = use_norm
        self.grl_weight = grl_weight
        self.conv1 = nn.Conv2d(channels, channels, 1, bias=False)
        self.conv2 = nn.Conv2d(channels, channels, 1, bias=False)
        if use_norm:
            self.bn1 = BatchNorm(channels)
            self.bn2 = BatchNorm(channels)
            self.drop = nn.Dropout(dropout)
        self.conv_out = nn.Conv2d(channels, 1, 1, bias=False)

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


class InstanceAlignmentHead(nn.Module):
    """Per-RoI domain classifier over (N, feat_dim) shared-FC features:
    GRL → non-local block → two FC (ReLU, dropout) → 2 logits."""

    def __init__(self, feat_dim: int = 1024, use_nonlocal: bool = True,
                 grl_weight: float = -1.0, dropout: float = 0.5):
        super().__init__()
        self.grl_weight = grl_weight
        self.nlb = NonLocalBlock(feat_dim) if use_nonlocal else None
        hidden = (512, 512) if use_nonlocal else (feat_dim, feat_dim)
        self.fc1 = nn.Linear(feat_dim, hidden[0])
        self.fc2 = nn.Linear(hidden[0], hidden[1])
        self.fc_out = nn.Linear(hidden[1], 2)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, feat_dim) → (N, 2)."""
        x = gradient_reverse(x, self.grl_weight)
        if self.nlb is not None:
            x = self.nlb(x)
        x = self.drop(torch.relu(self.fc1(x)))
        x = self.drop(torch.relu(self.fc2(x)))
        return self.fc_out(x)
