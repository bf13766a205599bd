"""ResNet trunk (counterpart of the JAX package's `models/backbones/resnet.py`).

Frozen-BN, plain-conv ResNet at depths 18/34/50/101/152 with the DC5 shape
the DA configs use — strides (1, 2, 2, 1), dilations (1, 1, 1, 2), 3x3
padding equal to the dilation — or the standard one. Deformable convs,
GroupNorm, weight standardization and plugins are not ported yet.

Layout: NCHW tensors (the detector feeds a channels_last view of its NHWC
batch, so cuDNN runs NHWC kernels). Module names mirror the flax tree —
`conv1`, `bn1`, `layer1.0.conv2`, `downsample_conv` — so a flax variable
tree converts by renaming (`layer1/0` → `layer1.0`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..layers.norm import FrozenBatchNorm


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride, dilation) → 1x1 with residual, 'pytorch' style
    (stride on the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        if downsample:
            # flax 1x1 'SAME' pads nothing, stride 2 included
            self.downsample_conv = nn.Conv2d(inplanes, out, 1, stride=stride,
                                             bias=False)
            self.downsample_bn = FrozenBatchNorm(out)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class BasicBlock(nn.Module):
    """3x3 (stride, dilation) → 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Stem 7x7/2 (pad 3) → frozen BN → ReLU → max-pool 3/2 (pad 1, -inf
    padding) → four stages; the first block of a stage downsamples when its
    stride is not 1 or its channels change.

    `frozen_stages` (as the JAX trunk): with it >= 0 the stem's output is
    detached and its parameters freeze, and so are stages 1..frozen_stages
    (their outputs detached, their parameters `requires_grad=False`).
    """

    def __init__(self, depth: int = 50, base_channels: int = 64,
                 num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise ValueError(f'invalid depth {depth} for ResNet')
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = nn.Conv2d(3, base_channels, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = FrozenBatchNorm(base_channels)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = base_channels
        channels = []
        for i in range(num_stages):
            planes = base_channels * 2**i
            out_ch = planes * block_cls.expansion
            blocks = []
            for b in range(stage_blocks[i]):
                first = b == 0
                blocks.append(block_cls(
                    in_ch, planes,
                    stride=strides[i] if first else 1,
                    dilation=dilations[i],
                    downsample=first and (strides[i] != 1 or in_ch != out_ch)))
                in_ch = out_ch
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            channels.append(out_ch)
        self.num_stages = num_stages
        self._stage_channels = tuple(channels)
        if frozen_stages >= 0:
            frozen = [self.conv1, self.bn1] + [
                getattr(self, f'layer{i}') for i in range(1, frozen_stages + 1)]
            for m in frozen:
                m.requires_grad_(False)

    def stage_channels(self) -> Tuple[int, ...]:
        return self._stage_channels

    def forward(self, x: torch.Tensor, return_all_stages: bool = False):
        """x: (B, 3, H, W) normalized. Returns the tuple of stage outputs at
        `out_indices` (all four with `return_all_stages`)."""
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        if self.frozen_stages >= 0:
            x = x.detach()
        stage_outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            stage_outs.append(x)
        if return_all_stages:
            return tuple(stage_outs)
        return tuple(stage_outs[i] for i in self.out_indices)
