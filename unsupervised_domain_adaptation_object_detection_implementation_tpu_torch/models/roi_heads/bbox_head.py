"""Shared-2FC bbox head (counterpart of the JAX package's
`models/roi_heads/bbox_head.py:Shared2FCBBoxHead`)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class Shared2FCBBoxHead(nn.Module):
    """fc1 → ReLU → fc2 → ReLU → (cls K+1, reg 4 or 4K); returns the shared
    1024-d feature too. `in_channels` is the RoI feature width (the trunk's
    output channels)."""

    def __init__(self, num_classes: int = 8, in_channels: int = 2048,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fc1 = nn.Linear(in_channels * roi_feat_size**2,
                                    fc_out_channels)
        self.shared_fc2 = nn.Linear(fc_out_channels, fc_out_channels)
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """roi_feats: (..., R, 7, 7, C), or (..., R, 7·7·C) already flat in
        x-major order → cls (..., R, K+1), reg (..., R, 4 or 4K),
        shared_feat (..., R, 1024)."""
        if roi_feats.dim() >= 4:         # (..., yb, xb, C): flatten x-major
            flat = roi_feats.transpose(-3, -2).reshape(
                *roi_feats.shape[:-3], -1)
        else:
            flat = roi_feats
        x = torch.relu(self.shared_fc1(flat))
        x = torch.relu(self.shared_fc2(x))
        return self.fc_cls(x), self.fc_reg(x), x
