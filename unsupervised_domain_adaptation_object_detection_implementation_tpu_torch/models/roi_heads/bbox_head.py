"""Shared-2FC bbox head (counterpart of the JAX package's
`models/roi_heads/bbox_head.py:Shared2FCBBoxHead`), with the Megatron split
of its FC pair over a model axis (`parallel/shardings.py`)."""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from ...parallel.shardings import copy_to_model_axis, reduce_from_model_axis
from ..layers.precision import Linear


class Shared2FCBBoxHead(nn.Module):
    """fc1 → ReLU → fc2 → ReLU → (cls K+1, reg 4 or 4K); returns the shared
    1024-d feature too, all at `dtype` (the GEMMs accumulate in f32).
    `in_channels` is the RoI feature width (the trunk's output channels).

    `model_group` (set by `parallel/shardings.py:shard_train_state_`) is
    the process group of a model axis over which `shared_fc1` holds a
    shard of its output columns and `shared_fc2` of its input rows: the
    partial products of `shared_fc2` are summed over the axis before its
    bias."""

    def __init__(self, num_classes: int = 8, in_channels: int = 2048,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        fc = functools.partial(Linear, compute_dtype=dtype)
        self.shared_fc1 = fc(in_channels * roi_feat_size**2, fc_out_channels)
        self.shared_fc2 = fc(fc_out_channels, fc_out_channels)
        self.fc_cls = fc(fc_out_channels, num_classes + 1)
        self.fc_reg = fc(fc_out_channels,
                         4 if reg_class_agnostic else 4 * num_classes)
        self.model_group = None

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
        if self.model_group is None:
            x = torch.relu(self.shared_fc1(flat))
            x = torch.relu(self.shared_fc2(x))
        else:
            x = copy_to_model_axis(flat, self.model_group)
            x = torch.relu(self.shared_fc1(x))
            fc2 = self.shared_fc2
            dt = fc2.compute_dtype
            y = reduce_from_model_axis(
                torch.nn.functional.linear(x.to(dt), fc2.weight.to(dt)),
                self.model_group)
            x = torch.relu(y + fc2.bias.to(dt))
        return self.fc_cls(x), self.fc_reg(x), x
