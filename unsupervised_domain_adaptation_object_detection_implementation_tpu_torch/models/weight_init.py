"""Seeded random weights for a detector without a checkpoint."""

from __future__ import annotations

import math

import torch
from torch import nn

from .dense_heads.rpn_head import RPNHead
from .detectors.mask_rcnn_c4 import C4BBoxHead
from .layers.attention import MHSA
from .backbones.swin import WindowAttention
from .layers.norm import BatchNorm, FrozenBatchNorm, InstanceNorm, LayerNorm
from .roi_heads.bbox_head import Shared2FCBBoxHead
from .roi_heads.mask_head import FCNMaskHead


@torch.no_grad()
def init_random_weights_(model: nn.Module, generator: torch.Generator
                         ) -> nn.Module:
    """Fill `model` in place: conv and linear weights ~ N(0, 1/fan_in)
    (flax's lecun_normal scale, which keeps activations of order one through
    a frozen-BN ResNet), biases 0, frozen and live BN (the DA heads') as
    the identity (scale 1, bias 0, mean 0, var 1), the CycleGAN's instance
    norms and the Swin trunk's layer norms likewise (scale 1, bias 0),
    MHSA's relative position parameters and the Swin windows' bias tables
    ~ N(0, 0.02²) as flax draws them; then the RPN's convs
    ~ N(0, 0.01²) and the box heads' (Shared2FC, and C4's pooled one)
    classifier ~ N(0, 0.01²) and regressor ~ N(0, 0.001²), as the reference
    (mmdet's `RPNHead` and `BBoxHead`) initialises them. At the lecun scale
    those heads start with logits and box deltas of order one, and the FPN
    config's full lr (0.01, no clip) then diverges within three steps. The
    mask heads keep the lecun scale, as in the JAX package (the normed
    predictor's raw kernel too, over its input channels). `generator`
    lives on the model's device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (FrozenBatchNorm, BatchNorm)):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, (InstanceNorm, LayerNorm)):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MHSA):
            m.rel_h.normal_(0.0, 0.02, generator=generator)
            m.rel_w.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, WindowAttention):
            m.rel_bias.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, FCNMaskHead) and m.normed_predictor:
            k = m.conv_logits_kernel
            k.normal_(0.0, 1.0 / math.sqrt(k.shape[0]), generator=generator)
    for m in model.modules():
        if isinstance(m, RPNHead):
            layers = [(c, 0.01) for c in m.modules()
                      if isinstance(c, nn.Conv2d)]
        elif isinstance(m, (Shared2FCBBoxHead, C4BBoxHead)):
            layers = [(m.fc_cls, 0.01), (m.fc_reg, 0.001)]
        else:
            continue
        for layer, std in layers:
            layer.weight.normal_(0.0, std, generator=generator)
    return model
