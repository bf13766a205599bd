"""Seeded random weights for a detector without a checkpoint."""

from __future__ import annotations

import math

import torch
from torch import nn

from .dense_heads.rpn_head import RPNHead
from .detectors.mask_rcnn_c4 import C4BBoxHead
from .layers.attention import MHSA
from .backbones.swin import WindowAttention
from .layers.norm import BatchNorm, FrozenBatchNorm, GroupNorm, LayerNorm
from .detectors.roi_variants import DoubleBBoxHead
from .detectors.retinanet import init_dense_heads_
from .detectors.sabl_retina import SABLBBoxHead
from .detectors.rpn_detectors import init_adaptive_heads_
from .roi_heads.bbox_head import Shared2FCBBoxHead
from .roi_heads.mask_head import FCNMaskHead


HEAD_SCALES = ('mmdet', 'lecun')


def head_scale_of(cfg) -> str:
    """The head init scale a config asks for: `random_init=dict(
    heads='lecun')` (or `--cfg-options random_init.heads=lecun`), 'mmdet'
    without one."""
    scale = ((cfg.get('random_init') or {}).get('heads') or 'mmdet')
    if scale not in HEAD_SCALES:
        raise ValueError(f'random_init.heads={scale!r}: one of '
                         f'{HEAD_SCALES}')
    return scale


@torch.no_grad()
def init_random_weights_(model: nn.Module, generator: torch.Generator,
                         heads: str = 'mmdet') -> nn.Module:
    """Fill `model` in place: conv and linear weights ~ N(0, 1/fan_in)
    (flax's lecun_normal scale, which keeps activations of order one through
    a frozen-BN ResNet), biases 0, frozen and live BN (the DA heads') as
    the identity (scale 1, bias 0, mean 0, var 1), the group norms (the
    CycleGAN's instance norms, Grid R-CNN's head) and the Swin trunk's
    layer norms likewise (scale 1, bias 0),
    MHSA's relative position parameters and the Swin windows' bias tables
    ~ N(0, 0.02²) as flax draws them; then the RPN's convs
    ~ N(0, 0.01²) and the box heads' (Shared2FC, C4's pooled one and
    Double-Head's) classifier ~ N(0, 0.01²) and regressor ~ N(0, 0.001²), as the reference
    (mmdet's `RPNHead` and `BBoxHead`) initialises them. At the lecun scale
    those heads start with logits and box deltas of order one, and the FPN
    config's full lr (0.01, no clip) then diverges within three steps. The
    mask heads keep the lecun scale, as in the JAX package (the normed
    predictor's raw kernel too, over its input channels). `generator`
    lives on the model's device. `heads='lecun'` leaves the RPN and box
    heads at the lecun scale, as the JAX package draws every layer (the
    draws before them are the same). The Guided Anchoring and Cascade RPN
    layers then get the JAX package's own init
    (`rpn_detectors.init_adaptive_heads_`: the adaptive convs' kernels at
    flax's `he_normal` scale, the offset convs zero, the GA logits' bias
    −4.595), their prediction convs at mmdet's std 0.01 unless `heads` is
    'lecun'. The one-stage heads (RetinaNet's, FCOS's, ATSS's and GFL's)
    get theirs from `retinanet.init_dense_heads_`: towers and outputs at
    mmdet's std 0.01 unless `heads` is 'lecun', the classifier's bias
    −4.595, the per-level scales 1, FCOS's deformable convs at the
    `he_normal` scale with zero offsets (FSAF's, FoveaBox's and SABL's
    heads are such towers too). SABL's box head takes mmdet's `SABLHead`
    scales unless `heads` is 'lecun': the classifier and the bucket
    logits at std 0.01, the bucket offsets at 0.001. The 1-D convs
    (SABL's) draw at the lecun scale over flax's fan-in (taps x input
    channels, for the transposed conv too)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv1d, nn.Linear,
                          nn.ConvTranspose1d)):
            # a transposed conv's weight is (I, O, k): flax's fan-in, k x I
            fan_in = m.weight.shape[0] * m.weight.shape[2] \
                if isinstance(m, nn.ConvTranspose1d) else m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (FrozenBatchNorm, BatchNorm)):
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, (GroupNorm, LayerNorm)):
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
    for m in model.modules() if heads == 'mmdet' else ():
        if isinstance(m, RPNHead):
            layers = [(c, 0.01) for c in m.modules()
                      if isinstance(c, nn.Conv2d)]
        elif isinstance(m, (Shared2FCBBoxHead, C4BBoxHead, DoubleBBoxHead)):
            layers = [(m.fc_cls, 0.01), (m.fc_reg, 0.001)]
        elif isinstance(m, SABLBBoxHead):
            cls, bucket_cls, bucket_off = m.predictors()
            layers = [(cls, 0.01)] + [(f, 0.01) for f in bucket_cls] + \
                [(f, 0.001) for f in bucket_off]
        else:
            continue
        for layer, std in layers:
            layer.weight.normal_(0.0, std, generator=generator)
    init_adaptive_heads_(model, generator, heads)
    init_dense_heads_(model, generator, heads)
    return model
