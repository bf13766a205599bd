"""RetinaNet, and what the one-stage core shares (counterpart of the JAX
package's `models/detectors/retinanet.py`).

`TowerHead` is the shared-by-the-levels pair of stacked 3x3 conv towers
(`cls_conv{i}`, `reg_conv{i}`, each with a ReLU) that RetinaNet's,
FCOS's, ATSS's and GFL's heads put their outputs on, with the learnable
per-level scalars `scale_{lvl}` of the last three and FCOS's deformable
last conv (`cls_conv{i}_dcn` over the offsets of `cls_conv{i}_offset`, and
the `reg_` pair); module names are the JAX tree's. Heads take the neck's
NCHW levels and return per-level NHWC float32 maps, which
`flatten_level_preds` turns into one (B, N, ·) tensor.

`SingleStage` is the detector around a head: the ResNet (or Swin) trunk,
an FPN over C3–C5 with two extra levels (P3–P7), and `forward(batch,
train)`, the loss dict with `train`, else `predict`'s detections. The
trainer's `generator` and `sampler_priorities` are accepted and unused:
the one-stage core samples nothing.

`init_dense_heads_` gives the heads their seeded init (see there).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS, HEADS
from ..dense_heads.anchor_head import (DenseAnchorTrainConfig,
                                       DensePredictConfig, MultiAnchorConfig,
                                       dense_anchor_predict,
                                       dense_focal_anchor_loss,
                                       flatten_level_preds, level_anchors)
from ..layers.plugins import DeformConv
from ..layers.precision import Conv2d
from ..necks.build import make_fpn_neck
from .rpn_detectors import _Forward, _extract_feat, _fpn_trunk

CLS_BIAS = -4.595      # the classifiers' prior-probability bias (p = 0.01)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TowerHead(nn.Module):
    """The two towers of `stacked_convs` 3x3 convs (the last a DCN v1 with
    `dcn_on_last_conv`), computed at `dtype`, and `num_levels` scalars
    `scale_{lvl}` (none for 0). Subclasses add their output convs."""

    def __init__(self, feat_channels: int = 256, stacked_convs: int = 4,
                 in_channels: int = 256, num_levels: int = 0,
                 dcn_on_last_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_levels = num_levels
        self.n_plain = stacked_convs - int(dcn_on_last_conv)
        self.dcn_on_last_conv = dcn_on_last_conv
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        for branch in ('cls', 'reg'):
            c = in_channels
            for i in range(self.n_plain):
                self.add_module(f'{branch}_conv{i}',
                                conv(c, feat_channels, 3, padding=1))
                c = feat_channels
            if dcn_on_last_conv:
                i = stacked_convs - 1
                self.add_module(f'{branch}_conv{i}_dcn', DeformConv(
                    c, feat_channels, dtype=dtype))
                self.add_module(f'{branch}_conv{i}_offset',
                                conv(c, 18, 3, padding=1))
        for lvl in range(num_levels):
            self.register_parameter(f'scale_{lvl}',
                                    nn.Parameter(torch.ones(())))

    def dcn_layers(self):
        """(deformable conv, its offset conv) of each tower, or none."""
        if not self.dcn_on_last_conv:
            return []
        i = self.n_plain
        return [(getattr(self, f'{b}_conv{i}_dcn'),
                 getattr(self, f'{b}_conv{i}_offset')) for b in ('cls', 'reg')]

    def cls_output(self) -> nn.Module:
        raise NotImplementedError

    def scale(self, lvl: int) -> torch.Tensor:
        return getattr(self, f'scale_{lvl}').float()

    def _tower(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        with record_function('step/dense_head'):
            for i in range(self.n_plain):
                x = torch.relu(getattr(self, f'{branch}_conv{i}')(x))
            if not self.dcn_on_last_conv:
                return x
            i = self.n_plain
            off = _nhwc(getattr(self, f'{branch}_conv{i}_offset')(x))
        with record_function('step/deform_conv'):
            return torch.relu(getattr(self, f'{branch}_conv{i}_dcn')(
                _nhwc(x), off)).permute(0, 3, 1, 2)

    def outputs(self, c: torch.Tensor, r: torch.Tensor, lvl: int
                ) -> Tuple[torch.Tensor, ...]:
        """One level's output maps (NHWC, float32) from its cls and reg
        towers' maps."""
        raise NotImplementedError

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: the neck's (B, C, H_l, W_l) levels → per output a tuple
        of its levels' maps."""
        outs = []
        for lvl, f in enumerate(feats):
            c, r = self._tower('cls', f), self._tower('reg', f)
            with record_function('step/dense_head'):
                outs.append(self.outputs(c, r, lvl))
        return tuple(zip(*outs))


@HEADS.register_module()
class RetinaHead(TowerHead):
    """The shared 4-conv subnets → `num_anchors` x C class logits
    (`retina_cls`) and x 4 deltas (`retina_reg`) a location."""

    def __init__(self, num_classes: int = 80, num_anchors: int = 9,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 in_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__(feat_channels, stacked_convs, in_channels,
                         dtype=dtype)
        conv = functools.partial(Conv2d, compute_dtype=dtype)
        self.retina_cls = conv(feat_channels, num_anchors * num_classes, 3,
                               padding=1)
        self.retina_reg = conv(feat_channels, num_anchors * 4, 3, padding=1)

    def cls_output(self):
        return self.retina_cls

    def outputs(self, c, r, lvl):
        return (_nhwc(self.retina_cls(c).float()),
                _nhwc(self.retina_reg(r).float()))


class SingleStage(_Forward, nn.Module):
    """Trunk (C2–C5 of a ResNet of `backbone_depth`, or `backbone_cfg`'s)
    and the FPN's five levels; subclasses add the head, `loss` and
    `predict`."""

    def __init__(self, num_classes: int, backbone_depth: int,
                 backbone_cfg: Any, frozen_stages: int,
                 dtype: torch.dtype):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.backbone = _fpn_trunk(backbone_cfg, backbone_depth,
                                   frozen_stages, dtype)

    def _levels(self, image: torch.Tensor):
        """The neck's (B, C, H_l, W_l) levels and their (h, w) sizes."""
        with record_function('step/trunk_and_neck'):
            feats = _extract_feat(self, image.float())
        return feats, [(f.shape[-2], f.shape[-1]) for f in feats]


@DETECTORS.register_module()
class RetinaNet(SingleStage):
    """RetinaNet: P3–P7 (extra convs on C5), `RetinaHead`, the focal (or
    GHM-C, `train_cfg.loss_cls='ghm'`) anchor loss. `sep_bn_head` (NAS-FPN's
    head with per-level norms) and any neck but the FPN raise: they are
    not ported yet."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, neck_type: str = 'FPN',
                 frozen_stages: int = 1,
                 anchor_cfg: MultiAnchorConfig = MultiAnchorConfig(),
                 train_cfg: DenseAnchorTrainConfig = DenseAnchorTrainConfig(),
                 test_cfg: DensePredictConfig = DensePredictConfig(),
                 sep_bn_head: bool = False, neck_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        if sep_bn_head:
            raise NotImplementedError(
                'RetinaNet(sep_bn_head=True): the per-level-norm head '
                '(RetinaSepBNHead, NAS-FPN\'s) is not ported yet; it comes '
                'with NAS-FPN (ROADMAP.md)')
        super().__init__(num_classes, backbone_depth, backbone_cfg,
                         frozen_stages, dtype)
        self.anchor_cfg = anchor_cfg
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.neck = make_fpn_neck(
            neck_type, in_channels=self.backbone.stage_channels(),
            out_channels=neck_channels, num_outs=5, start_level=1,
            add_extra_convs='on_input', dtype=dtype)
        self.bbox_head = RetinaHead(num_classes=num_classes,
                                    num_anchors=anchor_cfg.num_anchors,
                                    in_channels=neck_channels, dtype=dtype)

    def _flat(self, image: torch.Tensor):
        """→ cls (B, N, C), reg (B, N, 4), anchors (N, 4)."""
        feats, sizes = self._levels(image)
        cls_lv, reg_lv = self.bbox_head(feats)
        cfg = self.anchor_cfg
        anchors, _ = level_anchors(cfg.strides, cfg.ratios, cfg.scales, sizes,
                                   image.device)
        return (flatten_level_preds(cls_lv, self.num_classes),
                flatten_level_preds(reg_lv, 4), anchors)

    def loss(self, batch, generator=None, sampler_priorities=None):
        cls, reg, anchors = self._flat(batch['image'])
        with record_function('step/dense_loss'):
            return dense_focal_anchor_loss(
                cls, reg, anchors, batch['gt_bboxes'].float(),
                batch['gt_labels'], batch['gt_valid'], batch['img_shape'],
                self.num_classes, self.train_cfg)

    @torch.inference_mode()
    def predict(self, batch) -> Dict[str, torch.Tensor]:
        cls, reg, anchors = self._flat(batch['image'])
        return dense_anchor_predict(cls, reg, anchors, batch['img_shape'],
                                    self.num_classes, self.test_cfg)


@torch.no_grad()
def init_dense_heads_(model: nn.Module, generator: torch.Generator,
                      heads: str = 'mmdet') -> None:
    """The one-stage heads' seeded init: with `heads='mmdet'` (the default)
    their tower and output convs ~ N(0, 0.01²), as mmdet's `RetinaHead`,
    `FCOSHead`, `ATSSHead` and `GFLHead` draw them (`heads='lecun'` keeps
    the JAX package's lecun scale); either way the classifier's bias
    −4.595, the `scale_{lvl}` 1, the deformable convs' kernels at flax's
    `he_normal` scale and their offset convs zero, as the JAX package
    initialises them."""
    for m in model.modules():
        if not isinstance(m, TowerHead):
            continue
        dcn = m.dcn_layers()
        offsets = {id(o) for _, o in dcn}
        if heads == 'mmdet':
            for conv in m.modules():
                if isinstance(conv, nn.Conv2d) and id(conv) not in offsets:
                    conv.weight.normal_(0.0, 0.01, generator=generator)
        m.cls_output().bias.fill_(CLS_BIAS)
        for lvl in range(m.num_levels):
            getattr(m, f'scale_{lvl}').fill_(1.0)
        for layer, offset in dcn:
            layer.init_he_(generator)
            offset.weight.zero_()
            offset.bias.zero_()
