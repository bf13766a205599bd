"""Cascade R-CNN and Cascade Mask R-CNN R50-FPN (counterpart of the JAX
package's `models/detectors/cascade_rcnn.py`).

Three box stages with rising IoU thresholds (0.5 / 0.6 / 0.7) and
tightening delta stds, each a class-agnostic `Shared2FCBBoxHead`
(`bbox_head_0` … `bbox_head_2`). Training samples each stage's RoIs from
the previous stage's decoded, clipped and detached boxes (the proposals
first), with the previous stage's sample validity as their validity, and
weighs stage i's losses by (1, 0.5, 0.25)[i] under the keys `s<i>.<loss>`.
Prediction refines the proposals through the stages, averages the three
softmaxes, and decodes the last stage's regression of its input boxes
(the box head run once more on them) under the averaged scores.

`CascadeMaskRCNN` adds one `FCNMaskHead` per stage (`mask_head_0` …),
trained on that stage's sampled RoIs with the positives weighted; at test
time the three heads run on the final detections and their sigmoid maps
are averaged.

The trunk, neck, RPN and proposals are `FasterRCNNFPN`'s
(`FPNProposer`); every RoI feature goes through the RoIAlign kernel pair
(`ops/roi_align.py`). `sampler_priorities` may fix the draws of each
stage's sampler: 'rcnn' for the first, 'rcnn_1' and 'rcnn_2' for the
others (B, G + S). The seesaw classifier and the normed mask predictor
(the LVIS rows) raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from ...core.bbox.transforms import clip_boxes, delta2bbox
from ...utils.registry import DETECTORS
from ..dense_heads.rpn_head import ProposalConfig, RPNTrainConfig
from ..roi_heads.bbox_head import Shared2FCBBoxHead
from ..roi_heads.mask_head import (FCNMaskHead, batch_gt_masks, mask_loss,
                                   mask_targets_from_box_frame)
from ..roi_heads.standard_roi_head import (RoITestConfig, RoITrainConfig,
                                           SampledRoIs, bbox_loss,
                                           roi_head_predict, sample_rois)
from .faster_rcnn_fpn import FPNProposer
from .mask_rcnn import select_class_masks

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
STAGE_WEIGHTS = (1.0, 0.5, 0.25)
NUM_STAGES = len(STAGE_IOUS)
ROI_CHANNELS = 256


def stage_cfg(i: int, num_samples: int) -> RoITrainConfig:
    """Stage i's sampler and box coder: IoU thresholds STAGE_IOUS[i]
    without low-quality matches, `num_samples` RoIs a quarter positive, the
    gt boxes among the candidates, STAGE_STDS[i], a softmax classifier."""
    return RoITrainConfig(
        pos_iou_thr=STAGE_IOUS[i], neg_iou_thr=STAGE_IOUS[i],
        min_pos_iou=STAGE_IOUS[i], match_low_quality=False,
        num_samples=num_samples, pos_fraction=0.25,
        add_gt_as_proposals=True, target_stds=STAGE_STDS[i],
        use_sigmoid_cls=False)


def stage_priority_key(i: int) -> str:
    """The `sampler_priorities` key of stage i's sampler."""
    return 'rcnn' if i == 0 else f'rcnn_{i}'


def refine_boxes(rois: torch.Tensor, reg: torch.Tensor, stds,
                 img_shape: torch.Tensor) -> torch.Tensor:
    """The next stage's boxes: (B, R, 4) class-agnostic deltas decoded on
    `rois` in f32, detached, clipped to each image's (h, w)."""
    boxes = delta2bbox(rois, reg.detach().float(), stds=stds)
    return clip_boxes(boxes, img_shape[:, None, :].float())


@DETECTORS.register_module()
class CascadeRCNN(FPNProposer):
    """Trunk → FPN → RPN → three cascaded box stages (see the module
    docstring). The hooks `roi_context`, `_box_feats`, `_final_box_feats`,
    `_stage_extras` and `_after_stages` are where HTC and SCNet add their
    branches."""

    with_mask = False

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50,
                 backbone_cfg: Any = None, frozen_stages: int = 1,
                 rpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_train_cfg: RPNTrainConfig = RPNTrainConfig(),
                 rpn_proposal_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 rpn_test_cfg: ProposalConfig = ProposalConfig(
                     nms_pre=4096, max_per_img=1000),
                 num_samples: int = 512,
                 roi_test_cfg: RoITestConfig = RoITestConfig(),
                 loss_cls: str = 'softmax',
                 dtype: torch.dtype = torch.float32):
        if loss_cls != 'softmax':
            raise NotImplementedError(
                f'loss_cls {loss_cls!r}: only the softmax classifier is '
                'ported; the seesaw cascade (the LVIS rows) is queued in '
                'ROADMAP.md')
        super().__init__(num_classes, backbone_depth, backbone_cfg, 'FPN',
                         frozen_stages, rpn_strides, rpn_train_cfg,
                         rpn_proposal_cfg, rpn_test_cfg, ROI_CHANNELS, dtype)
        self.num_samples = num_samples
        self.roi_test_cfg = roi_test_cfg
        for i in range(NUM_STAGES):
            self.add_module(f'bbox_head_{i}', Shared2FCBBoxHead(
                num_classes=num_classes, in_channels=ROI_CHANNELS,
                reg_class_agnostic=True, dtype=dtype))

    @property
    def bbox_heads(self) -> List[Shared2FCBBoxHead]:
        return [getattr(self, f'bbox_head_{i}') for i in range(NUM_STAGES)]

    # -- hooks ---------------------------------------------------------------

    def roi_context(self, feats, batch=None, losses=None) -> Dict[str, Any]:
        """What the RoI branches read besides the pyramid (HTC's semantic
        map, SCNet's global context); in training (`batch` given) it may add
        its losses to `losses`."""
        return {}

    def _box_feats(self, maps, ctx, rois: torch.Tensor) -> torch.Tensor:
        """The box heads' flat x-major 7x7 RoI features."""
        return self.roi_extract(maps, rois)

    def _final_box_feats(self, maps, ctx, rois: torch.Tensor
                         ) -> torch.Tensor:
        """The features the last box head decodes the detections from."""
        return self._box_feats(maps, ctx, rois)

    def _stage_extras(self, i: int, maps, ctx, sampled: SampledRoIs,
                      gt_masks, batch, carry):
        """Stage i's further loss terms (unweighted) and what the next
        stage's extras read."""
        return {}, carry

    def _after_stages(self, maps, ctx, sampled: SampledRoIs,
                      shared: torch.Tensor, gt_masks, batch, losses) -> None:
        """Losses on the last stage's samples and shared box features."""

    # -- training ------------------------------------------------------------

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """The RPN losses, then each stage's box (and mask) losses on RoIs
        sampled from the previous stage's refined boxes; each stage a
        `step/...` range."""
        pri = sampler_priorities or {}
        gt_masks = batch_gt_masks(batch) if self.with_mask else None
        feats, losses, boxes, box_valid = self._proposals(
            batch, generator, sampler_priorities)
        maps = self.roi_maps(feats)
        ctx = self.roi_context(feats, batch, losses)
        carry = None
        for i, head in enumerate(self.bbox_heads):
            cfg = stage_cfg(i, self.num_samples)
            with torch.no_grad(), record_function('step/roi_sampling'):
                sampled = sample_rois(
                    boxes, box_valid, batch['gt_bboxes'], batch['gt_labels'],
                    batch['gt_valid'], self.num_classes, cfg,
                    priorities=pri.get(stage_priority_key(i)),
                    generator=generator)
            with record_function('step/roi_align_fwd'):
                roi_feats = self._box_feats(maps, ctx, sampled.rois)
            with record_function('step/bbox_head_and_loss'):
                cls_s, reg_s, shared = head(roi_feats)
                terms = bbox_loss(cls_s, reg_s, sampled, self.num_classes,
                                  cfg)
            extra, carry = self._stage_extras(i, maps, ctx, sampled,
                                              gt_masks, batch, carry)
            terms.update(extra)
            for k, v in terms.items():
                losses[f's{i}.{k}'] = v * STAGE_WEIGHTS[i]
            with torch.no_grad():
                boxes = refine_boxes(sampled.rois, reg_s, cfg.target_stds,
                                     batch['img_shape'])
            box_valid = sampled.label_valid
        self._after_stages(maps, ctx, sampled, shared, gt_masks, batch,
                           losses)
        return losses

    # -- serving -------------------------------------------------------------

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Proposals → the three stages → multiclass NMS over the averaged
        scores (dets, labels, valid); the mask families add `masks`
        (B, D, 28, 28), the probabilities of each detection's class, padded
        rows included."""
        feats, proposals, prop_valid = self._test_proposals(batch)
        maps = self.roi_maps(feats)
        ctx = self.roi_context(feats)
        out = self.cascade_detect(maps, ctx, proposals, prop_valid,
                                  batch['img_shape'])
        if self.with_mask:
            out['masks'] = self.mask_predict(maps, out, ctx)
        return out

    def cascade_detect(self, maps, ctx, boxes: torch.Tensor,
                       box_valid: torch.Tensor, img_shape: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """The RoI head on the proposals: each stage scores and refines the
        boxes, and the last one's regression is decoded under the mean of
        the three softmaxes."""
        score_sum = None
        for i, head in enumerate(self.bbox_heads):
            cls_s, reg_s, _ = head(self._box_feats(maps, ctx, boxes))
            scores = torch.softmax(cls_s.float(), dim=-1)
            score_sum = scores if score_sum is None else score_sum + scores
            if i < NUM_STAGES - 1:
                boxes = refine_boxes(boxes, reg_s, STAGE_STDS[i], img_shape)
        log_avg = torch.log(torch.clamp(score_sum / 3.0, min=1e-9))
        last = self.bbox_heads[-1]
        return roi_head_predict(
            lambda rf: (log_avg, last(rf)[1], None), maps, boxes, box_valid,
            img_shape, self.num_classes, reg_class_agnostic=True,
            target_stds=STAGE_STDS[-1], use_sigmoid_cls=False,
            cfg=self.roi_test_cfg,
            roi_extractor=lambda m, r: self._final_box_feats(m, ctx, r))


@DETECTORS.register_module()
class CascadeMaskRCNN(CascadeRCNN):
    """`CascadeRCNN` with an FCN mask head per stage (`mask_size` // 2 RoI
    features, 4 convs, 2x bilinear upsample)."""

    with_mask = True

    def __init__(self, num_classes: int = 80, mask_size: int = 28,
                 normed_mask: bool = False, **kwargs):
        if normed_mask:
            raise NotImplementedError(
                'normed_mask=True: the normed mask predictors of the seesaw '
                'cascade (the LVIS rows) are queued in ROADMAP.md')
        super().__init__(num_classes=num_classes, **kwargs)
        self.mask_size = mask_size
        self._make_mask_heads(num_classes)

    def _make_mask_heads(self, num_classes: int) -> None:
        """One `FCNMaskHead` a stage."""
        for i in range(NUM_STAGES):
            self.add_module(f'mask_head_{i}', FCNMaskHead(
                num_classes=num_classes, in_channels=ROI_CHANNELS,
                dtype=self.dtype))

    @property
    def mask_heads(self) -> List[torch.nn.Module]:
        return [getattr(self, f'mask_head_{i}') for i in range(NUM_STAGES)]

    def _stage_extras(self, i, maps, ctx, sampled, gt_masks, batch, carry):
        """Stage i's mask loss on its sampled RoIs, the positives
        weighted."""
        with record_function('step/mask_roi_align_fwd'):
            feats = self.roi_extract(maps, sampled.rois,
                                     out_size=self.mask_size // 2,
                                     flatten=False)
        with record_function('step/mask_head_and_loss'):
            logits = self.mask_heads[i](feats)
        return self._mask_terms(logits, sampled, gt_masks, batch), carry

    def _mask_terms(self, logits, sampled, gt_masks, batch):
        """`mask_loss` of (B, S, m, m, K) logits against the box-frame
        targets of the sampled RoIs."""
        with record_function('step/mask_targets'):
            targets = mask_targets_from_box_frame(
                gt_masks, batch['gt_bboxes'], sampled.rois,
                sampled.matched_gt, self.mask_size)
        with record_function('step/mask_head_and_loss'):
            pos_w = (sampled.is_pos & sampled.label_valid).float()
            return mask_loss(logits, targets, sampled.labels, pos_w)

    def mask_predict(self, maps, out: Dict[str, torch.Tensor], ctx=None
                     ) -> torch.Tensor:
        """The mean of the three heads' sigmoid maps at each detection's
        class: (B, D, 28, 28)."""
        feats = self.roi_extract(maps, out['dets'][..., :4].contiguous(),
                                 out_size=self.mask_size // 2, flatten=False)
        probs = None
        for head in self.mask_heads:
            p = select_class_masks(head(feats), out['labels'],
                                   self.num_classes)
            probs = p if probs is None else probs + p
        return probs / 3.0

