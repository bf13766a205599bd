"""Detector construction from dict configs (counterpart of the JAX
package's `models/builder.py`, for the detector types this port has).

`build_detector(cfg)` takes the reference-style nested dict of
`configs/da/*.py` (`model = dict(type=..., backbone=..., rpn_head=...,
roi_head=..., train_cfg=..., test_cfg=...)`) or flat module kwargs, and
translates it as the JAX builder does. Unknown detector types raise, and so
does any config that asks for a part not ported yet.

The trunk: a nested `backbone` with a `trunk_type` (`type='DAResNet',
trunk_type='swin'`, DeepAlign-Swin) or of type `SwinTransformer` sets
`backbone_type` and the feature stride from its `out_stride` (default 32),
which also becomes the anchor stride; another non-ResNet nested type, or a
flat `backbone_cfg`, goes to the FPN families' `build_trunk`. A detector
that takes neither (the plain DC5 `FasterRCNN`, CyDA) raises, where the
JAX builder drops the key with a warning and builds its ResNet.

Beside the nested parts, a nested config's `gen_blocks` (the CycleGAN
generators' depth, `model.gen_blocks=2` on a CyDA config) reaches a
detector that takes it; the JAX builder ignores it there. `canvas`, the static training canvas
that sizes the MHSA heads, comes from the caller: `apis.init_trainer` and
`apis.init_detector` pass `train_canvas(cfg)`, the train pipeline's `Pad`
size.

`dtype` (flat or nested: `--cfg-options model.dtype=bfloat16`) is the
compute type, float32 by default or bfloat16 (`layers/precision.py`);
float16 raises. The JAX builder reads it from flat configs only and
drops it from a nested one; here both take it. Building a bf16 detector
turns off cuBLAS's reduced-precision reduction for bf16 GEMMs
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`,
process-wide), so they accumulate in f32, as XLA's do.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..utils.device import resolve_device
from ..utils.registry import DETECTORS
from .dense_heads.rpn_head import ProposalConfig, RPNTrainConfig
from .detectors import (cyda_faster_rcnn,  # noqa: F401 (register)
                        da_faster_rcnn, faster_rcnn, faster_rcnn_fpn,
                        mask_rcnn, mask_rcnn_c4)
from .detectors.faster_rcnn import AnchorConfig
from .layers.precision import compute_dtype
from .roi_heads.standard_roi_head import RoITestConfig, RoITrainConfig

# reference detector type name → (registry name, variant kwargs)
_REFERENCE_DETECTOR_MAP = {
    'FasterRCNN': ('FasterRCNN', {}),
    'FasterRCNNFPN': ('FasterRCNNFPN', {}),
    'MaskRCNN': ('MaskRCNN', {}),
    'MaskRCNNC4': ('MaskRCNNC4', {}),
    'DAFasterRCNN': ('DAFasterRCNN', dict(variant='daf',
                                          instance_mode='grouped')),
    'DAFasterRCNN_Org': ('DAFasterRCNN', dict(variant='daf_org',
                                              instance_mode='plain')),
    'MAFasterRCNN': ('DAFasterRCNN', dict(variant='maf',
                                          instance_mode='split_plain')),
    'FasterRCNN_SWDA': ('DAFasterRCNN', dict(variant='swda',
                                             instance_mode='grouped')),
    'DAFasterRCNN_Deep': ('DAFasterRCNN', dict(variant='deep',
                                               instance_mode='grouped')),
    'DAFasterRCNN_Tri': ('DAFasterRCNN', dict(variant='tri',
                                              instance_mode='grouped',
                                              group_k=10)),
    'CyDAFasterRCNN': ('CyDAFasterRCNN', {}),
    'CyCADA': ('CyDAFasterRCNN', dict(pretraining=True)),
}

# reference bbox_head.loss_bbox types that decode boxes (the IoU family);
# the port has only the smooth-L1 'l1' regression loss, and these raise
_REG_LOSS_MAP = {'IoULoss': 'iou', 'GIoULoss': 'giou', 'CIoULoss': 'ciou',
                 'DIoULoss': 'diou', 'BoundedIoULoss': 'bounded_iou'}


def _nested_to_kwargs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Translate a reference-style nested model dict to module kwargs."""
    kwargs: Dict[str, Any] = {}
    backbone = cfg.get('backbone', {})
    if 'depth' in backbone:
        kwargs['backbone_depth'] = backbone['depth']
    if 'frozen_stages' in backbone:
        kwargs['frozen_stages'] = backbone['frozen_stages']
    if backbone.get('trunk_type') or backbone.get('type') == 'SwinTransformer':
        # as the JAX builder: any `trunk_type` (or a Swin type) sets the
        # trunk and takes the feature stride from `out_stride` (default 32)
        kwargs['backbone_type'] = backbone.get('trunk_type', 'swin')
        kwargs['featmap_stride'] = backbone.get('out_stride', 32)
    elif backbone.get('type', 'ResNet') not in ('ResNet', 'DAResNet'):
        kwargs['backbone_cfg'] = backbone

    anch = cfg.get('rpn_head', {}).get('anchor_generator', {})
    if anch:
        kwargs['anchor_cfg'] = AnchorConfig(
            scales=tuple(anch.get('scales', (2, 4, 8, 16, 32))),
            ratios=tuple(anch.get('ratios', (0.5, 1.0, 2.0))),
            stride=(anch.get('strides', [16]))[0])
        if kwargs.get('backbone_type') == 'swin':
            kwargs['anchor_cfg'] = kwargs['anchor_cfg']._replace(
                stride=kwargs['featmap_stride'])

    bbox_head = cfg.get('roi_head', {}).get('bbox_head', {})
    if 'num_classes' in bbox_head:
        kwargs['num_classes'] = bbox_head['num_classes']

    train_cfg = cfg.get('train_cfg') or {}
    if train_cfg:
        r = train_cfg.get('rpn', {})
        a = r.get('assigner', {})
        s = r.get('sampler', {})
        kwargs['rpn_train_cfg'] = RPNTrainConfig(
            pos_iou_thr=a.get('pos_iou_thr', 0.7),
            neg_iou_thr=a.get('neg_iou_thr', 0.3),
            min_pos_iou=a.get('min_pos_iou', 0.3),
            match_low_quality=a.get('match_low_quality', True),
            num_samples=s.get('num', 256),
            pos_fraction=s.get('pos_fraction', 0.5),
            allowed_border=r.get('allowed_border', 0))
        p = train_cfg.get('rpn_proposal', {})
        if p:
            kwargs['rpn_proposal_cfg'] = ProposalConfig(
                nms_pre=min(p.get('nms_pre', 4096), 8192),
                max_per_img=p.get('max_per_img', 2000),
                nms_iou_threshold=p.get('nms', {}).get('iou_threshold', 0.7),
                min_bbox_size=p.get('min_bbox_size', 0))
        rc = train_cfg.get('rcnn', {})
        ra = rc.get('assigner', {})
        rs = rc.get('sampler', {})
        loss_bbox = bbox_head.get('loss_bbox', {})
        kwargs['roi_train_cfg'] = RoITrainConfig(
            pos_iou_thr=ra.get('pos_iou_thr', 0.5),
            neg_iou_thr=ra.get('neg_iou_thr', 0.5),
            min_pos_iou=ra.get('min_pos_iou', 0.5),
            match_low_quality=ra.get('match_low_quality', False),
            num_samples=rs.get('num', 512),
            pos_fraction=rs.get('pos_fraction', 0.25),
            add_gt_as_proposals=rs.get('add_gt_as_proposals', True),
            target_stds=tuple(bbox_head.get('bbox_coder', {}).get(
                'target_stds', (0.1, 0.1, 0.2, 0.2))),
            use_sigmoid_cls=bbox_head.get('loss_cls', {}).get(
                'use_sigmoid', True),
            sampler_type=('ohem' if rs.get('type') == 'OHEMSampler'
                          else 'random'),
            reg_loss=_REG_LOSS_MAP.get(loss_bbox.get('type'), 'l1'),
            reg_loss_weight=loss_bbox.get('loss_weight', 1.0))

    test_cfg = cfg.get('test_cfg') or {}
    if test_cfg:
        tr = test_cfg.get('rpn', {})
        kwargs['rpn_test_cfg'] = ProposalConfig(
            nms_pre=min(tr.get('nms_pre', 4096), 8192),
            max_per_img=tr.get('max_per_img', 1000),
            nms_iou_threshold=tr.get('nms', {}).get('iou_threshold', 0.7),
            min_bbox_size=tr.get('min_bbox_size', 0))
        tc = test_cfg.get('rcnn', {})
        tc_nms = tc.get('nms', {})
        if tc_nms.get('type', 'nms') != 'nms':
            raise NotImplementedError(
                f'rcnn nms type {tc_nms["type"]!r}: only hard NMS is ported')
        kwargs['roi_test_cfg'] = RoITestConfig(
            score_thr=tc.get('score_thr', 0.05),
            nms_iou_threshold=tc_nms.get('iou_threshold', 0.5),
            max_per_img=tc.get('max_per_img', 100))
    return kwargs


def _init_params(cls) -> Dict[str, inspect.Parameter]:
    """The keyword parameters of `cls` and its bases (a subclass's
    **kwargs reach its bases)."""
    params = {}
    for klass in reversed(cls.__mro__):
        if '__init__' in vars(klass):
            params.update(inspect.signature(klass.__init__).parameters)
    return params


def _flat_kwargs(cls, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Flat module kwargs read as the JAX builder reads them: a dict given
    for a NamedTuple field merges over the field's default, a list for a
    plain tuple field becomes a tuple."""
    kwargs = dict(cfg)
    params = _init_params(cls)
    for name, value in kwargs.items():
        default = params[name].default if name in params else None
        if isinstance(value, dict) and hasattr(default, '_fields'):
            kwargs[name] = default._replace(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in value.items()})
        elif isinstance(value, list) and isinstance(default, tuple) \
                and not hasattr(default, '_fields'):
            kwargs[name] = tuple(value)
    return kwargs


def train_canvas(cfg: Dict[str, Any]) -> Optional[Tuple[int, int]]:
    """The static (H, W) canvas of the train pipeline's `Pad` step (the
    first dataset's, for a `ConcatDataset`), or None without one."""
    train = (cfg.get('data') or {}).get('train') or {}
    if train.get('type') == 'ConcatDataset':
        train = train['datasets'][0]
    for t in train.get('pipeline', []) or []:
        if t.get('type') == 'Pad' and t.get('size'):
            return tuple(t['size'])
    return None


def build_detector(cfg: Dict[str, Any],
                   device: Union[str, torch.device] = 'cuda',
                   canvas: Optional[Tuple[int, int]] = None):
    """Build a detector module from a config dict (nested or flat) on
    `device` (CUDA unless the caller asks for the CPU), with torch's default
    initialization; `apis.init_detector` sets the weights. `canvas` (H, W)
    goes to a detector that takes one; `dtype` is its compute type."""
    device = resolve_device(device)
    cfg = dict(cfg)
    det_type = cfg.pop('type')
    dtype = compute_dtype(cfg.pop('dtype', None))
    if det_type not in _REFERENCE_DETECTOR_MAP:
        raise KeyError(f'detector type {det_type!r} is not ported; have '
                       f'{sorted(_REFERENCE_DETECTOR_MAP)}')
    reg_name, extra = _REFERENCE_DETECTOR_MAP[det_type]
    cls = DETECTORS.get(reg_name)
    params = _init_params(cls)
    if any(k in cfg for k in ('backbone', 'rpn_head', 'roi_head')):
        kwargs = _nested_to_kwargs(cfg)
        if 'gen_blocks' in cfg and 'gen_blocks' in params:
            kwargs['gen_blocks'] = cfg['gen_blocks']
    else:
        kwargs = _flat_kwargs(cls, cfg)
    for key in ('backbone_type', 'backbone_cfg'):
        if key in kwargs and key not in params:
            raise NotImplementedError(
                f'{det_type} with {key}={kwargs[key]!r}: this detector is '
                'ported with its ResNet trunk only; the Swin trunk serves '
                'the DA detectors and the FPN families')
    if canvas is not None and 'canvas' in params:
        kwargs['canvas'] = tuple(canvas)
    kwargs.update(extra, dtype=dtype)
    if dtype == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    with device:
        return cls(**kwargs)
