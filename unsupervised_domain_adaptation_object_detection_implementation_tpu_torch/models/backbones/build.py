"""Trunk construction (counterpart of the JAX package's
`models/backbones/build.py:build_trunk`).

No backbone config → the detector's own `ResNet`. A config dict (the FPN
families' `backbone_cfg`) names its trunk by `type`, a reference name
mapped through `BACKBONE_ALIASES` as in the JAX package; of the trunks the
JAX package registers, the port has the Swin Transformer, and every other
type raises. The config's keys are read as the JAX package reads them: the
torch-only keys drop silently, the mmdet idioms are renamed
(`_translate_mmdet_keys`), the detector's defaults fill what the config
leaves unset, and everything is filtered to the trunk's fields; a key the
config set that is not a field drops with a warning, a detector default
(`depth`, `strides`, `dilations`) silently.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any, Dict

from torch import nn

from .resnet import ResNet
from .swin import SwinTransformer

# reference type name → (registered name, implied kwargs)
BACKBONE_ALIASES: Dict[str, Any] = {
    'ResNeXt': ('ResNet', dict(groups=32, base_width=4)),
    'ResNetV1d': ('ResNet', dict(deep_stem=True, avg_down=True)),
    'Darknet': ('Darknet53', {}),
    'PyramidVisionTransformer': ('PVT', {}),
    'PyramidVisionTransformerV2': ('PVT', dict(v2=True)),
    'DetectoRS_ResNet': ('DetectoRSResNet', {}),
}

# config keys that only make sense for the torch reference: dropped
# silently rather than warned about
_TORCH_ONLY_KEYS = frozenset({
    'init_cfg', 'norm_eval', 'style', 'pretrained', 'zero_init_residual',
    'act_cfg', 'pretrain_img_size', 'convert_weights',
})


def _translate_mmdet_keys(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's renames of reference idioms: `norm_cfg=dict(
    type='GN')` → `norm='gn'`, `conv_cfg=dict(type='ConvWS')` →
    `conv_ws=True`, `dcn=dict(type=...)` → `dcn='dcn'|'dcnv2'`,
    `with_cp=True` → `remat=True`."""
    norm_cfg = cfg.pop('norm_cfg', None)
    if norm_cfg is not None and \
            str(dict(norm_cfg).get('type', 'BN')).upper() == 'GN':
        cfg.setdefault('norm', 'gn')
    conv_cfg = cfg.pop('conv_cfg', None)
    if conv_cfg is not None and \
            str(dict(conv_cfg).get('type', '')).startswith('ConvWS'):
        cfg.setdefault('conv_ws', True)
    dcn = cfg.pop('dcn', None)
    if dcn is not None:
        if isinstance(dcn, str):
            cfg.setdefault('dcn', dcn)
        else:
            typ = str(dict(dcn).get('type', 'DCN')).lower()
            cfg.setdefault('dcn', 'dcnv2' if typ == 'dcnv2' else 'dcn')
    if cfg.pop('with_cp', False):
        cfg.setdefault('remat', True)
    return cfg


def build_trunk(cfg: Any, **defaults) -> nn.Module:
    """`ResNet(**defaults)` when `cfg` is None; else the trunk `cfg`
    names (the Swin Transformer), with `defaults` (the detector's
    geometry, `frozen_stages` and `dtype`) under the config's keys. A type
    the port has no trunk for raises NotImplementedError."""
    if cfg is None:
        return ResNet(**defaults)
    cfg = {k: v for k, v in dict(cfg).items() if k not in _TORCH_ONLY_KEYS}
    cfg = _translate_mmdet_keys(cfg)
    type_name = cfg.pop('type', 'ResNet')
    reg_name, implied = BACKBONE_ALIASES.get(type_name, (type_name, {}))
    if reg_name != 'SwinTransformer':
        raise NotImplementedError(
            f'backbone_cfg type {type_name!r}: of the configurable trunks '
            'only SwinTransformer is ported; the default ResNet trunk takes '
            'no backbone config')
    fields = set(inspect.signature(SwinTransformer).parameters)
    bad_user = sorted(set(cfg) - fields)
    if bad_user:
        warnings.warn(f'SwinTransformer: ignoring backbone config keys '
                      f'{bad_user}')
    kwargs = {**implied, **cfg}
    for k, v in defaults.items():
        kwargs.setdefault(k, v)
    kwargs['dtype'] = defaults['dtype']
    return SwinTransformer(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in kwargs.items() if k in fields})
