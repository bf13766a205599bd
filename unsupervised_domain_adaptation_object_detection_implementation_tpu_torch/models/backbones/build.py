"""Trunk construction (counterpart of the JAX package's
`models/backbones/build.py:build_trunk`). Only the default route is ported:
no backbone config → the detector's own `ResNet`."""

from __future__ import annotations

from typing import Any

from .resnet import ResNet


def build_trunk(cfg: Any, **defaults) -> ResNet:
    """`ResNet(**defaults)` when `cfg` is None; a trunk config (another
    backbone, or ResNet options) raises."""
    if cfg is not None:
        raise NotImplementedError(f'backbone_cfg {cfg!r}: only the default '
                                  'ResNet trunk is ported')
    return ResNet(**defaults)
