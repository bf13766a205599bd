"""Minimal registry/factory subsystem.

A pure-Python copy of the JAX package's `utils/registry.py` (the port imports
nothing from that package): string-keyed factories so python-dict configs
(`dict(type='DAFasterRCNN', ...)`) can instantiate components. No inheritance
hierarchy — a plain mapping.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """String → class/function registry with dict-config instantiation."""

    def __init__(self, name: str, parent: Optional['Registry'] = None):
        self.name = name
        self._module_dict: Dict[str, Any] = {}
        self.parent = parent

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict or (
            self.parent is not None and key in self.parent)

    def __len__(self):
        return len(self._module_dict)

    def __repr__(self):
        return f'Registry(name={self.name}, items={list(self._module_dict)})'

    def keys(self):
        return self._module_dict.keys()

    def get(self, key: str) -> Any:
        if key in self._module_dict:
            return self._module_dict[key]
        if self.parent is not None and key in self.parent:
            return self.parent.get(key)
        raise KeyError(
            f'{key!r} is not registered in registry {self.name!r}. '
            f'Available: {sorted(self._module_dict)}')

    def register_module(self, name: Optional[str] = None, module: Any = None,
                        force: bool = False):
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool):
        key = name or module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key!r} already registered in {self.name!r}')
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        """Instantiate from a config dict with a ``type`` key.

        Extra ``default_kwargs`` fill in missing keys (mirrors mmcv
        ``build_from_cfg`` default_args).
        """
        if not isinstance(cfg, dict) or 'type' not in cfg:
            raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
        cfg = dict(cfg)
        obj_type = cfg.pop('type')
        if isinstance(obj_type, str):
            obj_cls: Callable = self.get(obj_type)
        else:
            obj_cls = obj_type
        for k, v in default_kwargs.items():
            cfg.setdefault(k, v)
        try:
            return obj_cls(**cfg)
        except TypeError as e:
            raise TypeError(f'building {obj_type!r} from {self.name!r}: {e}') from e


# The registries the port uses (the JAX package's `utils/registry.py` has more).
MODELS = Registry('models')
BACKBONES = Registry('backbones', parent=MODELS)
NECKS = Registry('necks', parent=MODELS)
HEADS = Registry('heads', parent=MODELS)
DETECTORS = Registry('detectors', parent=MODELS)
PIPELINES = Registry('pipelines')
DATASETS = Registry('datasets')
ANCHOR_GENERATORS = Registry('anchor_generators')
