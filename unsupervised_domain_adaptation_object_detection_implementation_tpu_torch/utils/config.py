"""Python-dict config loader with `_base_` inheritance and dotted overrides.

A pure-Python copy of the JAX package's `utils/config.py`, so `configs/`
load unchanged in the port and the command-line tools take the same
`--cfg-options` overrides (`parse_option_value`, dotted keys that index
lists, `Config.dump`). Config
files are plain python executed in an isolated namespace; `_base_` entries
are merged depth-first (child wins, dicts merge recursively, `_delete_=True`
replaces a dict wholesale).
"""

from __future__ import annotations

import ast
import copy
import os
import pprint
import types
from typing import Any, Dict, List, Optional, Union


class ConfigDict(dict):
    """dict with attribute access (cfg.model.backbone.depth)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()})


def _to_configdict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


def merge_dict(base: dict, override: dict) -> dict:
    """Recursively merge `override` into `base` (override wins).

    A child dict containing `_delete_: True` replaces the base dict entirely
    (mmcv semantics).
    """
    merged = dict(base)
    for k, v in override.items():
        if (isinstance(v, dict) and isinstance(merged.get(k), dict)
                and not v.get('_delete_', False)):
            merged[k] = merge_dict(merged[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop('_delete_', None)
            merged[k] = v
    return merged


def set_by_dotted_key(cfg: dict, key: str, value: Any) -> None:
    """cfg['a']['b'][2]['c'] = value for key 'a.b.2.c', making missing dict
    levels; a part that meets a list indexes it."""
    *parents, last = key.split('.')
    node: Any = cfg
    for k in parents:
        if isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            node = node.setdefault(k, ConfigDict())
    if isinstance(node, (list, tuple)):
        node[int(last)] = value
    else:
        node[last] = value


def parse_option_value(raw: str) -> Any:
    """A `--cfg-options` value: true/false, none/null, a bracketed list or
    tuple (`[45]`, `(8,11)`), an int, a float, a comma list, else the
    string."""
    lowered = raw.lower()
    if lowered in ('true', 'false'):
        return lowered == 'true'
    if lowered in ('none', 'null'):
        return None
    if raw[:1] in '[(' and raw[-1:] in ')]':
        try:
            return list(ast.literal_eval(raw))
        except (ValueError, SyntaxError):
            pass
    for caster in (int, float):
        try:
            return caster(raw)
        except ValueError:
            pass
    if ',' in raw:
        return [parse_option_value(p) for p in raw.split(',') if p]
    return raw


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename, 'r') as f:
        code = f.read()
    module = types.ModuleType('_cfg_')
    module.__file__ = filename
    exec(compile(code, filename, 'exec'), module.__dict__)
    return {k: v for k, v in module.__dict__.items()
            if not k.startswith('__') and not isinstance(v, types.ModuleType)}


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases: Union[str, List[str]] = cfg.pop('_base_', [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = os.path.join(os.path.dirname(filename), base)
        merged = merge_dict(merged, _load_with_bases(base_path))
    return merge_dict(merged, cfg)


class Config:
    """Loaded configuration tree."""

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        self._cfg = _to_configdict(cfg_dict or {})
        self.filename = filename

    @classmethod
    def fromfile(cls, filename: str) -> 'Config':
        return cls(_load_with_bases(filename), filename=filename)

    @classmethod
    def fromdict(cls, d: dict) -> 'Config':
        return cls(d)

    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply dotted-key overrides (`--cfg-options` equivalent)."""
        for key, value in options.items():
            set_by_dotted_key(self._cfg, key, _to_configdict(value))

    def __getattr__(self, name):
        if name.startswith('_') or name == 'filename':
            raise AttributeError(name)
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        return self._cfg[name]

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        return self._cfg.get(name, default)

    def keys(self):
        return self._cfg.keys()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg))

    def dump(self, path: str):
        """Write the resolved config as a python file."""
        with open(path, 'w') as f:
            for k, v in self._cfg.items():
                f.write(f'{k} = {pprint.pformat(v, width=100)}\n')

    def __repr__(self):
        return f'Config(file={self.filename}, keys={sorted(self._cfg)})'
