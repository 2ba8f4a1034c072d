"""Python-file configuration system (a copy of ao_tpu/utils/config.py; a
config file's imports of the JAX package's modules named in
``CONFIG_IMPORTS`` get the port's copies).

Same user-facing features as the reference's vendored MMCV Config
(reference: pointcept/utils/config.py — `_base_` inheritance :241-267,
`_delete_` :28, dotted-key merge, dump, CLI DictAction overrides) but a
fresh minimal implementation:

* a config is a plain ``.py`` file whose module-level names become keys;
* ``_base_ = ["relative/path.py", ...]`` merges parent configs first
  (dict-recursive merge, later files win);
* a child dict with ``{"_delete_": True}`` replaces instead of merging;
* ``Config.merge_from_dict({"a.b.c": v})`` applies dotted overrides;
* ``cfg.dump(path)`` writes a self-contained resolved config.
"""

from __future__ import annotations

import argparse
import ast
import copy
import importlib
import os
import os.path as osp
import pprint
import sys
import types
from typing import Any, Dict, List

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"
RESERVED_KEYS = {"filename", "text"}
# modules of the JAX package that config files import (the ScanNet200
# configs' class names), served from the port's own copies while a config
# file runs, so that loading a config imports nothing of ao_tpu
CONFIG_IMPORTS = {
    "ao_tpu.datasets.preprocessing.scannet_meta": "..datasets.scannet_meta",
}
_ABSENT = object()


class ConfigDict(dict):
    """dict with attribute access; missing attributes raise AttributeError."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    def copy(self):
        return ConfigDict(self)

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def _to_configdict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


def _merge_dict(base: dict, child: dict) -> dict:
    """Recursively merge ``child`` into ``base`` (child wins)."""
    out = dict(base)
    for k, v in child.items():
        if (
            isinstance(v, dict)
            and k in out
            and isinstance(out[k], dict)
            and not v.pop(DELETE_KEY, False)
        ):
            out[k] = _merge_dict(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = v
    return out


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"config file not found: {filename}")
    with open(filename) as f:
        source = f.read()
    # Validate syntax with a helpful error before exec.
    ast.parse(source, filename=filename)
    module = types.ModuleType("_ao_cfg")
    module.__file__ = filename
    served = {name: importlib.import_module(port, __package__)
              for name, port in CONFIG_IMPORTS.items()}
    shadowed = {name: sys.modules.get(name, _ABSENT) for name in served}
    sys.modules.update(served)
    try:
        exec(compile(source, filename, "exec"), module.__dict__)
    finally:
        for name, old in shadowed.items():
            if old is _ABSENT:
                del sys.modules[name]
            else:
                sys.modules[name] = old
    return {
        k: v
        for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
    }


def _load_with_base(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    base_files = cfg.pop(BASE_KEY, [])
    if isinstance(base_files, str):
        base_files = [base_files]
    merged: Dict[str, Any] = {}
    for bf in base_files:
        base_cfg = _load_with_base(osp.join(osp.dirname(osp.abspath(filename)), bf))
        merged = _merge_dict(merged, base_cfg)
    return _merge_dict(merged, cfg)


class Config:
    """Resolved configuration with attribute access and dotted-key merging."""

    def __init__(self, cfg_dict: dict = None, filename: str = None):
        cfg_dict = cfg_dict or {}
        for k in cfg_dict:
            if k in RESERVED_KEYS:
                raise KeyError(f"{k} is a reserved key")
        object.__setattr__(self, "_cfg_dict", _to_configdict(cfg_dict))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(filename: str) -> "Config":
        return Config(_load_with_base(filename), filename=filename)

    # -- mapping / attribute protocol --
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        if name.startswith("__"):  # e.g. pickle's probes before _cfg_dict is set
            raise AttributeError(name)
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_configdict(value)

    # picklable, so that the launcher can hand a config to its processes
    def __getstate__(self):
        return self._cfg_dict, self._filename

    def __setstate__(self, state):
        object.__setattr__(self, "_cfg_dict", state[0])
        object.__setattr__(self, "_filename", state[1])

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_configdict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def __repr__(self):
        return f"Config(file={self._filename}):\n{pprint.pformat(dict(self._cfg_dict))}"

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def setdefault(self, name, default=None):
        return self._cfg_dict.setdefault(name, _to_configdict(default))

    def to_dict(self) -> dict:
        def plain(obj):
            if isinstance(obj, dict):
                return {k: plain(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(plain(v) for v in obj)
            return obj

        return plain(dict(self._cfg_dict))

    # -- merging --
    def merge_from_dict(self, options: Dict[str, Any]):
        """Apply ``{"a.b.c": v, ...}`` dotted-key overrides."""
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        merged = _merge_dict(self.to_dict(), nested)
        object.__setattr__(self, "_cfg_dict", _to_configdict(merged))

    # -- dump --
    def dump(self, file: str = None) -> str:
        text = "".join(
            f"{k} = {pprint.pformat(v, width=100, sort_dicts=False)}\n"
            for k, v in self.to_dict().items()
        )
        if file is not None:
            os.makedirs(osp.dirname(osp.abspath(file)), exist_ok=True)
            with open(file, "w") as f:
                f.write(text)
        return text


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs with literal-eval values.

    Mirrors the reference CLI contract (``--options save_path=... k.k2=v``).
    """

    @staticmethod
    def _parse_value(val: str):
        try:
            return ast.literal_eval(val)
        except (SyntaxError, ValueError):
            pass
        lowered = val.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, val = kv.partition("=")
            if not sep:
                raise argparse.ArgumentError(self, f"expected KEY=VALUE, got {kv}")
            options[key] = self._parse_value(val)
        setattr(namespace, self.dest, options)
