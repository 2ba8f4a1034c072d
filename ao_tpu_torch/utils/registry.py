"""String -> callable registries and config-driven construction.

Same registry as ao_tpu/utils/registry.py, kept as a copy because the
port imports nothing of ao_tpu: a registry is a named dict from strings
to callables, and ``build_from_cfg`` instantiates ``cfg["type"]`` with
the remaining keys as kwargs. Registries may have a parent for scoped
lookups.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}
        self._parent = parent

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    def get(self, key: str) -> Optional[Callable]:
        if key in self._module_dict:
            return self._module_dict[key]
        if self._parent is not None:
            return self._parent.get(key)
        return None

    def register_module(self, name=None, module=None, force: bool = False):
        """Register a class/function. Usable as a decorator (with or without
        a name) or as a plain call with ``module=``."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return decorator

    def _register(self, module: Callable, name=None, force: bool = False):
        if not callable(module):
            raise TypeError(f"module must be callable, got {type(module)}")
        names = [module.__name__] if name is None else (
            [name] if isinstance(name, str) else list(name)
        )
        for n in names:
            if not force and n in self._module_dict:
                raise KeyError(f"{n} is already registered in {self._name}")
            self._module_dict[n] = module

    def build(self, cfg: dict, **default_kwargs) -> Any:
        return build_from_cfg(cfg, self, **default_kwargs)


def build_from_cfg(cfg: Any, registry: Registry, **default_kwargs) -> Any:
    """Instantiate an object from ``{"type": name, **kwargs}``.

    Extra ``default_kwargs`` fill in keys absent from ``cfg``. If ``cfg`` is
    already not a dict (e.g. an instantiated object) it is returned as-is.
    """
    if not isinstance(cfg, dict):
        return cfg
    if "type" not in cfg:
        raise KeyError(f"cfg must contain the key 'type', got {cfg}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}")
    elif callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or callable, got {type(obj_type)}")
    for k, v in default_kwargs.items():
        args.setdefault(k, v)
    try:
        return obj_cls(**args)
    except TypeError as e:
        sig = None
        if inspect.isclass(obj_cls) or inspect.isfunction(obj_cls):
            try:
                sig = str(inspect.signature(obj_cls))
            except (TypeError, ValueError):
                pass
        raise TypeError(f"building {obj_type}{sig or ''} failed: {e}") from e
