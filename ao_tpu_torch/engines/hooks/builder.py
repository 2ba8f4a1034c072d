"""HOOKS registry (port of ao_tpu/engines/hooks/builder.py)."""

from ...utils.registry import Registry

HOOKS = Registry("hooks")


def build_hooks(cfg_list):
    return [HOOKS.build(dict(cfg)) for cfg in (cfg_list or [])]
