"""Model registry (port of ao_tpu/models/builder.py)."""

import inspect

from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg):
    """Build a model from config, building a nested ``backbone`` config
    first. The ``criteria`` entry goes to a model that takes it (one that
    owns its loss, as CAC does); otherwise it belongs to the trainer."""
    cfg = dict(cfg)
    if isinstance(cfg.get("backbone"), dict):
        cfg["backbone"] = build_model(cfg["backbone"])
    criteria = cfg.pop("criteria", None)
    cls = MODELS.get(cfg["type"])
    if cls is not None and "criteria" in inspect.signature(cls).parameters:
        cfg["criteria"] = criteria
    return MODELS.build(cfg)
