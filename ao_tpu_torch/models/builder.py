"""Model registry (port of ao_tpu/models/builder.py)."""

from ..utils.registry import Registry

MODELS = Registry("models")


def build_model(cfg):
    """Build a model from config, building a nested ``backbone`` config
    first; the ``criteria`` entry belongs to the trainer."""
    cfg = dict(cfg)
    if isinstance(cfg.get("backbone"), dict):
        cfg["backbone"] = build_model(cfg["backbone"])
    cfg.pop("criteria", None)
    return MODELS.build(cfg)
