"""Dataset registry (port of ao_tpu/datasets/builder.py)."""

from ..utils.registry import Registry

DATASETS = Registry("datasets")


def build_dataset(cfg):
    return DATASETS.build(dict(cfg))
