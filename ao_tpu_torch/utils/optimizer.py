"""Optimizer construction (port of ao_tpu/utils/optimizer.py for AdamW).

``build_optimizer`` turns ``{"type": "AdamW", "lr": ..., "weight_decay":
...}`` into ``torch.optim.AdamW`` over every parameter of the model. Its
update is optax.adamw's, which the JAX package uses: decoupled decay
lr * wd * p, and eps added outside the square root of the bias-corrected
second moment. Parameter groups (``param_dicts``) are not ported.
"""

from __future__ import annotations

import torch

from .registry import Registry

OPTIMIZERS = Registry("optimizers")


@OPTIMIZERS.register_module()
def AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def build_optimizer(cfg: dict, model: torch.nn.Module):
    cfg = dict(cfg)
    if cfg.pop("param_dicts", None):
        raise NotImplementedError("param_dicts parameter groups are not ported")
    return OPTIMIZERS.build(dict(cfg, params=model.parameters()))
