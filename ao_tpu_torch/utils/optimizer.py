"""Optimizer construction (port of ao_tpu/utils/optimizer.py).

``build_optimizer`` turns ``{"type": "AdamW", "lr": ..., "weight_decay":
...}`` into the torch optimizer over every parameter of the model, whose
update is the JAX package's optax one:

* AdamW: optax.adamw, decoupled decay lr * wd * p, eps added outside the
  square root of the bias-corrected second moment;
* SGD: optax.chain(add_decayed_weights(wd), sgd(momentum, nesterov)), the
  decay added to the gradient; torch's first momentum buffer (the
  gradient, dampening 0) is optax's trace started from zero, and both
  apply nesterov as g + momentum * trace;
* Adam: optax.chain(add_decayed_weights(wd), adam), the decay added to the
  gradient.

Parameter groups (``param_dicts``) are not ported.
"""

from __future__ import annotations

import torch

from .registry import Registry

OPTIMIZERS = Registry("optimizers")


@OPTIMIZERS.register_module()
def AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


@OPTIMIZERS.register_module()
def SGD(params, lr, momentum=0.9, weight_decay=0.0, nesterov=False):
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


@OPTIMIZERS.register_module()
def Adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def build_optimizer(cfg: dict, model: torch.nn.Module):
    cfg = dict(cfg)
    if cfg.pop("param_dicts", None):
        raise NotImplementedError("param_dicts parameter groups are not ported")
    return OPTIMIZERS.build(dict(cfg, params=model.parameters()))
