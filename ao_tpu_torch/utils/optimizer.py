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

Each takes and ignores the other optimizers' keys, as the JAX package's
do: a config that replaces its base's SGD by AdamW without ``_delete_``
(configs/scannet/semseg-cac-v1m1-2-ptv2-lovasz.py) keeps ``momentum`` and
``nesterov``.

``param_dicts`` (Pointcept's keyword-matched parameter groups; the
configs set them at the top level, beside ``optimizer``): a parameter
whose name contains an entry's ``keyword`` joins that entry's group (the
first match wins), the others the default group, which comes first; each
group takes its entry's ``lr`` / ``weight_decay`` / ``momentum``. The JAX
package builds the same groups with ``optax.multi_transform`` over flax
paths; the port's parameter names carry the same keywords (the cRSE
tables end in ``_table`` in both).
"""

from __future__ import annotations

import torch

from .registry import Registry

OPTIMIZERS = Registry("optimizers")


@OPTIMIZERS.register_module()
def AdamW(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, **_):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


@OPTIMIZERS.register_module()
def SGD(params, lr, momentum=0.9, weight_decay=0.0, nesterov=False, **_):
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


@OPTIMIZERS.register_module()
def Adam(params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, **_):
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def param_groups(model: torch.nn.Module, param_dicts):
    """torch parameter groups: the default group, then one per
    ``param_dicts`` entry with its overrides (all but ``keyword``)."""
    entries = list(param_dicts)
    groups = [dict(params=[])] + [
        dict({k: v for k, v in e.items() if k != "keyword"}, params=[])
        for e in entries]
    for name, p in model.named_parameters():
        i = next((i for i, e in enumerate(entries) if e["keyword"] in name), -1)
        groups[i + 1]["params"].append(p)
    return groups


def build_optimizer(cfg: dict, model: torch.nn.Module, param_dicts=None):
    """The optimizer of ``cfg`` over the model's parameters, in the groups of
    ``param_dicts`` where given (the config's top-level key; inside
    ``cfg`` it is refused)."""
    cfg = dict(cfg)
    if cfg.pop("param_dicts", None):
        raise NotImplementedError(
            "param_dicts inside the optimizer config: set them at the top "
            "level of the config, beside optimizer")
    params = (param_groups(model, param_dicts) if param_dicts
              else model.parameters())
    return OPTIMIZERS.build(dict(cfg, params=params))
