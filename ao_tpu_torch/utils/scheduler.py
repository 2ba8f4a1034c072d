"""Per-step learning-rate schedules (port of ao_tpu/utils/scheduler.py for
MultiStepLR).

The schedule steps once per optimizer step; milestones are fractions of
``total_steps``. Step k (counting from 0) takes base_lr times gamma to the
number of boundaries int(r * total_steps) at or below k, which is
optax.piecewise_constant_schedule's rule (the JAX package's MultiStepLR).
"""

from __future__ import annotations

import torch

from .registry import Registry

SCHEDULERS = Registry("schedulers")


@SCHEDULERS.register_module()
def MultiStepLR(optimizer, total_steps, milestones, gamma=0.1):
    bounds = sorted({int(r * total_steps) for r in milestones})

    def factor(step):
        return gamma ** sum(b <= step for b in bounds)

    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def build_scheduler(cfg: dict, optimizer, total_steps: int):
    return SCHEDULERS.build(dict(cfg, optimizer=optimizer,
                                 total_steps=total_steps))
