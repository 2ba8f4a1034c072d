"""Per-step learning-rate schedules (port of ao_tpu/utils/scheduler.py).

Each schedule is a ``LambdaLR`` whose factor at step k (counting from 0,
stepped once per optimizer step) times the optimizer's lr is the JAX
package's optax schedule at k; milestones are fractions of
``total_steps``. MultiStepLR takes base_lr times gamma to the number of
boundaries int(r * total_steps) at or below k
(optax.piecewise_constant_schedule's rule). OneCycleLR is
optax.cosine_onecycle_schedule as ao_tpu calls it, not
``torch.optim.lr_scheduler.OneCycleLR``: no momentum cycling, and ao_tpu's
warmup boundary. The factors are computed in float64; the optax schedules
evaluate in float32.

With parameter groups (``param_dicts``) each group follows the schedule
the JAX package builds for it: every group's own lr is its base_lr
(``LambdaLR`` takes each group's factor against its own initial lr), and
OneCycleLR's explicit ``max_lr`` peaks every group at that value, as in
ao_tpu/utils/scheduler.py:85-88 (a group's own lr where it is unset).
"""

from __future__ import annotations

import math

import torch

from .registry import Registry

SCHEDULERS = Registry("schedulers")


def _lambda(optimizer, lr_at):
    """A LambdaLR whose lr at step k is ``lr_at(k, base)`` in each group,
    base the group's own lr (lr_at(0, base) may differ from it: the factor
    is taken against it)."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, [
        lambda k, base=g["lr"]: lr_at(k, base) / base
        for g in optimizer.param_groups])


@SCHEDULERS.register_module()
def MultiStepLR(optimizer, total_steps, milestones, gamma=0.1):
    bounds = sorted({int(r * total_steps) for r in milestones})

    def factor(step):
        return gamma ** sum(b <= step for b in bounds)

    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


@SCHEDULERS.register_module()
def MultiStepWithWarmupLR(optimizer, total_steps, milestones, gamma=0.1,
                          warmup_rate=0.05, warmup_scale=1e-6):
    bounds = [int(r * total_steps) for r in milestones]
    warmup = warmup_rate * total_steps

    def factor(step):
        f = gamma ** sum(b <= step for b in bounds)
        if step <= warmup:
            f *= 1.0 - (1.0 - step / warmup) * (1.0 - warmup_scale)
        return f

    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


@SCHEDULERS.register_module()
def PolyLR(optimizer, total_steps, power=0.9, max_lr=None, pct_start=None,
           anneal_strategy=None, div_factor=None, final_div_factor=None):
    """lr * (1 - k / (total_steps + 1)) ** power. The OneCycle keys are
    taken and ignored: configs/s3dis/semseg-minkunet34c-0-base.py sets
    ``dict(type="PolyLR", power=0.9)`` over its base's OneCycleLR without
    ``_delete_``, so its merged scheduler carries them (the JAX package's
    PolyLR raises on them)."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: (1.0 - k / (total_steps + 1)) ** power)


@SCHEDULERS.register_module()
def ExpLR(optimizer, total_steps, gamma=0.9):
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: gamma ** (k / total_steps))


@SCHEDULERS.register_module()
def CosineAnnealingLR(optimizer, total_steps, eta_min=0.0):
    return _lambda(optimizer, lambda k, base: eta_min + (base - eta_min) * (
        1 + math.cos(math.pi * k / total_steps)) / 2)


def onecycle_lr(k, total_steps, max_lr, pct_start=0.3, div_factor=25.0,
                final_div_factor=1e4):
    """The lr at step k of ao_tpu's OneCycleLR: cosine from max_lr /
    div_factor up to max_lr over the warmup, clamped to [1, T - 1] steps
    (int(pct_start * T)), then cosine down to max_lr / (div_factor *
    final_div_factor) at step T, and that value after; constant max_lr when
    T <= 1."""
    T = total_steps
    if T <= 1:
        return max_lr
    warmup = min(max(int(pct_start * T), 1), T - 1)
    start = max_lr / div_factor
    end = start / final_div_factor
    if k >= T:
        return end

    def cos_interp(a, b, pct):
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

    if k < warmup:
        return cos_interp(start, max_lr, k / warmup)
    return cos_interp(max_lr, end, (k - warmup) / (T - warmup))


@SCHEDULERS.register_module()
def OneCycleLR(optimizer, total_steps, max_lr=None, pct_start=0.3,
               anneal_strategy="cos", div_factor=25.0, final_div_factor=1e4,
               **_unused):
    if anneal_strategy != "cos":
        raise ValueError("OneCycleLR: only anneal_strategy='cos' is ported")
    if isinstance(max_lr, (list, tuple)):
        max_lr = max_lr[0]
    return _lambda(optimizer, lambda k, base: onecycle_lr(
        k, total_steps, base if max_lr is None else max_lr, pct_start,
        div_factor, final_div_factor))


def build_scheduler(cfg: dict, optimizer, total_steps: int):
    return SCHEDULERS.build(dict(cfg, optimizer=optimizer,
                                 total_steps=total_steps))
