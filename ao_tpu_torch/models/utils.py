"""Shared model building blocks (port of ao_tpu/models/utils.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class PointBatchNorm(nn.Module):
    """BatchNorm over points for padded batches. Train mode normalises with
    the batch statistics of the valid rows (the padded batch's translation
    of the reference's BatchNorm1d over ragged points) and updates the
    running mean and the running variance, the latter unbiased, with
    ``momentum`` (torch's: the batch statistic's weight; 0.1 by default);
    eval mode normalises with the running statistics. Padded
    rows come out zero. ``norm`` is a BatchNorm1d so that parameter names
    follow the reference (``<name>.norm.weight`` ...)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.norm = nn.BatchNorm1d(features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        n = self.norm
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if mask is None:
                cnt = torch.tensor(float(xf[..., 0].numel()), device=x.device)
                mean = xf.mean(dims)
                var = ((xf - mean) ** 2).mean(dims)
            else:
                m = mask.float()[..., None]
                cnt = torch.clamp_min(m.sum(), 1.0)
                mean = (xf * m).sum(dims) / cnt
                var = (((xf - mean) ** 2) * m).sum(dims) / cnt
            update_running_stats(n, mean, var, cnt, n.momentum)
        else:
            mean, var = n.running_mean, n.running_var
        y = (xf - mean) * torch.rsqrt(var + n.eps)
        y = y * n.weight + n.bias
        if mask is not None:
            y = torch.where(mask[..., None], y, 0.0)
        return y.to(x.dtype)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm1d, mean, var, n, momentum=0.1):
    """torch's BatchNorm1d running update from a batch's mean, biased
    variance and count: the variance enters unbiased, n / max(n - 1, 1)."""
    unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
    bn.running_mean.mul_(1 - momentum).add_(momentum * mean.detach())
    bn.running_var.mul_(1 - momentum).add_(momentum * unbiased.detach())
    bn.num_batches_tracked += 1


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode. The keep
    draws come from ``generator`` (a ``torch.Generator`` on the tensor's
    device; the device's default generator when None)."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)


class Dropout(nn.Module):
    """Elementwise dropout (the TPU package's flax ``nn.Dropout``): train
    mode keeps each element with probability 1 - rate, scaled by
    1 / (1 - rate); the identity in eval mode or at rate 0. The keep draws
    come from ``generator`` as in :class:`DropPath`."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype`` when given (the
    TPU package's Dense(dtype=...)), else in f32."""
    dt = dtype or torch.float32
    b = None if layer.bias is None else layer.bias.to(dt)
    return nn.functional.linear(x.to(dt), layer.weight.to(dt), b)
