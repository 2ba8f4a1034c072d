"""Shared model building blocks (port of ao_tpu/models/utils.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class PointBatchNorm(nn.Module):
    """BatchNorm over points for padded batches, in eval mode: normalises
    with the running statistics and zeroes padded rows. ``norm`` is a
    BatchNorm1d so that parameter names follow the reference
    (``<name>.norm.weight`` ...). Masked batch statistics (train mode) come
    with the training slice."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.norm = nn.BatchNorm1d(features, eps=eps)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if self.training:
            raise NotImplementedError(
                "PointBatchNorm runs in eval mode only (the training slice "
                "is not ported yet)"
            )
        n = self.norm
        y = (x.float() - n.running_mean) * torch.rsqrt(n.running_var + n.eps)
        y = y * n.weight + n.bias
        if mask is not None:
            y = torch.where(mask[..., None], y, 0.0)
        return y.to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode."""

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
        u = torch.rand(shape, generator=self.generator, device="cpu")
        return torch.where((u < keep).to(x.device), x / keep, 0.0)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype`` when given (the
    TPU package's Dense(dtype=...)), else in f32."""
    dt = dtype or torch.float32
    b = None if layer.bias is None else layer.bias.to(dt)
    return nn.functional.linear(x.to(dt), layer.weight.to(dt), b)
