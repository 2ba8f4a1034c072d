"""Segmentation losses (port of the CrossEntropyLoss of
ao_tpu/models/losses/misc.py).

A loss takes ``(pred, target, mask)``: pred (..., K) logits, target (...)
integer labels, mask an optional validity mask of the padded points.
Targets equal to ``ignore_index`` are excluded as well, and the reduction
is the mean over the contributing points.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .builder import LOSSES


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(
        self,
        weight: Optional[Sequence[float]] = None,
        size_average=None,
        reduce=None,
        reduction: str = "mean",
        label_smoothing: float = 0.0,
        loss_weight: float = 1.0,
        ignore_index: int = -1,
    ):
        if reduction != "mean":
            raise ValueError("CrossEntropyLoss: only reduction='mean' is ported")
        self.weight = None if weight is None else torch.tensor(
            weight, dtype=torch.float32)
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        K = pred.shape[-1]
        v = target != self.ignore_index
        if mask is not None:
            v = v & mask
        t = torch.where(v, target, 0).long()
        logp = torch.log_softmax(pred.float(), dim=-1)
        nll = -logp.gather(-1, t[..., None])[..., 0]
        if self.label_smoothing > 0:
            ls = self.label_smoothing
            nll = (1.0 - ls) * nll - ls / K * logp.sum(-1)
        vf = v.float()
        if self.weight is not None:
            w = self.weight.to(pred.device)[t] * vf
            return self.loss_weight * (w * nll).sum() / torch.clamp_min(
                w.sum(), 1e-12)
        return self.loss_weight * (nll * vf).sum() / torch.clamp_min(
            vf.sum(), 1.0)
