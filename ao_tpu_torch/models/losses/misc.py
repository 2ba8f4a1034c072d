"""Losses (port of ao_tpu/models/losses/misc.py): CrossEntropyLoss,
SmoothCELoss, BinaryFocalLoss, FocalLoss and DiceLoss.

A loss takes ``(pred, target, mask)``: pred (..., K) logits, target (...)
integer labels, mask an optional validity mask of the padded points.
Targets equal to ``ignore_index`` are excluded as well, and the reduction
is the mean over the contributing points.

Under a process group the mean is the global batch's, as the JAX package
takes it over its data mesh axis: each process returns its own points' sum
over the global denominator (:func:`global_den`), so that the sum over the
processes of their losses, and of their gradients, is the global mean's.
DiceLoss, a ratio of per-class sums, sums those over the processes
(differentiably) and returns its share, the loss over the world size.
That holds inside ``comm.global_batch()``, where the trainer takes its
step's loss; elsewhere (evaluation) every loss is its own batch's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...utils import comm
from .builder import LOSSES


def global_den(d):
    """A loss's denominator (a count or a weight sum, no gradient) summed
    over the processes of the group inside ``comm.global_batch()`` (the
    trainer's step); ``d`` itself elsewhere, where each process scores its
    own batches (the evaluator sums them)."""
    return comm.all_reduce(d) if comm.in_global_batch() else d


def _valid_mask(target, mask, ignore_index):
    v = target != ignore_index
    return v if mask is None else v & mask


def _mean(x, v):
    return torch.where(v, x, 0.0).sum() / torch.clamp_min(
        global_den(v.float().sum()), 1.0)


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
                global_den(w.sum()), 1e-12)
        return self.loss_weight * (nll * vf).sum() / torch.clamp_min(
            global_den(vf.sum()), 1.0)


@LOSSES.register_module()
class SmoothCELoss:
    """Cross entropy against labels smoothed by ``smoothing_ratio``."""

    def __init__(self, smoothing_ratio: float = 0.1, ignore_index: int = -1,
                 loss_weight: float = 1.0):
        self.eps = smoothing_ratio
        self.ignore_index = ignore_index
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None):
        C = pred.shape[-1]
        v = _valid_mask(target, mask, self.ignore_index)
        t = torch.where(v, target, 0).long()
        logp = torch.log_softmax(pred.float(), dim=-1)
        onehot = torch.nn.functional.one_hot(t, C) * (1 - self.eps) + self.eps / C
        return self.loss_weight * _mean(-(onehot * logp).sum(-1), v)


@LOSSES.register_module()
class BinaryFocalLoss:
    """Focal loss of (N,) logits (or probabilities, ``logits=False``)
    against targets in {0, 1}."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.5, logits: bool = True,
                 reduce: bool = True, loss_weight: float = 1.0):
        self.gamma, self.alpha = gamma, alpha
        self.logits, self.reduce = logits, reduce
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None):
        pred = pred.float()
        t = target.float()
        if self.logits:
            p = torch.sigmoid(pred)
            bce = (torch.clamp_min(pred, 0) - pred * t
                   + torch.log1p(torch.exp(-pred.abs())))
        else:
            p = pred
            bce = -(t * torch.log(p + 1e-12) + (1 - t) * torch.log(1 - p + 1e-12))
        pt = p * t + (1 - p) * (1 - t)
        at = self.alpha * t + (1 - self.alpha) * (1 - t)
        focal = at * (1 - pt) ** self.gamma * bce
        v = torch.ones_like(t, dtype=torch.bool) if mask is None else mask
        if self.reduce:
            return self.loss_weight * _mean(focal, v)
        return self.loss_weight * torch.where(v, focal, 0.0)


@LOSSES.register_module()
class FocalLoss:
    """Multi-class focal loss with a scalar ``alpha``."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.5,
                 reduction: str = "mean", loss_weight: float = 1.0,
                 ignore_index: int = -1):
        self.gamma, self.alpha = gamma, alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        v = _valid_mask(target, mask, self.ignore_index)
        t = torch.where(v, target, 0).long()
        logp = torch.log_softmax(pred.float(), dim=-1)
        logpt = logp.gather(-1, t[..., None])[..., 0]
        focal = -self.alpha * (1 - torch.exp(logpt)) ** self.gamma * logpt
        if self.reduction == "mean":
            return self.loss_weight * _mean(focal, v)
        return self.loss_weight * torch.where(v, focal, 0.0).sum()


@LOSSES.register_module()
class DiceLoss:
    """1 - the soft Dice coefficient per class, averaged over classes."""

    def __init__(self, smooth: float = 1.0, exponent: float = 2.0,
                 loss_weight: float = 1.0, ignore_index: int = -1):
        self.smooth, self.exponent = smooth, exponent
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        C = pred.shape[-1]
        v = _valid_mask(target, mask, self.ignore_index)
        t = torch.where(v, target, 0).long()
        vf = v[..., None].float()
        p = (torch.softmax(pred.float(), dim=-1) * vf).reshape(-1, C)
        onehot = (torch.nn.functional.one_hot(t, C) * vf).reshape(-1, C)
        share = comm.in_global_batch()  # as in global_den
        total = comm.all_reduce_grad if share else (lambda x: x)
        num = 2.0 * total((p * onehot).sum(0)) + self.smooth
        den = (total((p ** self.exponent).sum(0))
               + total((onehot ** self.exponent).sum(0)) + self.smooth)
        world = comm.get_world_size() if share else 1
        return self.loss_weight * (1.0 - num / den).mean() / world
