"""Lovasz-Softmax loss (port of ao_tpu/models/losses/lovasz.py; reference:
pointcept/models/losses/lovasz.py:210-257).

Every class is processed at once with static shapes, and the reference's
``classes='present'`` filter is a per-class weight: the mean runs over the
classes present among the contributing points. Ignored and padded points
contribute zero error and zero foreground, which leaves the Lovasz
extension unchanged (they sort last with error 0).

In a train step under a process group (``comm.global_batch()``) the loss
is the global batch's, as the JAX package's step on its mesh computes it:
every process gathers all processes' per-class errors and foreground
(each padded with zeros to the longest process's points, which sort last
and leave the extension unchanged), sorts the concatenation once in rank
order with a stable sort (the order one process gets on the concatenated
batch), takes the Lovasz gradient of the sorted foreground and keeps the
weights of its own points. It returns the sum of its own errors times
those weights over the global count of present classes. The weights do
not depend on the errors, so the processes' terms sum to the global loss
and their gradients (which the trainer sums) to its gradient.
"""

from __future__ import annotations

import torch

from ...utils import comm
from .builder import LOSSES


def _lovasz_grad(gt_sorted):
    """Gradient of the Lovasz extension with respect to the sorted errors,
    per class (rows of ``gt_sorted``)."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / torch.clamp_min(union, 1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _global_lovasz(errors, fg):
    """This process's term of the Lovasz loss over the global batch:
    ``errors`` and ``fg`` (C, n) are its own points'."""
    C, n = errors.shape
    both = comm.all_gather_padded(torch.stack([errors.detach(), fg]))
    world, _, _, longest = both.shape
    e_all, fg_all = both.permute(1, 2, 0, 3).reshape(2, C, world * longest)
    _, order = torch.sort(e_all, dim=1, descending=True, stable=True)
    weights = torch.empty_like(e_all).scatter_(
        1, order, _lovasz_grad(torch.gather(fg_all, 1, order)))
    start = comm.get_rank() * longest
    own = weights[:, start:start + n]
    present = fg_all.sum(1) > 0
    per_class = (errors * own).sum(1)
    return torch.where(present, per_class, 0.0).sum() / torch.clamp_min(
        present.sum().float(), 1.0)


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", loss_weight: float = 1.0,
                 ignore_index: int = -1, per_image: bool = False, **_):
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"LovaszLoss: mode {mode!r}")
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        C = pred.shape[-1]
        pred = pred.reshape(-1, C).float()
        target = target.reshape(-1)
        v = target != self.ignore_index
        if mask is not None:
            v = v & mask.reshape(-1)
        probs = torch.softmax(pred, dim=-1)
        t = torch.where(v, target, 0).long()
        fg = (torch.nn.functional.one_hot(t, C).float() * v[:, None]).T  # (C, N)
        errors = (fg - torch.where(v[None, :], probs.T, 0.0)).abs()
        if comm.in_global_batch():
            return self.loss_weight * _global_lovasz(errors, fg)
        errors_sorted, order = torch.sort(errors, dim=1, descending=True,
                                          stable=True)
        grad = _lovasz_grad(torch.gather(fg, 1, order))
        per_class = (errors_sorted * grad).sum(1)
        present = fg.sum(1) > 0
        loss = torch.where(present, per_class, 0.0).sum() / torch.clamp_min(
            present.sum().float(), 1.0)
        return self.loss_weight * loss
