"""Lovasz-Softmax loss (port of ao_tpu/models/losses/lovasz.py; reference:
pointcept/models/losses/lovasz.py:210-257).

Every class is processed at once with static shapes, and the reference's
``classes='present'`` filter is a per-class weight: the mean runs over the
classes present among the contributing points. Ignored and padded points
contribute zero error and zero foreground, which leaves the Lovasz
extension unchanged (they sort last with error 0).

The loss sorts the errors of the whole batch, so it is not a sum over
points and does not split across processes: in a train step under a
process group (``comm.global_batch()``) it raises (ROADMAP.md queue 1).
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


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", loss_weight: float = 1.0,
                 ignore_index: int = -1, per_image: bool = False, **_):
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"LovaszLoss: mode {mode!r}")
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None):
        if comm.in_global_batch():
            raise NotImplementedError(
                "LovaszLoss sorts the errors of the whole batch and is not "
                "ported to data parallelism: train its configs in one process")
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
        errors_sorted, order = torch.sort(errors, dim=1, descending=True,
                                          stable=True)
        grad = _lovasz_grad(torch.gather(fg, 1, order))
        per_class = (errors_sorted * grad).sum(1)
        present = fg.sum(1) > 0
        loss = torch.where(present, per_class, 0.0).sum() / torch.clamp_min(
            present.sum().float(), 1.0)
        return self.loss_weight * loss
