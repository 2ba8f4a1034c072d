"""Context-Aware Classifier segmentor, CAC-v1m1 (port of
ao_tpu/models/context_aware_classifier/cac.py; reference: pointcept/models/
context_aware_classifier/context_aware_classifier_v1m1_base.py:15-270).

The seg head's weight rows are the class prototypes. Per scene,
prediction-weighted feature prototypes refine the logits through a
projection and a cosine classifier (``post_refine``); in training a
ground-truth-prototype "adaptive perspective" branch
(``adaptive_perspective``) supervises it, and an entropy-weighted
distillation (``cac_distill_loss``) ties the two. Per-scene loops are
masked batched einsums over the padded (B, N, C) batch, as in the JAX
package. Both branches run ``feat_proj_layer``, whose BatchNorm therefore
takes two running updates a train step, as there.

The loss belongs to the model, as in the reference: in train mode the
forward takes ``segment`` and returns ``loss`` = main_weight crit(refined
logits) + pre_weight crit(adaptive-perspective logits) + pre_self_weight
crit(seg-head logits) + kl_weight cac_distill_loss(refined, adaptive
detached), its four terms (``seg_loss``, ``pre_loss``, ``pre_self_loss``,
``kl_loss``) and the three logits (``seg_logits`` the refined ones,
``pre_logits``, ``cac_pred``). ``crit`` is the config's ``criteria``, or
``CrossEntropyLoss(ignore_index=-1)`` where it names none. In eval mode it
returns ``seg_logits`` (refined) and ``pre_logits``, and ``loss`` =
crit(refined) when given ``segment``.

Parameter names are the reference's: ``seg_head`` (Linear, its weight the
prototype bank), ``proj`` and ``apd_proj`` (Linear-ReLU-Linear on the
concatenated prototypes), ``feat_proj_layer`` (Linear, PointBatchNorm,
ReLU, Linear).
"""

from __future__ import annotations

import torch
from torch import nn

from ..builder import MODELS
from ..default import call_backbone, takes_discrete_coord
from ..losses import build_criteria
from ..utils import PointBatchNorm

DEFAULT_CRITERIA = (dict(type="CrossEntropyLoss", loss_weight=1.0,
                         ignore_index=-1),)


def _normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def _proj(c):
    return nn.Sequential(nn.Linear(2 * c, 2 * c, bias=False), nn.ReLU(),
                         nn.Linear(2 * c, c))


class FeatProj(nn.Sequential):
    """Linear, PointBatchNorm over the valid points, ReLU, Linear."""

    def __init__(self, c):
        super().__init__(nn.Linear(c, c, bias=False), PointBatchNorm(c),
                         nn.ReLU(), nn.Linear(c, c))

    def forward(self, x, mask):
        return self[3](self[2](self[1](self[0](x), mask)))


def _onehot(labels, k):
    """(..., k) float one-hot of integer labels; labels outside 0..k-1
    (ignore) give a zero row."""
    return (labels[..., None] == torch.arange(k, device=labels.device)).float()


@MODELS.register_module("CAC-v1m1")
class CACSegmentor(nn.Module):
    def __init__(self, backbone=None, num_classes=13, backbone_out_channels=96,
                 cos_temp=15.0, main_weight=1.0, pre_weight=1.0,
                 pre_self_weight=1.0, kl_weight=1.0, conf_thresh=0.0,
                 detach_pre_logits=False, criteria=None):
        super().__init__()
        c = backbone_out_channels
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)
        self.num_classes = num_classes
        self.cos_temp = cos_temp
        self.main_weight = main_weight
        self.pre_weight = pre_weight
        self.pre_self_weight = pre_self_weight
        self.kl_weight = kl_weight
        self.conf_thresh = conf_thresh
        self.detach_pre_logits = detach_pre_logits
        self.seg_head = nn.Linear(c, num_classes)
        self.proj = _proj(c)
        self.apd_proj = _proj(c)
        self.feat_proj_layer = FeatProj(c)
        self.criteria = build_criteria(list(criteria or DEFAULT_CRITERIA))

    def _cos_pred(self, x, proto):
        return torch.einsum("bnc,bkc->bnk", _normalize(x), _normalize(proto))

    def post_refine(self, feat, pred, mask):
        """Prediction-weighted per-scene prototypes -> refined cosine
        logits (reference post_refine_proto_batch :99-150, batched)."""
        proto = self.seg_head.weight
        if self.detach_pre_logits:
            pred = pred.detach()
        w = torch.softmax(pred, dim=-1)
        if self.conf_thresh > 0:
            w = w * (w.max(-1, keepdim=True).values >= self.conf_thresh)
        w = w * mask[..., None]
        denom = w.sum(1)[..., None]
        pred_proto = torch.einsum("bnk,bnc->bkc", w, feat) / (denom + 1e-7)
        pred_proto = torch.cat([pred_proto, proto[None].expand_as(pred_proto)], -1)
        return self._cos_pred(self.feat_proj_layer(feat, mask),
                              self.proj(pred_proto))

    def adaptive_perspective(self, feat, target, mask):
        """Ground-truth class prototypes where the class is present, the
        learned (detached) ones elsewhere (reference get_adaptive_perspective
        :74-97, batched)."""
        proto = self.seg_head.weight
        onehot = _onehot(torch.where(mask, target, -1), self.num_classes)
        cnt = onehot.sum(1)
        gt_proto = torch.einsum("bnk,bnc->bkc", onehot, feat) / (cnt[..., None] + 1e-4)
        base = proto.detach()[None].expand_as(gt_proto)
        new_proto = torch.where((cnt > 0)[..., None], gt_proto, base)
        new_proto = torch.cat([new_proto, proto[None].expand_as(new_proto)], -1)
        return self._cos_pred(self.feat_proj_layer(feat, mask),
                              self.apd_proj(new_proto))

    def forward(self, coord, feat, mask, discrete_coord=None, segment=None):
        h = call_backbone(self.backbone, self._takes_dc, coord, feat, mask,
                          discrete_coord)
        pre_logits = self.seg_head(h)
        refine = self.post_refine(h, pre_logits, mask) * self.cos_temp
        out = dict(seg_logits=refine, pre_logits=pre_logits)
        if segment is None:
            if self.training:
                raise ValueError("CAC-v1m1 trains on segment: the loss is the model's")
            return out
        segment = segment.long()
        if not self.training:
            out["loss"] = self.criteria(refine, segment, mask)
            return out
        cac_pred = self.adaptive_perspective(h, segment, mask) * self.cos_temp
        terms = dict(
            seg_loss=self.criteria(refine, segment, mask) * self.main_weight,
            pre_loss=self.criteria(cac_pred, segment, mask) * self.pre_weight,
            pre_self_loss=self.criteria(pre_logits, segment, mask) * self.pre_self_weight,
            kl_loss=cac_distill_loss(refine, cac_pred.detach(), segment, mask)
            * self.kl_weight)
        return dict(out, cac_pred=cac_pred, loss=sum(terms.values()), **terms)


def cac_distill_loss(pred, soft, target, mask, smoothness=0.5, eps=0.0):
    """Entropy-weighted class-balanced distillation (reference
    get_distill_loss :152-199), batched and masked: the cross entropy of
    ``pred`` against a blend of softmax(``soft``) and the one-hot target,
    averaged per class weighted by the soft prediction's entropy, then over
    the classes present."""
    K = pred.shape[-1]
    soft = soft.detach()
    valid = (target != -1) & mask
    onehot = _onehot(torch.where(valid, target, 0), K) * valid[..., None]
    sm = torch.softmax(soft, dim=-1)
    label = smoothness * sm + (1 - smoothness) * onehot
    if eps > 0:
        label = label * (1 - eps) + (1 - label) * eps / (K - 1)
    ce = -(torch.log_softmax(pred, dim=-1) * label).sum(-1)
    entropy = -(sm * torch.log(sm + 1e-4)).sum(-1) * valid
    w = entropy[..., None] * onehot
    per_class = (ce[..., None] * w).sum((0, 1)) / (w.sum((0, 1)) + 1e-4)
    present = onehot.sum((0, 1)) > 0
    return torch.where(present, per_class, 0.0).sum() / (present.sum() + 1e-4)
