"""Task wrapper modules (port of ao_tpu/models/default.py)."""

from __future__ import annotations

import inspect

import torch
from torch import nn

from .builder import MODELS
from .utils import ClassifierHead


def takes_discrete_coord(backbone) -> bool:
    """True when the backbone's ``forward`` takes ``discrete_coord``."""
    return "discrete_coord" in inspect.signature(backbone.forward).parameters


def call_backbone(backbone, takes_dc, coord, feat, mask, discrete_coord=None):
    """The backbone on coord, feat and mask, with ``discrete_coord`` where
    ``takes_dc`` (:func:`takes_discrete_coord`)."""
    if takes_dc:
        return backbone(coord, feat, mask, discrete_coord=discrete_coord)
    return backbone(coord, feat, mask)


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    """Per-point segmentation: the backbone's logits. A backbone whose
    ``forward`` takes ``discrete_coord`` (the sparse-convolution U-Nets)
    gets the batch's, as the reference feeds spconv GridSample's grid
    coordinates; one whose ``forward`` takes ``category`` (PT-v1 part
    segmentation: ``takes_category``) gets the shape class when one is
    given; the others take coord, feat and mask."""

    def __init__(self, backbone=None):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)
        self.takes_category = (
            "category" in inspect.signature(backbone.forward).parameters)

    def forward(self, coord, feat, mask, discrete_coord=None, category=None):
        if category is not None and self.takes_category:
            return self.backbone(coord, feat, mask, category=category)
        return call_backbone(self.backbone, self._takes_dc, coord, feat, mask,
                             discrete_coord)


@MODELS.register_module()
class DefaultClassifier(nn.Module):
    """Backbone features -> (B, C) embedding -> Linear-BN-ReLU-Dropout x2 ->
    Linear (reference default.py:268-278). A backbone that returns (B, N,
    C) per-point features is pooled by a masked mean and max, concatenated
    (2C); one that returns (B, C) already (SpUNet's ``cls_mode``) is taken
    as it is. The first Linear takes ``backbone_embed_dim`` for the latter,
    twice it for the former. Dropout draws from the trainer's generator."""

    def __init__(self, backbone=None, num_classes: int = 40,
                 backbone_embed_dim: int = 256):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)
        pooled = not getattr(backbone, "cls_mode", False)
        self.head = ClassifierHead(backbone_embed_dim * (2 if pooled else 1),
                                   num_classes)

    def forward(self, coord, feat, mask, discrete_coord=None):
        h = call_backbone(self.backbone, self._takes_dc, coord, feat, mask,
                          discrete_coord)
        if h.dim() == 3:  # (B, N, C) per-point features -> global pool
            m = mask[..., None].to(h.dtype)
            mean = (h * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
            mx = torch.amax(torch.where(mask[..., None], h, -torch.inf), dim=1)
            h = torch.cat([mean, mx], dim=-1)
        return self.head(h)
