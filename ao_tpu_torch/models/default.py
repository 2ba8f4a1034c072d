"""Task wrapper modules (port of ao_tpu/models/default.py)."""

from __future__ import annotations

from torch import nn

from .builder import MODELS


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    """Per-point segmentation: the backbone's logits."""

    def __init__(self, backbone=None):
        super().__init__()
        self.backbone = backbone

    def forward(self, coord, feat, mask):
        return self.backbone(coord, feat, mask)
