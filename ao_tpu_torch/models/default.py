"""Task wrapper modules (port of ao_tpu/models/default.py)."""

from __future__ import annotations

import inspect

from torch import nn

from .builder import MODELS


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    """Per-point segmentation: the backbone's logits. A backbone whose
    ``forward`` takes ``discrete_coord`` (the sparse-convolution U-Nets)
    gets the batch's, as the reference feeds spconv GridSample's grid
    coordinates; the others take coord, feat and mask."""

    def __init__(self, backbone=None):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = "discrete_coord" in inspect.signature(
            backbone.forward).parameters

    def forward(self, coord, feat, mask, discrete_coord=None):
        if self._takes_dc:
            return self.backbone(coord, feat, mask, discrete_coord=discrete_coord)
        return self.backbone(coord, feat, mask)
