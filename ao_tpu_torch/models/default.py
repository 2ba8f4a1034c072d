"""Task wrapper modules (port of ao_tpu/models/default.py)."""

from __future__ import annotations

import inspect

from torch import nn

from .builder import MODELS


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
    coordinates; the others take coord, feat and mask."""

    def __init__(self, backbone=None):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)

    def forward(self, coord, feat, mask, discrete_coord=None):
        return call_backbone(self.backbone, self._takes_dc, coord, feat, mask,
                             discrete_coord)
