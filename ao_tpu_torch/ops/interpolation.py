"""Inverse-distance-weighted k-NN interpolation (port of
ao_tpu/ops/interpolation.py): each destination point blends the features
of its k (=3) nearest source points, weighted by 1/(dist + 1e-8)
normalised over the found neighbours."""

from __future__ import annotations

from typing import Optional

import torch

from .grouping import grouping
from .knn import knn
from .knn_spatial import knn_cross_spatial

# above this many query x key pairs the curve-window search replaces the
# exact kNN (the same budget as the JAX package, so both take one path)
_EXACT_PAIR_BUDGET = 2_000_000


def interpolation(
    src_coord: torch.Tensor,  # (B, N, 3) coarse coords
    dst_coord: torch.Tensor,  # (B, M, 3) fine coords
    src_feat: torch.Tensor,  # (B, N, C)
    src_mask: Optional[torch.Tensor] = None,  # (B, N)
    dst_mask: Optional[torch.Tensor] = None,  # (B, M)
    k: int = 3,
) -> torch.Tensor:
    if src_coord.shape[1] * dst_coord.shape[1] > _EXACT_PAIR_BUDGET:
        idx, dist, valid = knn_cross_spatial(
            dst_coord, src_coord, k, dst_mask, src_mask,
            tile_q=512, window=512, probes=2,
        )
    else:
        idx, dist, valid = knn(dst_coord, src_coord, k, dst_mask, src_mask)
    w = torch.where(valid, 1.0 / (dist + 1e-8), 0.0)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    neigh = grouping(src_feat, idx, valid)  # (B, M, k, C)
    out = (neigh * w[..., None]).sum(2)
    if dst_mask is not None:
        out = torch.where(dst_mask[..., None], out, 0.0)
    return out
