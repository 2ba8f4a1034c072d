"""Partition-based (grid) pooling with fixed shapes (port of
ao_tpu/ops/grid_pool.py).

Points are sorted by voxel key; key changes start clusters, whose ids
(ascending voxel-key order, as the reference's sorted ``torch.unique``)
index a static-capacity buffer of ``max_clusters`` rows with a validity
mask. Clusters beyond the capacity merge into the last one. Coordinates
are mean-pooled and features max-pooled; the per-point cluster map serves
'map' unpooling.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e30
_INT32_MAX = 2**31 - 1


@torch.no_grad()
def _cluster_ids(coord, mask, grid_size, max_clusters):
    B, N, _ = coord.shape
    start = torch.where(mask[..., None], coord, _BIG).amin(dim=1)  # (B, 3)
    d = torch.floor((coord - start[:, None]) / grid_size).to(torch.int64)
    d = torch.where(mask[..., None], d, 0)
    extent = d.amax(dim=1) + 1  # (B, 3)
    key = (d[..., 0] * extent[:, None, 1] + d[..., 1]) * extent[:, None, 2] + d[..., 2]
    key = torch.where(mask, key, _INT32_MAX)  # padding sorts last
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    mask_sorted = torch.gather(mask, 1, order)
    new_cluster = torch.ones_like(mask_sorted)
    new_cluster[:, 1:] = key_sorted[:, 1:] != key_sorted[:, :-1]
    new_cluster &= mask_sorted
    cid_sorted = torch.cumsum(new_cluster.to(torch.int64), dim=1) - 1
    n_clusters = torch.where(mask_sorted, cid_sorted, -1).amax(dim=1) + 1
    cluster = torch.empty_like(cid_sorted).scatter_(1, order, cid_sorted)
    cluster = torch.clamp_max(cluster, max_clusters - 1)
    cluster = torch.where(mask, cluster, max_clusters - 1)
    return cluster, n_clusters


def grid_pool(
    coord: torch.Tensor,  # (B, N, 3)
    feat: torch.Tensor,  # (B, N, C)
    mask: torch.Tensor,  # (B, N) bool
    grid_size: float,
    max_clusters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (pooled_coord (B,M,3), pooled_feat (B,M,C) max-reduced,
    pooled_mask (B,M), cluster (B,N) int64 map into M, n_clusters (B,))."""
    B, N, C = feat.shape
    M = max_clusters
    cluster, n_clusters = _cluster_ids(coord, mask, grid_size, M)
    # invalid points go to a dropped bucket M of each batch row
    seg = torch.where(mask, cluster, M) + torch.arange(
        B, device=coord.device)[:, None] * (M + 1)
    seg = seg.reshape(-1)
    counts = torch.zeros(B * (M + 1), dtype=coord.dtype, device=coord.device)
    counts.index_add_(0, seg, mask.reshape(-1).to(coord.dtype))
    coord_sum = torch.zeros((B * (M + 1), 3), dtype=coord.dtype,
                            device=coord.device)
    coord_sum.index_add_(
        0, seg, torch.where(mask[..., None], coord, 0.0).reshape(-1, 3)
    )
    pooled_feat = torch.full((B * (M + 1), C), -_BIG, dtype=feat.dtype,
                             device=feat.device)
    pooled_feat.scatter_reduce_(
        0, seg[:, None].expand(-1, C),
        torch.where(mask[..., None], feat, -_BIG).reshape(-1, C),
        reduce="amax", include_self=True,
    )
    counts = counts.reshape(B, M + 1)[:, :M]
    coord_sum = coord_sum.reshape(B, M + 1, 3)[:, :M]
    pooled_feat = pooled_feat.reshape(B, M + 1, C)[:, :M]
    pooled_coord = coord_sum / torch.clamp_min(counts[..., None], 1.0)
    pooled_mask = counts > 0
    pooled_feat = torch.where(pooled_mask[..., None], pooled_feat, 0.0)
    pooled_coord = torch.where(pooled_mask[..., None], pooled_coord, 0.0)
    return pooled_coord, pooled_feat, pooled_mask, cluster, n_clusters


def unpool_map(pooled_feat: torch.Tensor, cluster: torch.Tensor,
               point_mask: torch.Tensor) -> torch.Tensor:
    """'map' unpooling: each cluster's feature back to its member points."""
    up = torch.gather(
        pooled_feat, 1,
        cluster[..., None].expand(-1, -1, pooled_feat.shape[-1]),
    )
    return torch.where(point_mask[..., None], up, 0.0)
