"""Neighbour gathering (port of ao_tpu/ops/grouping.py)."""

from __future__ import annotations

from typing import Optional

import torch


def grouping(
    feat: torch.Tensor,  # (B, N, C)
    idx: torch.Tensor,  # (B, M, k) into N
    valid: Optional[torch.Tensor] = None,  # (B, M, k) bool
) -> torch.Tensor:
    """Gather neighbour features -> (B, M, k, C); invalid slots are zeroed.
    A ``torch.gather`` along N, whose backward is a scatter-add (advanced
    indexing's backward sorts the indices first)."""
    B, M, k = idx.shape
    C = feat.shape[-1]
    flat = idx.reshape(B, M * k, 1).long().expand(B, M * k, C)
    gathered = torch.gather(feat, 1, flat).reshape(B, M, k, C)
    if valid is not None:
        gathered = torch.where(valid[..., None], gathered, 0.0)
    return gathered


def grouping_with_rel_coord(
    coord: torch.Tensor,  # (B, N, 3) key coordinates
    query_coord: torch.Tensor,  # (B, M, 3)
    idx: torch.Tensor,  # (B, M, k)
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Relative neighbour positions (B, M, k, 3), zeroed where invalid."""
    rel = grouping(coord, idx) - query_coord[:, :, None, :]
    if valid is not None:
        rel = torch.where(valid[..., None], rel, 0.0)
    return rel
