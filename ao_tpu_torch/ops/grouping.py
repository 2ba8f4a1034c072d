"""Neighbour gathering (port of ao_tpu/ops/grouping.py)."""

from __future__ import annotations

from typing import Optional

import torch


def grouping(
    feat: torch.Tensor,  # (B, N, C)
    idx: torch.Tensor,  # (B, M, k) into N
    valid: Optional[torch.Tensor] = None,  # (B, M, k) bool
) -> torch.Tensor:
    """Gather neighbour features -> (B, M, k, C); invalid slots are zeroed."""
    B = feat.shape[0]
    bidx = torch.arange(B, device=feat.device)[:, None, None]
    gathered = feat[bidx, idx.long()]
    if valid is not None:
        gathered = torch.where(valid[..., None], gathered, 0.0)
    return gathered
