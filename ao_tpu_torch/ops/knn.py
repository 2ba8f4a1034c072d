"""Exact batched kNN (port of ao_tpu/ops/knn.py).

Used below ``interpolation._EXACT_PAIR_BUDGET`` query x key pairs, where
the full (B, M, N) score matrix is small. Scores rank as
``|k|^2 - 2 q.k`` (invalid keys carry a 1e30 penalty), ties go to the
lower key index (a stable sort), and the returned distances are recomputed
by subtract-and-square, as in the JAX version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e30


def knn(
    query_coord: torch.Tensor,  # (B, M, 3)
    key_coord: torch.Tensor,  # (B, N, 3)
    k: int,
    query_mask: Optional[torch.Tensor] = None,  # (B, M) bool
    key_mask: Optional[torch.Tensor] = None,  # (B, N) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(idx, dist, valid)``, each (B, M, k): int32 key indices in
    ascending distance, Euclidean distances and a validity mask (False
    where fewer than k valid keys exist or the query is padding)."""
    B, M, _ = query_coord.shape
    N = key_coord.shape[1]
    dev = query_coord.device
    if query_mask is None:
        query_mask = torch.ones((B, M), dtype=torch.bool, device=dev)
    if key_mask is None:
        key_mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    q = query_coord.detach().float()
    kc = key_coord.detach().float()
    pen = torch.where(key_mask, 0.0, _BIG)
    k2 = (kc * kc).sum(-1) + pen
    s = k2[:, None, :] - 2.0 * torch.bmm(q, kc.transpose(1, 2))
    s, order = torch.sort(s, dim=-1, stable=True)
    kk = min(k, N)
    d2, idx = s[..., :kk], order[..., :kk]
    if kk < k:
        d2 = torch.cat([d2, d2.new_full((B, M, k - kk), _BIG)], dim=-1)
        idx = torch.cat([idx, idx.new_zeros((B, M, k - kk))], dim=-1)
    valid = (d2 < _BIG / 2) & query_mask[:, :, None]
    sel = torch.gather(
        kc[:, None].expand(B, M, N, 3), 2, idx[..., None].expand(B, M, k, 3)
    )
    dist = torch.sqrt(((sel - q[:, :, None, :]) ** 2).sum(-1))
    idx = torch.where(valid, idx, 0).to(torch.int32)
    dist = torch.where(valid, dist, 0.0)
    return idx, dist, valid

