"""Exact batched kNN (port of ao_tpu/ops/knn.py).

Scores rank as ``|k|^2 - 2 q.k`` (invalid keys carry a 1e30 penalty),
ties go to the lower key index (a stable sort; for k = 1 the first
minimum, the same key), and the returned distances are recomputed by
subtract-and-square, as in the JAX version.

Up to ``CHUNK_ELEMENTS`` scores (B x M x N) the whole score matrix is
built and stable-sorted, as for interpolation below its exact-pair budget
and the evaluator's 1-NN. Above it (MSC's cross-view matching: two views
of about 100k points a scene) each scene's queries go in chunks whose (rows,
N) score tile stays within the budget; each chunk takes its k best with
``torch.topk`` and orders them by (score, key index) with stable sorts.
So ties inside the k come out as the full stable sort gives them; which
of several keys tied at the k-th place is kept is ``torch.topk``'s choice
(the JAX version's tiled merge keeps the lowest index).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e30
# score elements (f32) of one chunk of the chunked path: 1 GiB
CHUNK_ELEMENTS = 2**28


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
    kk = min(k, N)
    if B * M * N <= CHUNK_ELEMENTS:
        s = k2[:, None, :] - 2.0 * torch.bmm(q, kc.transpose(1, 2))
        if kk == 1:  # the first minimum: the stable sort's first entry
            d2, idx = s.min(dim=-1, keepdim=True)
        else:
            s, order = torch.sort(s, dim=-1, stable=True)
            d2, idx = s[..., :kk], order[..., :kk]
    else:
        d2, idx = _chunked(q, kc, k2, kk, max(CHUNK_ELEMENTS // N, 1))
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


def _chunked(q, kc, k2, k, rows):
    """(d2, idx), each (B, M, k): every scene's queries ``rows`` at a time,
    the k best of each chunk's (rows, N) scores by torch.topk, ordered by
    (score, key index)."""
    d2 = q.new_empty(q.shape[:2] + (k,))
    idx = torch.empty(q.shape[:2] + (k,), dtype=torch.long, device=q.device)
    for b in range(q.shape[0]):
        kt = kc[b].t()
        for r0 in range(0, q.shape[1], rows):
            s = torch.addmm(k2[b][None], q[b, r0:r0 + rows], kt, alpha=-2.0)
            if k == 1:
                v, i = s.min(dim=-1, keepdim=True)
            else:
                v, i = torch.topk(s, k, dim=-1, largest=False)
                i, order = i.sort(dim=-1)
                v, order = v.gather(-1, order).sort(dim=-1, stable=True)
                i = i.gather(-1, order)
            d2[b, r0:r0 + rows], idx[b, r0:r0 + rows] = v, i
    return d2, idx
