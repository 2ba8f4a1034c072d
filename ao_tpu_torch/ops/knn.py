"""Exact batched kNN (port of ao_tpu/ops/knn.py).

Scores rank as ``|k|^2 - 2 q.k`` (invalid keys carry a 1e30 penalty;
``|k|^2`` in the order of XLA's fused multiply-adds, :func:`fma_chain`),
ties go to the lower key index (a stable sort; for k = 1 the first
minimum, the same key), and the returned distances are recomputed by
subtract-and-square, as in the JAX version.

Up to ``CHUNK_ELEMENTS`` scores (B x M x N) the whole score matrix is
built and stable-sorted, as for interpolation below its exact-pair budget
and the evaluator's 1-NN. Above it (MSC's cross-view matching: two views
of about 100k points a scene; PT-v1's first stages at 81920 points) each
scene's queries go in chunks whose (rows,
N) score tile stays within the budget; each chunk takes its k-th score
with ``torch.topk``, keeps every key that scores below it and fills the
places left with the lowest-index keys that score equal to it. So both
paths give the full stable sort's ids: ties go to the lowest key index, as
the JAX version's tiled merge keeps them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 1e30
# score elements (f32) of one chunk of the chunked path: 1 GiB
CHUNK_ELEMENTS = 2**28


def fma_chain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(c, c, fma(b, b, a * a)) in f32: ``|x|^2`` of x = (a, b, c) in
    the order of the JAX package's compiled ``jnp.sum(x * x, -1)`` on the
    CPU, where XLA contracts the sum into fused multiply-adds. Each fma is
    a float64 product (exact for two f32) and sum, rounded to f32, the same
    on every device: a true fused multiply-add's result except where the
    float64 sum, already rounded once, lies exactly halfway between two
    floats (a double rounding; about 2^-29 of operations on random
    inputs)."""
    acc = a * a
    acc = (b.double() * b.double() + acc.double()).float()
    return (c.double() * c.double() + acc.double()).float()


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
    k2 = fma_chain(kc[..., 0], kc[..., 1], kc[..., 2]) + pen
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


def _scores(q, kt, k2):
    """|k|^2 - 2 q.k of (rows, 3) queries against (3, N) keys, rounded as
    the full path rounds it (the product, then one subtraction), in place."""
    return torch.mm(q, kt).mul_(-2.0).add_(k2[None])


def _chunked(q, kc, k2, k, rows):
    """(d2, idx), each (B, M, k): every scene's queries ``rows`` at a time,
    the k best of each chunk's (rows, N) scores ordered by (score, key
    index), as the full stable sort orders them. ``torch.topk`` gives each
    row's k-th score v and the keys below it, in (score, index) order after
    two stable sorts; the places left go to the keys scoring exactly v in
    index order, found by a search of the running count of (score == v).
    Where torch.topk chose among keys tied at v, this keeps the lowest
    indices instead, within the chunk and with no host sync."""
    d2 = q.new_empty(q.shape[:2] + (k,))
    idx = torch.empty(q.shape[:2] + (k,), dtype=torch.long, device=q.device)
    place = torch.arange(k, device=q.device)
    for b in range(q.shape[0]):
        kt = kc[b].t()
        for r0 in range(0, q.shape[1], rows):
            s = _scores(q[b, r0:r0 + rows], kt, k2[b])
            if k == 1:
                v, i = s.min(dim=-1, keepdim=True)
            else:
                v, i = torch.topk(s, k, dim=-1, largest=False)
                vk = v[:, -1:]
                # the running count of keys scoring v; the j-th of them sits
                # where the count first reaches j
                eq = s == vk
                del s
                count = eq.to(torch.int32).cumsum_(dim=-1)
                del eq
                eq_pos = torch.searchsorted(count, (place + 1).to(torch.int32)
                                            .expand(len(vk), k).contiguous())
                del count
                i, order = i.sort(dim=-1)
                v, order = v.gather(-1, order).sort(dim=-1, stable=True)
                i = i.gather(-1, order)
                below = (v < vk).sum(-1, keepdim=True)
                fill = eq_pos.gather(-1, (place[None] - below).clamp_(min=0))
                i = torch.where(place[None] < below, i, fill)
            d2[b, r0:r0 + rows], idx[b, r0:r0 + rows] = v, i
    return d2, idx


def knn_query(k: int, coord: torch.Tensor,
              mask: Optional[torch.Tensor] = None):
    """Self-kNN mirroring ``pointops.knn_query`` (port of ao_tpu/ops/knn.py:
    knn_query): every point's k nearest points, itself included."""
    return knn(coord, coord, k, mask, mask)
