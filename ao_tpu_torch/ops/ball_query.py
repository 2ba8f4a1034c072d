"""Radius-bounded neighbour search (port of ao_tpu/ops/ball_query.py;
reference: libs/pointops/src/ball_query/ball_query_cuda_kernel.cu and
functions/query.py:73-108).

Built on the exact kNN (ops/knn.py), as the JAX package builds it on its
tiled kNN in XLA (no TPU kernel). ``ball_query``: each query's ``nsample``
nearest keys with min_radius <= dist < max_radius, in ascending distance,
the empty slots padded with the first in-ball key (the reference's
padding). ``random_ball_query``: a uniformly random ``nsample`` of the
in-ball keys among the ``candidate_factor * nsample`` nearest, drawn from
an explicit ``torch.Generator`` on the data's device (the reference's CUDA kernel scans a
shuffled key order), padded the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .knn import knn


def _pad_with_first(idx, dist, in_ball):
    """Empty slots take the first in-ball slot's key and distance; a query
    with none stays all invalid."""
    has_any = in_ball.any(-1, keepdim=True)
    first = in_ball.to(torch.int8).argmax(-1, keepdim=True)
    idx = torch.where(in_ball, idx, torch.gather(idx, -1, first))
    dist = torch.where(in_ball, dist, torch.gather(dist, -1, first))
    return idx, dist, has_any.expand_as(in_ball)


@torch.no_grad()
def ball_query(query_coord: torch.Tensor, key_coord: torch.Tensor,
               nsample: int, min_radius: float = 0.0, max_radius: float = 1.0,
               query_mask: Optional[torch.Tensor] = None,
               key_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx, dist, valid), each (B, M, nsample)."""
    idx, dist, valid = knn(query_coord, key_coord, nsample, query_mask,
                           key_mask)
    in_ball = valid & (dist >= min_radius) & (dist < max_radius)
    return _pad_with_first(idx, dist, in_ball)


@torch.no_grad()
def random_ball_query(query_coord: torch.Tensor, key_coord: torch.Tensor,
                      nsample: int, min_radius: float = 0.0,
                      max_radius: float = 1.0,
                      query_mask: Optional[torch.Tensor] = None,
                      key_mask: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      candidate_factor: int = 4
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx, dist, valid), each (B, M, nsample): the in-ball keys of the
    largest random scores (uniform, from ``generator``), then the slots
    with no in-ball key padded with the first drawn one."""
    idx, dist, valid = knn(query_coord, key_coord, nsample * candidate_factor,
                           query_mask, key_mask)
    in_ball = valid & (dist >= min_radius) & (dist < max_radius)
    u = torch.rand(in_ball.shape, generator=generator, device=in_ball.device)
    score = torch.where(in_ball, u, -1.0)
    pick = torch.topk(score, nsample, dim=-1).indices
    idx, dist, sel = (torch.gather(t, -1, pick) for t in (idx, dist, in_ball))
    return _pad_with_first(idx, dist, sel)
