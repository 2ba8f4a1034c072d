"""Farthest point sampling (port of ao_tpu/ops/sampling.py).

:func:`farthest_point_sampling` launches ``csrc/fps.cu`` for CUDA tensors
and counts the launch in ``farthest_point_sampling.launches``; for CPU
tensors it runs :func:`farthest_point_sampling_plain`, a loop over the
samples vectorised over the batch, with the same arithmetic: running
``min_d2`` from 1e30, d2 = fma(dz, dz, fma(dy, dy, dx * dx)) in the order
of XLA's fused multiply-adds in the JAX package's ``jnp.sum(diff * diff,
-1)`` (each fma through float64, :func:`~.knn.fma_chain`: a true fused
multiply-add but for a rare double rounding), padded points scoring
-1e30, the next sample the first maximum (the lowest index).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _native
from .knn import fma_chain

_BIG = 1e30


def _valid(mask: torch.Tensor, m: int) -> torch.Tensor:
    """(B, m): sample i is meaningful while i < the scene's valid count."""
    n_valid = mask.sum(1, keepdim=True)
    return torch.arange(m, device=mask.device)[None, :] < n_valid


def farthest_point_sampling_plain(
    coord: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor],  # (B, N) bool or None
    m: int,
    start_idx: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, N, _ = coord.shape
    dev = coord.device
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=dev)
    x, y, z = coord.detach().float().unbind(-1)
    rows = torch.arange(B, device=dev)
    min_d2 = torch.full((B, N), _BIG, dtype=torch.float32, device=dev)
    sel = torch.zeros((B, m), dtype=torch.int64, device=dev)
    if m > 0:
        sel[:, 0] = start_idx
    last = torch.full((B,), start_idx, dtype=torch.int64, device=dev)
    for i in range(1, m):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        min_d2 = torch.minimum(min_d2, fma_chain(dx, dy, dz))
        last = torch.where(mask, min_d2, -_BIG).argmax(dim=1)
        sel[:, i] = last
    valid = _valid(mask, m)
    return torch.where(valid, sel, 0).to(torch.int32), valid


def farthest_point_sampling(
    coord: torch.Tensor,  # (B, N, 3)
    mask: Optional[torch.Tensor],  # (B, N) bool or None
    m: int,
    start_idx: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (idx (B, m) int32, valid (B, m) bool): ``m`` samples of each
    scene, the first ``start_idx``; ``valid`` is ``arange(m) < n_valid``
    and invalid slots hold index 0."""
    if coord.device.type == "cpu":
        return farthest_point_sampling_plain(coord, mask, m, start_idx)
    B, N, _ = coord.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=coord.device)
    if not 0 <= start_idx < N:
        raise ValueError(f"farthest_point_sampling: start_idx {start_idx} "
                         f"out of [0, {N})")
    planes = coord.detach().float().permute(2, 0, 1).contiguous()  # (3, B, N)
    mask_u8 = mask.to(torch.uint8).contiguous()
    _native.require_cuda("farthest_point_sampling", planes, mask_u8)
    scratch = torch.empty((B, N), dtype=torch.float32, device=coord.device)
    idx = torch.empty((B, m), dtype=torch.int32, device=coord.device)
    err = _native.lib().fps_launch(
        planes.data_ptr(), mask_u8.data_ptr(), scratch.data_ptr(),
        idx.data_ptr(), B, N, m, start_idx, _native.stream_ptr(planes))
    _native.check(err, "farthest_point_sampling")
    farthest_point_sampling.launches += 1
    return idx, _valid(mask, m)


farthest_point_sampling.launches = 0
