"""Sparse (submanifold) convolution on fixed-shape voxel sets (port of
ao_tpu/ops/sparse_conv.py).

Voxel sets are dense padded ``(B, M, 3)`` integer coordinates with a bool
mask, as in the JAX package:

* a scene's "hash table" is its linearised voxel keys sorted ascending; a
  lookup is ``torch.searchsorted`` (``side="left"``, as ``jnp.searchsorted``)
  plus an equality check;
* ``neighbor_idx`` gives each output site's (K,) input rows and validity;
* ``sparse_conv_apply`` contracts the gathered rows with a (K, C_in, C_out)
  kernel. It is a ``torch.autograd.Function`` that loops over the K offsets
  and recomputes each gather in the backward, so that no (B, Mo, K, C_in)
  tensor is kept: at ScanNet's B=12 x 102400 the JAX package's
  gather-then-einsum (``sparse_conv_apply_plain``, the reference that tests
  hold it against) would keep about 55 GB for one full-resolution stage;
* ``sparse_downsample`` derives the stride-2 sites, capacity-bounded.

Keys are int64, so no extent overflows (a SemanticKITTI scan at 0.05 m
spans about 3200 x 3200 x 400 cells, more than int32 holds); wherever the
JAX package's int32 keys do not overflow they are the same numbers. Its
sentinels, INT_MAX for padding rows (they sort last) and INT_MAX - 1 for
out-of-range probes (they never match), are the int64 maximum and one less
here, so that they stay above every key. Every sort is stable, as
``jnp.argsort``: duplicated coordinates (two scenes merged by Mix3D) resolve
to the same row as in the JAX package.

None of this is a TPU kernel: the JAX package computes it in XLA outside
Pallas, and the port computes it with PyTorch's gathers, ``mm`` and
``index_add_``.
"""

from __future__ import annotations

import itertools
import torch

_KEY_MAX = torch.iinfo(torch.int64).max  # padding rows: sorts last
_KEY_OUT = _KEY_MAX - 1  # out-of-range probes: matches no key


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """(K, 3) int64 offsets, centred for odd kernels, in [0, k) for even."""
    if kernel_size % 2 == 1:
        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        r = range(kernel_size)
    return torch.tensor(list(itertools.product(r, r, r)), dtype=torch.int64,
                        device=device)


def _linearize(dc: torch.Tensor, extent: torch.Tensor) -> torch.Tensor:
    """dc (B, M, 3) -> int64 keys (B, M); the caller keeps 0 <= dc < extent."""
    dc = dc.to(torch.int64)
    ext = extent.to(torch.int64)
    return (dc[..., 0] * ext[:, None, 1] + dc[..., 1]) * ext[:, None, 2] + dc[..., 2]


def build_table(dc: torch.Tensor, mask: torch.Tensor):
    """Sorted voxel-key table for lookups: (keys_sorted (B, M) int64, order
    (B, M), extent (B, 3)). Padding rows sort last."""
    dcc = torch.where(mask[..., None], dc, 0).to(torch.int64)
    extent = dcc.amax(dim=1) + 1
    keys = torch.where(mask, _linearize(dcc, extent), _KEY_MAX)
    keys_sorted, order = torch.sort(keys, dim=1, stable=True)
    return keys_sorted, order, extent


def lookup(keys_sorted, order, query_dc, extent):
    """Find each query coordinate (B, Q, 3), which may lie out of range, in
    the table. Returns (idx (B, Q) int64 into the table's original row
    order, 0 where not found; found (B, Q) bool)."""
    in_range = ((query_dc >= 0) & (query_dc < extent[:, None, :])).all(-1)
    q = _linearize(torch.where(in_range[..., None], query_dc, 0), extent)
    q = torch.where(in_range, q, _KEY_OUT)
    pos = torch.searchsorted(keys_sorted, q, side="left")
    pos = torch.clamp_max(pos, keys_sorted.shape[1] - 1)
    found = (torch.gather(keys_sorted, 1, pos) == q) & in_range
    idx = torch.gather(order, 1, pos)
    return torch.where(found, idx, 0), found


def neighbor_idx(table, out_dc, out_mask, offsets, stride: int = 1):
    """(B, Mo, K) input rows and validity of each output site (B, Mo, 3) x
    offset (K, 3): the input site at ``out_dc * stride + offset``."""
    keys_sorted, order, extent = table
    B, Mo, _ = out_dc.shape
    K = offsets.shape[0]
    probe = out_dc.to(torch.int64)[:, :, None, :] * stride + offsets
    idx, found = lookup(keys_sorted, order, probe.reshape(B, Mo * K, 3), extent)
    return idx.reshape(B, Mo, K), found.reshape(B, Mo, K) & out_mask[:, :, None]


@torch.no_grad()
def sparse_downsample(dc: torch.Tensor, mask: torch.Tensor, max_out: int):
    """Stride-2 sites: the unique ``dc // 2`` of each scene in ascending key
    order, at most ``max_out`` of them; the clusters beyond capacity merge
    into row ``max_out - 1`` (its coordinate the component-wise minimum of
    theirs). Returns (out_dc (B, max_out, 3) of dc's dtype, out_mask
    (B, max_out), parent (B, M) int64 row of each fine site, padding rows
    at ``max_out - 1``; overflow, the clusters beyond capacity summed over
    the batch as an int64 device tensor)."""
    B, M, _ = dc.shape
    coarse = torch.where(mask[..., None], torch.div(dc, 2, rounding_mode="floor"),
                         0).to(torch.int64)
    extent = coarse.amax(dim=1) + 1
    key = torch.where(mask, _linearize(coarse, extent), _KEY_MAX)
    key_sorted, order = torch.sort(key, dim=1, stable=True)
    mask_sorted = torch.gather(mask, 1, order)
    new = torch.ones_like(mask_sorted)
    new[:, 1:] = key_sorted[:, 1:] != key_sorted[:, :-1]
    new &= mask_sorted
    cid_sorted = torch.cumsum(new.to(torch.int64), dim=1) - 1
    overflow = torch.clamp_min(new.sum(dim=1) - max_out, 0).sum()
    parent = torch.empty_like(cid_sorted).scatter_(1, order, cid_sorted)
    parent = torch.where(mask, torch.clamp_max(parent, max_out - 1), max_out - 1)

    # segment max_out of each scene collects the padding rows; dropped
    seg = torch.where(mask_sorted, torch.clamp_max(cid_sorted, max_out - 1),
                      max_out)
    seg = (seg + torch.arange(B, device=dc.device)[:, None] * (max_out + 1)
           ).reshape(-1)
    coarse_sorted = torch.gather(coarse, 1, order[..., None].expand(-1, -1, 3))
    out_dc = torch.full((B * (max_out + 1), 3), _KEY_MAX, dtype=torch.int64,
                        device=dc.device)
    out_dc.scatter_reduce_(0, seg[:, None].expand(-1, 3),
                           coarse_sorted.reshape(-1, 3), reduce="amin")
    counts = torch.zeros(B * (max_out + 1), dtype=torch.int64, device=dc.device)
    counts.index_add_(0, seg, mask_sorted.reshape(-1).to(torch.int64))
    out_mask = counts.reshape(B, max_out + 1)[:, :max_out] > 0
    out_dc = out_dc.reshape(B, max_out + 1, 3)[:, :max_out]
    out_dc = torch.where(out_mask[..., None], out_dc, 0).to(dc.dtype)
    return out_dc, out_mask, parent, overflow


def _gather_rows(feat: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    """(x, rows): feat flattened to (B * M, C_in) with one zero row appended,
    and each output site's (K,) rows of x, invalid slots at the zero row."""
    B, M, C_in = feat.shape
    x = torch.cat([feat.reshape(B * M, C_in), feat.new_zeros((1, C_in))])
    offs = torch.arange(B, device=idx.device, dtype=torch.int64) * M
    rows = torch.where(valid, idx.to(torch.int64) + offs[:, None, None], B * M)
    return x, rows.reshape(-1, idx.shape[-1])


class _SparseConv(torch.autograd.Function):
    """Gather-multiply-accumulate over the K offsets; the backward recomputes
    each offset's gather. Saves only feat, idx, valid and the kernel."""

    @staticmethod
    def forward(ctx, feat, idx, valid, kernel):
        x, rows = _gather_rows(feat, idx, valid)
        out = feat.new_zeros((rows.shape[0], kernel.shape[-1]))
        for k in range(rows.shape[1]):
            out.addmm_(x.index_select(0, rows[:, k]), kernel[k])
        ctx.save_for_backward(feat, idx, valid, kernel)
        return out.reshape(idx.shape[0], idx.shape[1], -1)

    @staticmethod
    def backward(ctx, dout):
        feat, idx, valid, kernel = ctx.saved_tensors
        x, rows = _gather_rows(feat, idx, valid)
        dy = dout.reshape(rows.shape[0], -1)
        dfeat = dkernel = None
        if ctx.needs_input_grad[0]:
            # each invalid slot adds into a spill row of its own past x's
            # rows: sent to the shared zero row, their atomic adds would
            # all queue on that one row
            n = x.shape[0]
            spill = torch.arange(n, n + rows.shape[0], device=rows.device)
            to = torch.where(rows < n - 1, rows, spill[:, None])
            dx = x.new_zeros((n + rows.shape[0], x.shape[1]))
            for k in range(rows.shape[1]):
                dx.index_add_(0, to[:, k], dy @ kernel[k].T)
            dfeat = dx[:n - 1].reshape(feat.shape)
        if ctx.needs_input_grad[3]:
            dkernel = torch.stack([x.index_select(0, rows[:, k]).T @ dy
                                   for k in range(rows.shape[1])])
        return dfeat, None, None, dkernel


def sparse_conv_apply(feat: torch.Tensor, idx: torch.Tensor,
                      valid: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Sparse convolution: out[b, m] = sum_k valid[b, m, k] *
    feat[b, idx[b, m, k]] @ kernel[k]. feat (B, M, C_in), idx / valid
    (B, Mo, K), kernel (K, C_in, C_out) -> (B, Mo, C_out)."""
    return _SparseConv.apply(feat, idx, valid, kernel)


def sparse_conv_apply_plain(feat, idx, valid, kernel):
    """The JAX package's form of :func:`sparse_conv_apply`: gather all K rows
    (B, Mo, K, C_in), zero the invalid ones, one einsum; differentiated by
    autograd. The reference the tests and the card's check hold the
    Function against; no model calls it."""
    B, Mo, K = idx.shape
    g = torch.gather(feat, 1, idx.reshape(B, Mo * K, 1).to(torch.int64).expand(
        -1, -1, feat.shape[-1])).reshape(B, Mo, K, -1)
    g = torch.where(valid[..., None], g, 0.0)
    return torch.einsum("bmkc,kcd->bmd", g, kernel)
