"""OctFormer-v1m1: octree attention over Morton-sorted groups (port of
ao_tpu/models/octformer/octformer.py; reference: pointcept/models/
octformer/octformer_v1m1_base.py).

* **Order**: each stage's points are sorted by their 30-bit Morton code
  (``ops/knn_spatial.morton_code``) with a stable sort, as ``jnp.argsort``
  is stable: codes tie often, and the order inside a tie decides the
  groups.
* **Octree attention**: the sorted points, padded to a multiple of
  ``patch_size x dilation``, attend within contiguous groups of
  ``patch_size`` (every ``dilation``-th point on odd blocks:
  :func:`_dilate_order`), dense (G, heads, K, K) products in plain
  PyTorch. The relative-position bias looks up a (3 x (2 b + 1), H) table
  at the clipped cell offsets of the pair, b = int(0.8 K sqrt(dilation)),
  summed over the axes; cells are floor(coord / rpe_grid), by the float32
  reciprocal as XLA compiles the JAX package's division. The softmax is
  recomputed in the backward (``BiasedAttention``), and the MLP keeps its
  hidden layer's input only (``GeluMlp``).
* **CPE**: a kNN (k = 8) depthwise-style convolution of the relative
  positions plus the neighbours' mean. The JAX package queries the kNN in
  every block on the stage's unchanged points; the port queries it once
  a stage and hands it to the stage's blocks (the same indices).
* **Output order**: the logits come back in the input's point order. The
  JAX package returns them in the first stage's Morton order, which its
  loss then scores against labels in the input order; the port undoes
  the sort.

LayerNorms take flax's epsilon (1e-6), the MLP the exact GELU. Module
names are the flax ones (``embed``, ``stage{s}_block{d}`` with
``cpe_kernel`` / ``norm1`` / ``attn`` (``qkv``, ``proj``, ``rpe_table``) /
``norm2`` / ``mlp``, ``down{s}``, ``up{s}``, ``up{s}_skip``; the
classifier's ``seg_norm`` / ``seg_out``); ``convert.py`` maps the
auto-named ones. After a forward ``pool_overflow`` holds the clusters
beyond the stage pools' capacities.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..builder import MODELS
from ..utils import BiasedAttention, DropPath, GeluMlp, table_bins
from ...ops import grid_pool, grouping, grouping_with_rel_coord, interpolation
from ...ops.knn import knn_query
from ...ops.knn_spatial import morton_code
from ...ops.window_partition import reciprocal

LN_EPS = 1e-6  # flax nn.LayerNorm's default
CPE_NEIGHBOURS = 8


def _dilate_order(N: int, dilation: int) -> np.ndarray:
    """Interleave a length-N sequence with the given stride so that each
    contiguous group holds every ``dilation``-th point (the identity where
    ``dilation`` does not divide N)."""
    return (
        np.arange(N).reshape(-1, dilation).T.reshape(-1)
        if N % dilation == 0
        else np.arange(N)
    )


@functools.lru_cache(maxsize=None)
def _orders(N: int, dilation: int):
    """(order, its inverse) of :func:`_dilate_order`, as int64 numpy."""
    order = _dilate_order(N, dilation)
    return order, np.argsort(order)


class OctreeAttention(nn.Module):
    """Attention within groups of ``patch_size`` points of a Morton-sorted
    (B, N, C) sequence, dilated by ``dilation``, with the relative-position
    bias of the points' (B, N, 3) integer cells (the JAX package's
    ``use_rpe``, on in every block)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int = 32,
                 dilation: int = 1):
        super().__init__()
        self.num_heads, self.patch_size, self.dilation = num_heads, patch_size, dilation
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj = nn.Linear(channels, channels)
        self.pos_bnd = int(0.8 * patch_size * dilation ** 0.5)
        self.rpe_num = 2 * self.pos_bnd + 1
        t = torch.empty(3 * self.rpe_num, num_heads)
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)
        self.rpe_table = nn.Parameter(t)

    @torch.no_grad()
    def bins(self, xg):
        """(R, K, K, 3) table bins of the pairs of (R, K, 3) grouped cells:
        clip(x_q - x_k, -b, b) + b, each axis offset into its own rows."""
        rel = xg[:, :, None, :] - xg[:, None, :, :]
        b = self.pos_bnd
        return table_bins(torch.clamp(rel, -b, b) + b, self.rpe_num)

    def forward(self, feat, mask, xyz):
        B, N, C = feat.shape
        K, H = self.patch_size, self.num_heads
        Np = -(-N // (K * self.dilation)) * (K * self.dilation)
        G = Np // K
        order, inv = (torch.from_numpy(a).to(feat.device)
                      for a in _orders(Np, self.dilation))
        f = nn.functional.pad(feat, (0, 0, 0, Np - N))[:, order]
        m = nn.functional.pad(mask, (0, Np - N))[:, order]
        x = nn.functional.pad(xyz, (0, 0, 0, Np - N))[:, order]
        qkv = self.qkv(f).reshape(B * G, K, 3, H, -1).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # (B G, H, K, hd)
        # a group of padding only has no valid key: it takes the pad rows'
        # keys, whose outputs are cut or masked below
        out = BiasedAttention.apply(
            q, k, v, self.bins(x.reshape(B * G, K, 3)),
            m.reshape(B * G, K) | ~m.reshape(B * G, K).any(1, keepdim=True),
            self.rpe_table, q.shape[-1] ** -0.5)
        out = self.proj(out.transpose(1, 2).reshape(B, Np, C))
        out = out[:, inv][:, :N]
        return torch.where(mask[..., None], out, 0.0)


def cpe_graph(coord, mask):
    """(idx, valid) of the CPE's exact kNN: every point's 8 nearest points
    of its stage, itself included."""
    idx, _, valid = knn_query(CPE_NEIGHBOURS, coord, mask)
    return idx, valid


class OctFormerBlock(nn.Module):
    """CPE -> LN -> octree attention -> residual, LN -> MLP(4x, exact GELU)
    -> residual; cells for the position bias at ``rpe_grid``."""

    def __init__(self, channels: int, num_heads: int, patch_size: int = 32,
                 dilation: int = 1, drop_path: float = 0.0,
                 rpe_grid: float = 0.04):
        super().__init__()
        self.rpe_grid = rpe_grid
        w = torch.empty(CPE_NEIGHBOURS, 3, channels)
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04)
        self.cpe_kernel = nn.Parameter(w)
        self.norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.attn = OctreeAttention(channels, num_heads, patch_size, dilation)
        self.norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.mlp = GeluMlp(channels, 4 * channels)
        self.drop_path = DropPath(drop_path)

    def forward(self, coord, feat, mask, graph=None):
        """``graph``: the stage's (idx, valid) of :func:`cpe_graph`, queried
        here where None."""
        B, N, C = feat.shape
        idx, valid = cpe_graph(coord, mask) if graph is None else graph
        rel = grouping_with_rel_coord(coord, coord, idx, valid)  # (B, N, 8, 3)
        cpe = rel.reshape(B, N, -1) @ self.cpe_kernel.reshape(-1, C)
        # the neighbours' mean, a slot at a time (no (B, N, 8, C) tensor)
        acc = grouping(feat, idx[..., :1], valid[..., :1])[:, :, 0]
        for j in range(1, idx.shape[-1]):
            acc = acc + grouping(feat, idx[..., j:j + 1], valid[..., j:j + 1])[:, :, 0]
        cpe = cpe + acc / idx.shape[-1]
        feat = feat + torch.where(mask[..., None], cpe, 0.0)

        xyz = torch.floor(coord * reciprocal(self.rpe_grid)).to(torch.int32)
        feat = feat + self.drop_path(self.attn(self.norm1(feat), mask, xyz))
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)))
        return torch.where(mask[..., None], feat, 0.0)


def sort_stage(coord, feat, mask):
    """The stage's points in the stable order of their Morton codes, and
    that order (B, N)."""
    order = torch.argsort(morton_code(coord, mask), dim=1, stable=True)

    def take(x):
        return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[2])
                            if x.dim() == 3 else order)

    return take(coord), take(feat), take(mask), order


@MODELS.register_module("OctFormer-v1m1")
class OctFormer(nn.Module):
    """The OctFormer U-Net: Linear embedding, stages of ``OctFormerBlock``
    on Morton-sorted points joined by grid pooling through ``down{s}``,
    3-NN interpolation decoder (``up{s}`` + ``up{s}_skip``), and an LN ->
    Linear classifier."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        channels: Sequence[int] = (96, 192, 384, 384),
        num_heads: Sequence[int] = (6, 12, 24, 24),
        depths: Sequence[int] = (2, 2, 18, 2),
        patch_size: int = 32,
        dilation: int = 4,
        grid_sizes: Sequence[float] = (0.08, 0.16, 0.32),
        drop_path_rate: float = 0.5,
        stage_cap_ratios: Sequence[float] = (0.35, 0.35, 0.35),
    ):
        super().__init__()
        self.num_classes = num_classes
        self.channels, self.depths = tuple(channels), tuple(depths)
        self.grid_sizes = tuple(grid_sizes)
        self.stage_cap_ratios = tuple(stage_cap_ratios)
        self.pool_overflow = None
        self.embed = nn.Linear(in_channels, self.channels[0])
        dp = np.linspace(0, drop_path_rate, sum(self.depths))
        bi = 0
        for s, depth in enumerate(self.depths):
            if s > 0:
                setattr(self, f"down{s}", nn.Linear(self.channels[s - 1],
                                                    self.channels[s]))
            for d in range(depth):
                setattr(self, f"stage{s}_block{d}", OctFormerBlock(
                    self.channels[s], num_heads[s], patch_size,
                    dilation=1 if d % 2 == 0 else dilation,
                    drop_path=float(dp[bi]),
                    rpe_grid=self.grid_sizes[s - 1] if s > 0 else self.grid_sizes[0] / 2))
                bi += 1
        for s in range(len(self.depths) - 1):
            setattr(self, f"up{s}", nn.Linear(self.channels[s + 1], self.channels[s]))
            setattr(self, f"up{s}_skip", nn.Linear(self.channels[s], self.channels[s]))
        if num_classes > 0:
            self.seg_norm = nn.LayerNorm(self.channels[0], eps=LN_EPS)
            self.seg_out = nn.Linear(self.channels[0], num_classes)

    def stage_capacities(self, n: int):
        """The padded point count of each stage: n, then max(int(cap *
        ratio), 64) of the stage before."""
        caps = [n]
        for r in self.stage_cap_ratios[:len(self.depths) - 1]:
            caps.append(max(int(caps[-1] * r), 64))
        return caps

    def forward(self, coord, feat, mask):
        coord, h, mask, order = sort_stage(coord, self.embed(feat), mask)
        skips = []
        overflow = torch.zeros((), dtype=torch.int64, device=coord.device)
        caps = self.stage_capacities(coord.shape[1])
        for s, depth in enumerate(self.depths):
            if s > 0:
                pc, pf, pm, _, n_clusters = grid_pool(
                    coord, getattr(self, f"down{s}")(h), mask,
                    self.grid_sizes[s - 1], caps[s])
                overflow = overflow + torch.clamp_min(n_clusters - caps[s], 0).sum()
                skips.append((coord, h, mask))
                coord, h, mask, _ = sort_stage(pc, pf, pm)
            graph = cpe_graph(coord, mask)
            for d in range(depth):
                h = getattr(self, f"stage{s}_block{d}")(coord, h, mask, graph)

        for s in reversed(range(len(self.depths) - 1)):
            skip_coord, skip_feat, skip_mask = skips[s]
            up = interpolation(coord, skip_coord, h, mask, skip_mask, k=3)
            h = getattr(self, f"up{s}")(up) + getattr(self, f"up{s}_skip")(skip_feat)
            coord, mask = skip_coord, skip_mask
        self.pool_overflow = overflow

        if self.num_classes > 0:
            h = self.seg_out(self.seg_norm(h))
        # back to the input's point order
        inv = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
        return torch.gather(h, 1, inv[..., None].expand(-1, -1, h.shape[2]))
