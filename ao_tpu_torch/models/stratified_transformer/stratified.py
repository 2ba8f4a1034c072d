"""Stratified Transformer ST-v1m1 / ST-v1m2 (port of
ao_tpu/models/stratified_transformer/stratified.py; reference: pointcept/
models/stratified_transformer/stratified_transformer_v1m1_origin.py).

* **KPConv embedding**: the exact 16-NN of every point (``ops/knn.py``),
  the linear correlation max(0, 1 - |rel - kp| / sigma) against 15 kernel
  points (:func:`_kernel_points`, the JAX package's Fibonacci-sphere
  layout) and one product with the (15, in_channels, C) kernel. The
  kernel is sized from ``in_channels``; features of another width raise
  (the JAX package sizes it from the features it is given).
* **Windows** come from ``ops/window_partition.py`` with the JAX
  package's capacities: ``num_windows = max(int(N / 4), 16)`` rows a scene
  and stage, 64 slots a window; odd blocks shift the windows by half a
  window. The **stratified keys** of a window row are its own points and
  the points of a ``grid_pool`` of the block's normalised features at a
  quarter of the window size, packed into the same number of rows at 16
  slots: keys 64 + 16. Row r of the coarse pack is the r-th occupied
  window of a grid anchored at the pooled points' own minimum, as in the
  JAX package, which need not be the fine pack's window r.
* **Attention** runs over the occupied rows of the fine pack only: rows
  fill in ascending window order, so the rows with a query are a prefix
  of each scene's, and the JAX package's other rows give 0 after the
  masked projection and are never read back. The row count is read back
  to the host once a block. The contextual relative-position bias
  (round(rel / quant_size) + 12, clipped to the 24 bins of each axis of a
  (3, 24, H) table, summed over the axes) is looked up at uint8 bins; the
  rows run in chunks of :data:`ATTN_CHUNK_ELEMENTS` pair scores through
  ``BiasedAttention``, which keeps q, k, v and the bins and recomputes the
  softmax in the backward: no (rows, heads, 64, 80) tensor outlives a
  chunk. The MLP keeps its hidden layer's input only (``GeluMlp``).

Every round or floor of a coordinate over a constant multiplies by the
float32 reciprocal, as XLA compiles the JAX package's division in a
jitted step. LayerNorms take flax's epsilon (1e-6), the MLP the exact
GELU. Module names are the flax ones (``kp_embed``, ``stage{s}_block{d}``
with ``norm1`` / ``attn`` (``q``, ``k``, ``v``, ``proj``, ``rpe_table``) /
``norm2`` / ``mlp``, ``down{s}``, ``up{s}``, ``up{s}_skip``; the
embedding's ``embed_norm``, the classifier's ``seg_fc`` / ``seg_norm`` /
``seg_out``); ``convert.py`` maps the auto-named ones. After a forward
``window_stats`` holds each block's (stage, block, occupied rows, rows,
points dropped beyond ``num_windows``, beyond the capacity, occupied
coarse rows, coarse points dropped beyond ``num_windows``, beyond the
coarse capacity) and ``pool_overflow`` the clusters beyond the stage
pools' capacities.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..builder import MODELS
from ..utils import BiasedAttention, DropPath, GeluMlp, table_bins
from ...ops import grid_pool, grouping, grouping_with_rel_coord, interpolation
from ...ops.knn import knn_query
from ...ops.window_partition import pack_windows, reciprocal, window_ids

LN_EPS = 1e-6  # flax nn.LayerNorm's default
RPE_BINS = 24  # of each axis of the position table
# the KPConv embedding's kernel points, their extent and its neighbours
KP_POINTS, KP_SIGMA, KP_NEIGHBOURS = 15, 0.1, 16
# (rows, heads, queries, keys) pair scores of one chunk of the attention
ATTN_CHUNK_ELEMENTS = 2**27


def _kernel_points(num: int = 15) -> np.ndarray:
    """Deterministic quasi-uniform kernel points on the unit ball: a centre
    point and a Fibonacci-sphere layout at radius 0.7 (the JAX package's,
    bit for bit)."""
    pts = [np.zeros(3)]
    n = num - 1
    phi = (1 + 5**0.5) / 2
    for i in range(n):
        z = 1 - 2 * (i + 0.5) / n
        r = np.sqrt(max(0.0, 1 - z * z))
        theta = 2 * np.pi * i / phi
        pts.append(np.array([r * np.cos(theta), r * np.sin(theta), z]) * 0.7)
    return np.asarray(pts, np.float32)


def _lecun_normal(shape, fan_in):
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=fan_in ** -0.5, a=-2 * fan_in ** -0.5,
                          b=2 * fan_in ** -0.5)
    return nn.Parameter(w)


class KPConvEmbed(nn.Module):
    """Kernel-point convolution over the exact kNN neighbourhood of every
    point (the reference's KPConv embedding)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.kernel = _lecun_normal((KP_POINTS, in_channels, out_channels),
                                    KP_POINTS * in_channels)
        self.register_buffer("kernel_points", torch.from_numpy(
            _kernel_points(KP_POINTS) * KP_SIGMA), persistent=False)

    def forward(self, coord, feat, mask):
        idx, _, valid = knn_query(KP_NEIGHBOURS, coord, mask)
        rel = grouping_with_rel_coord(coord, coord, idx, valid)  # (B, N, k, 3)
        nf = grouping(feat, idx, valid)  # (B, N, k, C)
        with torch.no_grad():  # scene by scene: (N, k, P, 3) differences
            corr = []
            for b in range(coord.shape[0]):
                d = rel[b][:, :, None, :] - self.kernel_points
                d = torch.sqrt((d * d).sum(-1))
                corr.append(torch.clamp_min(1.0 - d * reciprocal(KP_SIGMA), 0.0))
            corr = torch.where(valid[..., None], torch.stack(corr), 0.0)
        B, N, _, P = corr.shape
        x = torch.einsum("bnkp,bnkc->bnpc", corr, nf).reshape(B, N, -1)
        out = x @ self.kernel.reshape(P * self.in_channels, -1)
        return torch.where(mask[..., None], out, 0.0)


class WindowAttention(nn.Module):
    """Attention of window rows over their keys: the rows' own points x (R,
    S, C) at ``xyz`` with their validity, and where given the ``coarse``
    keys (feat (R, Sc, C), xyz, valid) after them; the contextual
    relative-position bias from a (3, 24, H) table. The k / v projections
    of the rows' own points serve as their keys (the JAX package projects
    the concatenated keys: the same rows)."""

    def __init__(self, channels: int, num_heads: int, quant_size: float):
        super().__init__()
        self.num_heads, self.quant_size = num_heads, quant_size
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)
        t = torch.empty(3, RPE_BINS, num_heads)
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)
        self.rpe_table = nn.Parameter(t)

    @torch.no_grad()
    def bins(self, q_xyz, k_xyz):
        """(R, Sq, Sk, 3) table bins of every (query, key) pair:
        clip(round(rel / quant_size) + bins // 2, 0, bins - 1) of
        rel = q_xyz - k_xyz, each axis offset into its own table rows."""
        rel = q_xyz[:, :, None, :] - k_xyz[:, None, :, :]
        n = RPE_BINS
        b = torch.round(rel * reciprocal(self.quant_size)).to(torch.int32)
        return table_bins(torch.clamp(b + n // 2, 0, n - 1), n)

    def forward(self, x, xyz, valid, coarse=None):
        R, S, C = x.shape
        H = self.num_heads
        k, v, k_xyz, k_valid = self.k(x), self.v(x), xyz, valid
        if coarse is not None:
            c_feat, c_xyz, c_valid = coarse
            k = torch.cat([k, self.k(c_feat)], 1)
            v = torch.cat([v, self.v(c_feat)], 1)
            k_xyz = torch.cat([xyz, c_xyz], 1)
            k_valid = torch.cat([valid, c_valid], 1)

        def heads(t):  # (R, S, C) -> (R, H, S, C / H)
            return t.reshape(R, t.shape[1], H, -1).transpose(1, 2).contiguous()

        q, k, v = heads(self.q(x)), heads(k), heads(v)
        table = self.rpe_table.reshape(-1, H)
        rows = max(ATTN_CHUNK_ELEMENTS // (H * S * k.shape[2]), 1)
        outs = [BiasedAttention.apply(
            q[r:r + rows], k[r:r + rows], v[r:r + rows],
            self.bins(xyz[r:r + rows], k_xyz[r:r + rows]), k_valid[r:r + rows],
            table, q.shape[-1] ** -0.5) for r in range(0, R, rows)]
        out = torch.cat(outs) if outs else q.new_zeros((0, H, S, C // H))
        out = self.proj(out.transpose(1, 2).reshape(R, S, C))
        return torch.where(valid[..., None], out, 0.0)


def _rows(x, idx, valid, rows, base):
    """The occupied rows of a pack: x (B, M, C) at the pack's point_idx
    (B, W, S) + ``base`` of each scene, rows ``rows`` of the B x W, invalid
    slots 0."""
    B, W, S = idx.shape
    src = (idx + base).reshape(B * W, S).index_select(0, rows).reshape(-1)
    out = x.reshape(-1, x.shape[-1]).index_select(0, src)
    out = out.reshape(len(rows), S, -1)
    return torch.where(valid[..., None], out, 0.0)


class STBlock(nn.Module):
    """LN -> window attention over the stratified keys -> residual, LN ->
    MLP(4x, exact GELU) -> residual; points dropped from the windows keep
    their residual."""

    def __init__(self, channels: int, num_heads: int, window_size: float,
                 quant_size: float, shift: bool = False,
                 stratified_grid: float = 0.0, window_capacity: int = 64,
                 coarse_capacity: int = 16, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.stratified_grid = stratified_grid
        self.window_capacity, self.coarse_capacity = window_capacity, coarse_capacity
        self.norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.attn = WindowAttention(channels, num_heads, quant_size)
        self.norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.mlp = GeluMlp(channels, 4 * channels)
        self.drop_path = DropPath(drop_path)
        self.window_stats = None

    def forward(self, coord, feat, mask, num_windows: int):
        B, N, C = feat.shape
        W, S = num_windows, self.window_capacity
        dev = feat.device
        h = self.norm1(feat)
        wid = window_ids(coord, mask, self.window_size, self.shift)
        (pidx, pvalid, win, slot), dropped = pack_windows(wid, W, S)
        occupied = pvalid[..., 0].reshape(-1)  # (B * W,)
        rows = occupied.nonzero().squeeze(1)  # reads the row count back
        R = rows.numel()
        base = torch.arange(B, device=dev)[:, None, None] * N
        valid = pvalid.reshape(B * W, S).index_select(0, rows)
        x = _rows(h, pidx, valid, rows, base)
        xyz = _rows(coord, pidx, valid, rows, base)
        keys, coarse = None, (0, 0, 0)
        if self.stratified_grid > 0:
            M = max(N // 4, 64)
            pc, pf, pm, _, _ = grid_pool(coord, h, mask, self.stratified_grid, M)
            cwid = window_ids(pc, pm, self.window_size, self.shift)
            (cidx, cvalid, _, _), cdropped = pack_windows(
                cwid, W, self.coarse_capacity)
            cv = cvalid.reshape(B * W, -1).index_select(0, rows)
            cbase = torch.arange(B, device=dev)[:, None, None] * M
            keys = (_rows(pf, cidx, cv, rows, cbase), _rows(pc, cidx, cv, rows, cbase),
                    cv)
            coarse = (cvalid[..., 0].sum(),) + cdropped
        out = self.attn(x, xyz, valid, keys)

        # back to the points through their (occupied row, slot); points in
        # dropped windows or slots read a zero row appended past the rest
        compact = torch.cumsum(occupied.to(torch.int64), 0) - 1
        row = torch.arange(B, device=dev)[:, None] * W + win.clamp_min(0)
        at = torch.where(win >= 0, compact[row] * S + slot, R * S)
        out = torch.cat([out.reshape(R * S, C), out.new_zeros((1, C))])
        h_attn = out.index_select(0, at.reshape(-1)).reshape(B, N, C)
        h_attn = torch.where(mask[..., None], h_attn, 0.0)

        feat = feat + self.drop_path(h_attn)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)))
        self.window_stats = (R, B * W) + dropped + coarse
        return torch.where(mask[..., None], feat, 0.0)


@MODELS.register_module("ST-v1m2")
class StratifiedTransformer(nn.Module):
    """The Stratified Transformer U-Net: KPConv embedding, stages of
    ``STBlock`` joined by grid pooling through ``down{s}``, 3-NN
    interpolation decoder (``up{s}`` + ``up{s}_skip``), and a Linear ->
    LN -> ReLU -> Linear classifier. ``kp_embed_channels`` is taken and
    unused, as in the JAX package (the embedding gives ``channels[0]``)."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        channels: Sequence[int] = (48, 96, 192, 384),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        depths: Sequence[int] = (2, 2, 6, 2),
        window_sizes: Sequence[float] = (0.4, 0.8, 1.6, 3.2),
        quant_sizes: Sequence[float] = (0.01, 0.02, 0.04, 0.08),
        grid_sizes: Sequence[float] = (0.1, 0.2, 0.4),
        stratified: bool = True,
        window_capacity: int = 64,
        num_windows_ratio: float = 0.25,
        kp_embed_channels: int = 48,
        drop_path_rate: float = 0.3,
        stage_cap_ratios: Sequence[float] = (0.35, 0.35, 0.35),
    ):
        super().__init__()
        self.in_channels, self.num_classes = in_channels, num_classes
        self.channels, self.depths = tuple(channels), tuple(depths)
        self.grid_sizes = tuple(grid_sizes)
        self.num_windows_ratio = num_windows_ratio
        self.stage_cap_ratios = tuple(stage_cap_ratios)
        self.pool_overflow = None
        self.window_stats = None
        self.kp_embed = KPConvEmbed(in_channels, self.channels[0])
        self.embed_norm = nn.LayerNorm(self.channels[0], eps=LN_EPS)
        dp = np.linspace(0, drop_path_rate, sum(self.depths))
        bi = 0
        for s, depth in enumerate(self.depths):
            if s > 0:
                setattr(self, f"down{s}", nn.Linear(self.channels[s - 1],
                                                    self.channels[s]))
            for d in range(depth):
                setattr(self, f"stage{s}_block{d}", STBlock(
                    self.channels[s], num_heads[s], window_sizes[s],
                    quant_sizes[s], shift=d % 2 == 1,
                    stratified_grid=window_sizes[s] / 4 if stratified else 0.0,
                    window_capacity=window_capacity, drop_path=float(dp[bi])))
                bi += 1
        for s in range(len(self.depths) - 1):
            setattr(self, f"up{s}", nn.Linear(self.channels[s + 1], self.channels[s]))
            setattr(self, f"up{s}_skip", nn.Linear(self.channels[s], self.channels[s]))
        if num_classes > 0:
            c0 = self.channels[0]
            self.seg_fc = nn.Linear(c0, c0)
            self.seg_norm = nn.LayerNorm(c0, eps=LN_EPS)
            self.seg_out = nn.Linear(c0, num_classes)

    def stage_capacities(self, n: int):
        """The padded point count of each stage: n, then max(int(cap *
        ratio), 64) of the stage before."""
        caps = [n]
        for r in self.stage_cap_ratios[:len(self.depths) - 1]:
            caps.append(max(int(caps[-1] * r), 64))
        return caps

    def forward(self, coord, feat, mask):
        if feat.shape[-1] != self.in_channels:
            raise ValueError(
                f"the features have {feat.shape[-1]} channels, but "
                f"model.backbone.in_channels={self.in_channels} sizes the KPConv "
                f"embedding's kernel for {self.in_channels}: set "
                f"model.backbone.in_channels={feat.shape[-1]}")
        h = self.embed_norm(self.kp_embed(coord, feat, mask))
        skips, stats = [], []
        overflow = torch.zeros((), dtype=torch.int64, device=coord.device)
        caps = self.stage_capacities(coord.shape[1])
        for s, depth in enumerate(self.depths):
            if s > 0:
                pc, pf, pm, _, n_clusters = grid_pool(
                    coord, getattr(self, f"down{s}")(h), mask,
                    self.grid_sizes[s - 1], caps[s])
                overflow = overflow + torch.clamp_min(n_clusters - caps[s], 0).sum()
                skips.append((coord, h, mask))
                coord, h, mask = pc, pf, pm
            num_windows = max(int(coord.shape[1] * self.num_windows_ratio), 16)
            for d in range(depth):
                block = getattr(self, f"stage{s}_block{d}")
                h = block(coord, h, mask, num_windows)
                stats.append((s, d) + block.window_stats)

        for s in reversed(range(len(self.depths) - 1)):
            skip_coord, skip_feat, skip_mask = skips[s]
            up = interpolation(coord, skip_coord, h, mask, skip_mask, k=3)
            h = getattr(self, f"up{s}")(up) + getattr(self, f"up{s}_skip")(skip_feat)
            coord, mask = skip_coord, skip_mask
        self.pool_overflow, self.window_stats = overflow, stats

        if self.num_classes > 0:
            return self.seg_out(torch.relu(self.seg_norm(self.seg_fc(h))))
        return torch.where(mask[..., None], h, 0.0)


def _st_v1m1(**kwargs):
    """ST-v1m1: the same architecture, KPConv embedding and stratified keys
    on."""
    kwargs.setdefault("stratified", True)
    return StratifiedTransformer(**kwargs)


MODELS.register_module(name="ST-v1m1", module=_st_v1m1)
