"""Swin3D-v1m1: shifted-window transformer on sparse voxels with cRSE (port
of ao_tpu/models/swin3d/swin3d.py; reference: pointcept/models/swin3d/
swin3d_v1m1_base.py and swin3d_layers.py).

* **cRSE** (contextual relative signal embedding): every (query, key) pair
  of a window looks up learned per-head tables at the quantised relative
  xyz / colour / normal signal of the pair; q . Tq[bin] and k . Tk[bin]
  join the logits, and the attention mass of each bin weights Tv[bin]
  into the output. The q- and k-side products are taken for every bin
  and gathered per pair; the value side adds the attention into per-bin
  sums (``scatter_add_``) and contracts them with Tv, as the JAX package's
  one-hot histogram does without its (W, S, S, L) one-hot.
* **Windows** come from ``ops/window_partition.py`` with the JAX package's
  capacities (``num_windows`` rows a scene, ``window_capacity`` slots a
  window; the points beyond them skip attention). Attention runs over the
  window rows that hold points only: a row with no valid slot gives 0
  after the masked projection, and no point reads it back, so skipping it
  changes no output (the row count is read back to the host once a
  block). The rows run in chunks of :data:`ATTN_CHUNK_ELEMENTS` pair
  scores, and the pair terms are autograd Functions that keep only their
  inputs and the (rows, S, S, 3 modes) uint8 bins for the backward, so a
  block keeps one (rows, heads, S, S) tensor, the softmax's.
* GridKNNDownsample: stride-2 voxel pooling for positions, the signals'
  per-voxel mean, and the max over Linear(LN(feat)) of the 16 nearest
  points of the level before (the exact kNN, ``ops/knn.py``).
* Upsample: linear1(LN(skip)) plus the 3-NN interpolation of
  linear2(LN(coarse)) (on the card above 2M pairs: K1 and K2).
* Stem: the 3^3 submanifold sparse convolution on the sites
  ``floor((coord - min) / base_grid_size)`` (``ops/sparse_conv.py``).

LayerNorms take flax's epsilon (1e-6), the MLP flax's tanh GELU. Every
floor of a coordinate over a constant (window ids, the stem's sites, the
xyz signal) multiplies by the float32 reciprocal, as XLA compiles the
JAX package's division. Module names are the flax ones (``stem_kernel``,
``stem_bn``, ``stage{s}_block{d}`` with ``norm1`` / ``attn`` (``qkv``,
``proj``, ``{mode}_{q,k,v}_table``) / ``norm2`` / ``mlp``,
``down{s}_*``, ``up{s}_*``; the classifier ``seg_fc`` / ``seg_bn`` /
``seg_out``); ``convert.py`` maps the auto-named ones. After a forward
``window_stats`` holds each block's (stage, block, occupied rows, rows,
points dropped beyond ``num_windows``, points dropped beyond the
capacity) and ``pool_overflow`` the clusters beyond the grid pools'
capacities.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..builder import MODELS
from ..utils import DropPath, PointBatchNorm
from ...ops import grid_pool, grouping, interpolation, knn
from ...ops.sparse_conv import build_table, kernel_offsets, neighbor_idx, \
    sparse_conv_apply
from ...ops.window_partition import pack_windows, reciprocal, window_ids

LN_EPS = 1e-6  # flax nn.LayerNorm's default
_BIG = 1e30
# (rows, heads, S, S) pair scores of one chunk of the window attention
ATTN_CHUNK_ELEMENTS = 2**27


def _segment_mean(values, cluster, mask, num_segments):
    """Per-cluster mean (B, M, C) of (B, N, C) values under a (B, N) cluster
    map; invalid points go to a dropped bucket M of each scene."""
    B, N, C = values.shape
    M = num_segments
    seg = (torch.where(mask, cluster, M)
           + torch.arange(B, device=values.device)[:, None] * (M + 1)).reshape(-1)
    s = values.new_zeros((B * (M + 1), C)).index_add_(
        0, seg, torch.where(mask[..., None], values, 0.0).reshape(-1, C))
    n = values.new_zeros(B * (M + 1)).index_add_(
        0, seg, mask.reshape(-1).to(values.dtype))
    s = s.reshape(B, M + 1, C)[:, :M]
    n = n.reshape(B, M + 1)[:, :M]
    return s / torch.clamp_min(n[..., None], 1.0)


def mode_params(mode: str, window_size: int, quant_size: int) -> Tuple[int, float]:
    """(table length L, index scale) of a signal mode: xyz spans the window
    in voxel units, colour and normal [-1, 1]."""
    if mode == "xyz":
        return 2 * window_size * quant_size, float(quant_size)
    return 2 * 2 * (2 * quant_size), float(2 * quant_size)


def _expand_bins(b, H):
    """(R, S, S) int64 bins as an (R, H, S, S) view."""
    R, S, _ = b.shape
    return b[:, None].expand(R, H, S, S)


def _table_grad(g, x):
    """sum over rows r and slots a of g[r, h, a, l] x[r, h, a, d], as a
    table (L, H, D): one small product a (row, head), then the sum over
    the rows (a single product over all rows and slots would give the GPU
    only H output tiles to work on)."""
    R, H, S, L = g.shape
    out = torch.bmm(g.reshape(R * H, S, L).transpose(1, 2),
                    x.reshape(R * H, S, x.shape[-1]))
    return out.view(R, H, L, -1).sum(0).transpose(0, 1)


class _PairBias(torch.autograd.Function):
    """Sum over the modes and axes of q[a] . Tq[bin(a, b)] + k[b] .
    Tk[bin(a, b)]: (R, H, S, S) from q, k (R, H, S, D), uint8 bins (R, S,
    S, 3 M) and tables (3, L, H, D), given as Tq, Tk of each mode in turn.
    The backward adds the logits' gradient into per-bin sums of each row
    (``scatter_add_``) and contracts them with the tables and with q / k."""

    @staticmethod
    def forward(ctx, bins, q, k, *tables):
        ctx.save_for_backward(bins, q, k, *tables)
        R, H, S, _ = q.shape
        bias = q.new_zeros((R, H, S, S))
        for j in range(len(tables) // 2):
            tq, tk = tables[2 * j], tables[2 * j + 1]
            for ax in range(3):
                b = bins[..., 3 * j + ax].long()
                sq = torch.einsum("rhad,lhd->rhal", q, tq[ax])
                bias += sq.gather(3, _expand_bins(b, H))
                sk = torch.einsum("rhbd,lhd->rhbl", k, tk[ax])
                bias += sk.gather(3, _expand_bins(b.transpose(1, 2), H)
                                  ).transpose(2, 3)
        return bias

    @staticmethod
    def backward(ctx, dbias):
        bins, q, k, *tables = ctx.saved_tensors
        R, H, S, _ = q.shape
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        dtables = []
        for j in range(len(tables) // 2):
            tq, tk = tables[2 * j], tables[2 * j + 1]
            dtq, dtk = torch.empty_like(tq), torch.empty_like(tk)
            L = tq.shape[1]
            for ax in range(3):
                b = bins[..., 3 * j + ax].long()
                dsq = q.new_zeros((R, H, S, L)).scatter_add_(
                    3, _expand_bins(b, H), dbias)
                dq += torch.einsum("rhal,lhd->rhad", dsq, tq[ax])
                dtq[ax] = _table_grad(dsq, q)
                dsk = q.new_zeros((R, H, S, L)).scatter_add_(
                    3, _expand_bins(b.transpose(1, 2), H), dbias.transpose(2, 3))
                dk += torch.einsum("rhbl,lhd->rhbd", dsk, tk[ax])
                dtk[ax] = _table_grad(dsk, k)
            dtables += [dtq, dtk]
        return (None, dq, dk, *dtables)


class _PairValue(torch.autograd.Function):
    """Sum over the modes and axes of sum_b attn[a, b] Tv[bin(a, b)]: (R, H,
    S, D) from the attention (R, H, S, S), uint8 bins and each mode's Tv
    (3, L, H, D); the per-bin sums are rebuilt in the backward, not kept."""

    @staticmethod
    def forward(ctx, bins, attn, *tables):
        ctx.save_for_backward(bins, attn, *tables)
        R, H, S, _ = attn.shape
        out = attn.new_zeros((R, H, S, tables[0].shape[-1]))
        for j, tv in enumerate(tables):
            for ax in range(3):
                b = _expand_bins(bins[..., 3 * j + ax].long(), H)
                hist = attn.new_zeros((R, H, S, tv.shape[1])).scatter_add_(3, b, attn)
                out += torch.einsum("rhal,lhd->rhad", hist, tv[ax])
        return out

    @staticmethod
    def backward(ctx, dout):
        bins, attn, *tables = ctx.saved_tensors
        R, H, S, _ = attn.shape
        dattn = torch.zeros_like(attn)
        dtables = []
        for j, tv in enumerate(tables):
            dtv = torch.empty_like(tv)
            for ax in range(3):
                b = _expand_bins(bins[..., 3 * j + ax].long(), H)
                dattn += torch.einsum("rhad,lhd->rhal", dout, tv[ax]).gather(3, b)
                hist = attn.new_zeros((R, H, S, tv.shape[1])).scatter_add_(3, b, attn)
                dtv[ax] = _table_grad(hist, dout)
            dtables.append(dtv)
        return (None, dattn, *dtables)


class WindowAttentionCRSE(nn.Module):
    """W-MSA with contextual relative signal embedding (reference
    swin3d_layers.py:383-577) over window rows: x (R, S, C) features, sig
    (R, S, 3 x modes) signals (xyz in voxel units first, then rgb / norm in
    [-1, 1]), valid (R, S) slots."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 quant_size: int = 4, signal_modes: Sequence[str] = ("xyz", "rgb"),
                 qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.quant_size = window_size, quant_size
        self.signal_modes = tuple(signal_modes)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        for mode in self.signal_modes:
            L, _ = mode_params(mode, window_size, quant_size)
            if L > 256:
                raise ValueError(f"{mode}: {L} table bins do not fit the uint8 bins")
            for side in "qkv":
                t = nn.Parameter(torch.empty(3, L, num_heads, dim // num_heads))
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04)
                setattr(self, f"{mode}_{side}_table", t)

    def _tables(self, sides):
        return [getattr(self, f"{m}_{s}_table") for m in self.signal_modes
                for s in sides]

    @torch.no_grad()
    def bins(self, sig):
        """(R, S, S, 3 x modes) uint8 table bins of every (query, key) pair:
        clip(floor(delta * scale) + L // 2, 0, L - 1) of the signal
        difference delta = sig[a] - sig[b]."""
        parts = []
        for mi, mode in enumerate(self.signal_modes):
            L, scale = mode_params(mode, self.window_size, self.quant_size)
            s = sig[..., 3 * mi:3 * mi + 3]
            delta = s[:, :, None, :] - s[:, None, :, :]
            parts.append(torch.clamp(
                torch.floor(delta * scale).to(torch.int32) + L // 2, 0, L - 1
            ).to(torch.uint8))
        return torch.cat(parts, dim=-1)

    def _core(self, q, k, v, sig, valid):
        bins = self.bins(sig)
        logits = q @ k.transpose(2, 3) + _PairBias.apply(
            bins, q, k, *self._tables("qk"))
        logits = logits.masked_fill(~valid[:, None, None, :], -1e9)
        # a row with a valid key gives its invalid keys exactly 0 (exp of
        # -1e9 below the maximum); a row with none (not on the model's
        # path) is masked out after the projection
        attn = torch.softmax(logits, dim=-1)
        return attn @ v + _PairValue.apply(bins, attn, *self._tables("v"))

    def forward(self, x, sig, valid):
        R, S, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).reshape(R, S, 3, H, D).permute(2, 0, 3, 1, 4)
        q = (qkv[0] * D ** -0.5).contiguous()  # (R, H, S, D)
        k, v = qkv[1].contiguous(), qkv[2].contiguous()
        rows = max(ATTN_CHUNK_ELEMENTS // (H * S * S), 1)
        outs = [self._core(q[r:r + rows], k[r:r + rows], v[r:r + rows],
                           sig[r:r + rows], valid[r:r + rows])
                for r in range(0, R, rows)]
        out = torch.cat(outs) if outs else q.new_zeros((0, H, S, D))
        out = self.proj(out.permute(0, 2, 1, 3).reshape(R, S, C))
        return torch.where(valid[..., None], out, 0.0)


class SwinBlockCRSE(nn.Module):
    """LN -> cRSE window attention -> residual, LN -> MLP(4x, GELU) ->
    residual (reference SwinTransformerBlock, swin3d_layers.py:579-627);
    odd blocks shift the windows by half a window."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 voxel_size: float, quant_size: int, shift: bool,
                 window_capacity: int, signal_modes: Sequence[str],
                 drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.voxel_size = window_size, voxel_size
        self.shift, self.window_capacity = shift, window_capacity
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionCRSE(dim, num_heads, window_size,
                                        quant_size, signal_modes)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(4 * dim, dim))
        self.drop_path = DropPath(drop_path)
        self.window_stats = None

    def forward(self, coord, feat, sig_rest, mask, num_windows: int):
        B, N, C = feat.shape
        W, S = num_windows, self.window_capacity
        wid = window_ids(coord, mask, self.window_size * self.voxel_size,
                         shift=self.shift)
        (pidx, slot_valid, win, slot), dropped = pack_windows(wid, W, S)
        # the rows that hold points (a row's slots fill from the first)
        occupied = slot_valid[..., 0].reshape(-1)  # (B * W,)
        rows = occupied.nonzero().squeeze(1)  # reads the row count back
        R = rows.numel()
        src = (pidx + torch.arange(B, device=feat.device)[:, None, None] * N
               ).reshape(B * W, S).index_select(0, rows).reshape(-1)
        valid = slot_valid.reshape(B * W, S).index_select(0, rows)

        h = self.norm1(feat)
        sig = torch.cat([coord * reciprocal(self.voxel_size), sig_rest], dim=-1)
        hw = h.reshape(B * N, C).index_select(0, src).reshape(R, S, C)
        hw = hw * valid[..., None]
        sw = sig.reshape(B * N, -1).index_select(0, src).reshape(R, S, -1)
        out = self.attn(hw, sw, valid).reshape(R * S, C)

        # back to the points through their (occupied row, slot); points in
        # dropped windows or slots read a zero row appended past the rest
        compact = torch.cumsum(occupied.to(torch.int64), 0) - 1
        row = torch.arange(B, device=feat.device)[:, None] * W + win.clamp_min(0)
        at = torch.where(win >= 0, compact[row] * S + slot, R * S)
        out = torch.cat([out, out.new_zeros((1, C))])
        h_attn = out.index_select(0, at.reshape(-1)).reshape(B, N, C)

        feat = feat + self.drop_path(h_attn)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)))
        self.window_stats = (R, B * W) + dropped
        return torch.where(mask[..., None], feat, 0.0)


@MODELS.register_module("Swin3D-v1m1")
class Swin3D(nn.Module):
    """Swin3D U-Net (reference swin3d_v1m1_base.py:13-214). ``feat`` carries
    the colour signal in channels ``color_channels`` and, where
    ``signal_modes`` has "norm", the normals in ``normal_channels``."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        base_grid_size: float = 0.02,
        channels: Sequence[int] = (48, 96, 192, 384, 384),
        num_heads: Sequence[int] = (6, 6, 12, 24, 24),
        depths: Sequence[int] = (2, 4, 9, 4, 4),
        window_sizes: Sequence[int] = (5, 7, 7, 7, 7),
        quant_size: int = 4,
        signal_modes: Sequence[str] = ("xyz", "rgb"),
        color_channels: Tuple[int, int] = (3, 6),
        normal_channels: Optional[Tuple[int, int]] = None,
        drop_path_rate: float = 0.3,
        up_k: int = 3,
        knn_down_k: int = 16,
        stage_cap_ratios: Sequence[float] = (0.4, 0.4, 0.4, 0.4),
        window_occupancy: float = 0.25,
        window_capacity: int = 64,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.base_grid_size = base_grid_size
        self.channels, self.depths = tuple(channels), tuple(depths)
        self.signal_modes = tuple(signal_modes)
        self.color_channels = color_channels
        self.normal_channels = normal_channels
        self.up_k, self.knn_down_k = up_k, knn_down_k
        self.stage_cap_ratios = tuple(stage_cap_ratios)
        self.window_occupancy = window_occupancy
        self.pool_overflow = None
        self.window_stats = None

        stem = torch.empty(27, in_channels, self.channels[0])
        nn.init.trunc_normal_(stem, std=0.02, a=-0.04, b=0.04)
        self.stem_kernel = nn.Parameter(stem)
        self.stem_bn = PointBatchNorm(self.channels[0])
        dp = np.linspace(0, drop_path_rate, sum(self.depths))
        voxel, bi = base_grid_size, 0
        for s, depth in enumerate(self.depths):
            for d in range(depth):
                setattr(self, f"stage{s}_block{d}", SwinBlockCRSE(
                    self.channels[s], num_heads[s], window_sizes[s], voxel,
                    quant_size, d % 2 == 1, window_capacity, self.signal_modes,
                    float(dp[bi])))
                bi += 1
            if s == len(self.depths) - 1:
                break
            voxel = voxel * 2
            c, c2 = self.channels[s], self.channels[s + 1]
            setattr(self, f"down{s}_norm", nn.LayerNorm(c, eps=LN_EPS))
            setattr(self, f"down{s}_linear", nn.Linear(c, c2, bias=False))
            setattr(self, f"up{s}_norm2", nn.LayerNorm(c2, eps=LN_EPS))
            setattr(self, f"up{s}_linear2", nn.Linear(c2, c))
            setattr(self, f"up{s}_norm1", nn.LayerNorm(c, eps=LN_EPS))
            setattr(self, f"up{s}_linear1", nn.Linear(c, c))
        if num_classes > 0:
            c0 = self.channels[0]
            self.seg_fc = nn.Linear(c0, c0)
            self.seg_bn = PointBatchNorm(c0)
            self.seg_out = nn.Linear(c0, num_classes)

    def stage_capacities(self, n: int):
        """The padded point count of each stage: n, then max(int(cap *
        ratio), 64) of the stage before."""
        caps = [n]
        for r in self.stage_cap_ratios[:len(self.depths) - 1]:
            caps.append(max(int(caps[-1] * r), 64))
        return caps

    def _signals(self, feat):
        parts = []
        if "rgb" in self.signal_modes:
            parts.append(feat[..., self.color_channels[0]:self.color_channels[1]])
        if "norm" in self.signal_modes:
            parts.append(feat[..., self.normal_channels[0]:self.normal_channels[1]])
        if parts:
            return torch.cat(parts, dim=-1)
        return feat.new_zeros(feat.shape[:2] + (0,))

    def _stem(self, coord, feat, mask):
        """The 3^3 submanifold convolution on floor((coord - min) /
        base_grid_size), BN, ReLU."""
        lo = torch.where(mask[..., None], coord, _BIG).amin(dim=1)
        dc = torch.floor((coord - lo[:, None, :]) * reciprocal(self.base_grid_size))
        dc = torch.where(mask[..., None], dc.to(torch.int64), 0)
        idx, val = neighbor_idx(build_table(dc, mask), dc, mask,
                                kernel_offsets(3, coord.device))
        h = sparse_conv_apply(feat, idx, val, self.stem_kernel)
        return torch.relu(self.stem_bn(h, mask))

    def forward(self, coord, feat, mask):
        sig_rest = self._signals(feat)
        h = self._stem(coord, feat, mask)
        skips, stats = [], []
        overflow = torch.zeros((), dtype=torch.int64, device=coord.device)
        last = len(self.depths) - 1
        voxel = self.base_grid_size
        caps = self.stage_capacities(coord.shape[1])
        for s in range(last + 1):
            n_win = max(int(caps[s] * self.window_occupancy), 16)
            for d in range(self.depths[s]):
                block = getattr(self, f"stage{s}_block{d}")
                h = block(coord, h, sig_rest, mask, n_win)
                stats.append((s, d) + block.window_stats)
            if s == last:
                break
            # GridKNNDownsample: stride-2 voxel centres; the feature is the
            # max over Linear(LN(feat)) of the k nearest points before
            skips.append((coord, h, mask))
            cap = caps[s + 1]
            voxel = voxel * 2
            pc, _, pm, cluster, n_clusters = grid_pool(coord, h, mask, voxel, cap)
            overflow = overflow + torch.clamp_min(n_clusters - cap, 0).sum()
            sig_down = _segment_mean(sig_rest, cluster, mask, cap)
            hn = getattr(self, f"down{s}_linear")(getattr(self, f"down{s}_norm")(h))
            nidx, _, nvalid = knn(pc, coord, self.knn_down_k, pm, mask)
            g = grouping(hn, nidx, nvalid)
            h = torch.amax(torch.where(nvalid[..., None], g, -_BIG), dim=2)
            h = torch.where(pm[..., None], h, 0.0)
            coord, mask, sig_rest = pc, pm, sig_down

        for s in reversed(range(last)):
            skip_coord, skip_feat, skip_mask = skips[s]
            up = interpolation(
                coord, skip_coord,
                getattr(self, f"up{s}_linear2")(getattr(self, f"up{s}_norm2")(h)),
                mask, skip_mask, k=self.up_k)
            h = up + getattr(self, f"up{s}_linear1")(
                getattr(self, f"up{s}_norm1")(skip_feat))
            coord, mask = skip_coord, skip_mask
        self.pool_overflow, self.window_stats = overflow, stats

        if self.num_classes > 0:
            # Linear-BN-ReLU-Linear (swin3d_v1m1_base.py:108-113)
            g = torch.relu(self.seg_bn(self.seg_fc(h), mask))
            h = self.seg_out(g)
        return h
