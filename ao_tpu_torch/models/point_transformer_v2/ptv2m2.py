"""Point Transformer V2 (modes 1 and 2), train and eval forward (port of
ao_tpu/models/point_transformer_v2/ptv2m2.py).

Same data model as the JAX package: dense padded ``(B, N, ...)`` tensors
with a bool mask, static per-stage point capacities, one neighbour graph
per resolution shared by the encoder and decoder stages at it, and the
same dispatch rules:

* ``_slab_geometry``: on the card, stages with C <= 384 and N >= 2048 keep
  their points Morton-sorted and build the window-restricted graph of
  ``knn_self_presorted`` (half-window 256 rows); the TPU package's "backend
  is tpu" test is "device is cuda" here.
* the JAX package's kernel-path switches, read at call time with its
  defaults: ``AO_EXACT_KNN=1`` (the exact kNN, gathered path),
  ``AO_GVA_SLAB=0`` (the gathered path), ``AO_SLAB_W`` (the slab
  half-window) and ``AO_GVA_FUSED=0`` (the unfused attention).
* the fused GVA kernels run on the card for bf16 compute at N >= 64 (K3 in
  eval mode; K4, K5, K3 and, backwards, K6 in train mode); below that
  gate, and off the card, the unfused composition with the reference's pad
  semantics runs, differentiated by autograd.

Train mode (``model.train()``) normalises with batch statistics and
updates the running ones, applies stochastic depth, and carries the
position moments of each resolution's graph in the stage cache, so that
K4 runs once per resolution and the decoder stage at it reuses them.
``enable_checkpoint`` recomputes each block in the backward
(``torch.utils.checkpoint``, as the JAX package's ``nn.remat``), drawing
the same random masks and updating no running statistic a second time.

The forward's stages are spans (utils/tracing.py): ``ptv2m2/embed``,
``ptv2m2/enc<i>`` (pooling and blocks) and ``ptv2m2/dec<i>`` (unpooling
and blocks), for reading a profiler trace by stage. The checkpoint reruns
each block, not its stage, so the recomputed blocks run inside the
trainer's ``step/backward`` and outside every stage span.

The PT-v2m1 attention (``pe_multiplier``, the GroupedLinear weight
encoding, or no pe bias) is the JAX package's ``_legacy_attention``: its
stages take the multi-probe graph and relative positions cached per
resolution, and it runs unfused everywhere (no kernel of its own).

So the port on the CPU follows the JAX package's CPU path, and the port on
the card follows its TPU path. Parameter names follow the reference torch
model, so ``convert.from_jax_variables`` carries JAX weights across.
"""

from __future__ import annotations

from typing import Optional, Sequence

import contextlib
import math
import os

import torch
import torch.utils.checkpoint
from torch import nn

from ...ops.grid_pool import grid_pool, unpool_map
from ...ops.grouping import grouping, grouping_with_rel_coord
from ...ops.gva import (folded_params, gva_eval, gva_reference, gva_train,
                        pack_coords)
from ...ops.interpolation import interpolation
from ...ops.knn import knn_query
from ...ops.knn_spatial import (knn_self_presorted, knn_self_spatial,
                                knn_window_fits, morton_code)
from ...ops.point_bn import update_running_stats
from ...utils import tracing
from ..builder import MODELS
from ..utils import DropPath, Dropout, PointBatchNorm, dense

# Below this point count one curve window covers (nearly) the whole cloud,
# so a single probe is exact; above it, three probes.
_SMALL_N = 1152
# the slab half-window in curve rows when AO_SLAB_W is unset
_SLAB_W = 256


def _env_on(name):
    """Whether the kernel-path switch ``name`` (the JAX package's ``AO_*``
    variables, read at call time as it reads them at trace time) is set to
    "1": an off-by-default mode turns on at "1" alone."""
    return os.environ.get(name, "0") == "1"


def _env_off(name):
    """Whether the kernel-path switch ``name`` is set to "0": an
    on-by-default path turns off at "0" alone, any other value keeps it."""
    return os.environ.get(name, "1") == "0"


def _self_knn(coord, mask, k):
    """The stage graph off the slab path: the exact kNN under
    ``AO_EXACT_KNN=1`` (the JAX package's diagnostic mode, which isolates
    the windowed search's approximation), else the single-probe window
    search up to ``_SMALL_N`` points and the three-probe one above."""
    if _env_on("AO_EXACT_KNN"):
        return knn_query(k, coord, mask)
    if coord.shape[1] <= _SMALL_N:
        return knn_self_spatial(coord, mask, k=k, probes=1, exact_dist=False)
    return knn_self_spatial(coord, mask, k=k, exact_dist=False)


def _slab_geometry(C, N, S, device):
    """Window geometry of the slab path for a stage, or None for the
    gathered path. (TQ, J) are the TPU kernel's slab tiling; the kNN window
    (tile_q, window, front) lies inside every covering slab:
    window = 2W + 2TQ - tile_q, front = W - tile_q + TQ.

    The JAX package's switches, read at call time: ``AO_GVA_SLAB=0`` and
    ``AO_EXACT_KNN=1`` take the gathered path; ``AO_SLAB_W`` sets the
    half-window W (rounded down to a TQ multiple, at least one block; 512
    gives the wider graph). A window beyond what K1's shared memory holds
    raises a ValueError naming the largest AO_SLAB_W the stage takes."""
    if _env_off("AO_GVA_SLAB") or _env_on("AO_EXACT_KNN"):
        return None
    if device.type != "cuda" or C > 384 or N < 2048:
        return None
    TQ = 128 if C <= 96 else (64 if C <= 192 else 32)
    w_env = int(os.environ.get("AO_SLAB_W", str(_SLAB_W)))
    J = 2 * max(w_env // TQ, 1) + 1
    W = (J - 1) // 2 * TQ
    tile_q = 128 if TQ >= 64 else 64
    window = 2 * W + 2 * TQ - tile_q
    if not knn_window_fits(S, tile_q, window):
        w_max = TQ
        while knn_window_fits(S, tile_q, 2 * (w_max + TQ) + 2 * TQ - tile_q):
            w_max += TQ
        raise ValueError(
            f"AO_SLAB_W={w_env}: the stage (C={C}, N={N}, k={S}) would search "
            f"a window of {window} rows, beyond K1's shared memory; AO_SLAB_W "
            f"takes at most {w_max + TQ - 1} at this stage (W={w_max})")
    return dict(TQ=TQ, J=J, W=W, tile_q=tile_q, window=window,
                front=W - tile_q + TQ)


class GroupedLinear(nn.Module):
    """PT-v2m1's first weight-encoding layer (reference
    point_transformer_v2m1_origin.py:24-56): scale the C channels by a
    (1, C) weight, then sum each of the G groups' C / G channels."""

    def __init__(self, in_features, out_features, groups):
        super().__init__()
        if in_features % groups or out_features != groups:
            raise ValueError("GroupedLinear: groups must divide in_features "
                             "and equal out_features")
        self.groups = groups
        self.weight = nn.Parameter(torch.empty((1, in_features)))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        y = x * self.weight
        return y.reshape(x.shape[:-1] + (self.groups, -1)).sum(-1)


def _pe_mlp(C):
    return nn.Sequential(nn.Linear(3, C), PointBatchNorm(C), nn.ReLU(),
                         nn.Linear(C, C))


class GroupedVectorAttention(nn.Module):
    """Grouped vector attention: masked softmax over S neighbours per group.

    PT-v2m2 (pe bias, Dense weight encoding) runs on the fused kernels or
    their unfused composition. The PT-v2m1 variants (``pe_multiplier``,
    ``grouped_linear`` or no pe bias) are ``legacy``: the JAX package's
    ``_legacy_attention``, unfused, on the relative positions ``pos`` of
    the stage's graph."""

    def __init__(self, embed_channels, groups, attn_drop_rate=0.0,
                 qkv_bias=True, pe_multiplier=False, pe_bias=True,
                 grouped_linear=False, dtype=None):
        super().__init__()
        C, G = embed_channels, groups
        self.embed_channels, self.groups = C, G
        self.attn_drop_rate = attn_drop_rate
        self.pe_multiplier, self.pe_bias = pe_multiplier, pe_bias
        self.legacy = pe_multiplier or not pe_bias or grouped_linear
        self.dtype = dtype
        self.linear_q = nn.Sequential(
            nn.Linear(C, C, bias=qkv_bias), PointBatchNorm(C), nn.ReLU())
        self.linear_k = nn.Sequential(
            nn.Linear(C, C, bias=qkv_bias), PointBatchNorm(C), nn.ReLU())
        self.linear_v = nn.Linear(C, C, bias=qkv_bias)
        if pe_multiplier:
            self.linear_p_multiplier = _pe_mlp(C)
        if pe_bias:
            self.linear_p_bias = _pe_mlp(C)
        self.weight_encoding = nn.Sequential(
            GroupedLinear(C, G, G) if grouped_linear else nn.Linear(C, G),
            PointBatchNorm(G), nn.ReLU(), nn.Linear(G, G))
        self.attn_drop = Dropout(attn_drop_rate)

    def fused_ok(self, device) -> bool:
        """The fused kernel covers the PT-v2m2 attention in bf16 compute
        without attention dropout, on the card, unless ``AO_GVA_FUSED=0``
        (the JAX package's switch to the unfused, reference-shaped path)."""
        return (not _env_off("AO_GVA_FUSED") and device.type == "cuda"
                and self.dtype == torch.bfloat16
                and self.attn_drop_rate == 0.0 and not self.legacy)

    def raw_params(self):
        """The pe / weight-encoding MLP parameters and running statistics
        in the JAX package's (in, out) layout."""
        p1, pbn, p2 = (self.linear_p_bias[i] for i in (0, 1, 3))
        w1, wbn, w2 = (self.weight_encoding[i] for i in (0, 1, 3))
        return dict(
            Wp1=p1.weight.t(), bp1=p1.bias, gp=pbn.norm.weight,
            bp=pbn.norm.bias, pe_mean=pbn.norm.running_mean,
            pe_var=pbn.norm.running_var, Wp2=p2.weight.t(), bp2=p2.bias,
            W1=w1.weight.t(), b1=w1.bias, gw=wbn.norm.weight,
            bw=wbn.norm.bias, we_mean=wbn.norm.running_mean,
            we_var=wbn.norm.running_var, W2=w2.weight.t(), b2=w2.bias,
        )

    def forward(self, feat, coord6, idx, idx_valid, mask, fused: bool,
                pos_moments=None, pos=None):
        """Returns (out, pos_moments). In train mode on the fused path the
        position moments of this resolution's graph are computed (K4) when
        ``pos_moments`` is None and returned for the next block. The legacy
        attention reads the relative positions ``pos`` (B, N, S, 3)."""
        dt = self.dtype
        q = self.linear_q[1](dense(self.linear_q[0], feat, dt), mask,
                             relu=True)
        k = self.linear_k[1](dense(self.linear_k[0], feat, dt), mask,
                             relu=True)
        v = dense(self.linear_v, feat, dt)
        if self.legacy:
            return self._legacy_attention(q, k, v, pos, idx, idx_valid,
                                          mask), None
        p = self.raw_params()
        if fused:
            bf = torch.bfloat16
            src = torch.cat([k.to(bf), v.to(bf), coord6], dim=-1)
            qrow = torch.cat([q.to(bf), coord6, mask[..., None].to(bf)], dim=-1)
            if not self.training:
                return gva_eval(src, qrow, idx, idx_valid,
                                folded_params(p)), pos_moments
            out, stats_w, stats_p, pos_moments = gva_train(
                src, qrow, idx, idx_valid, p, pos_moments)
        else:
            if not self.training:
                return gva_reference(k, v, q, coord6, idx, idx_valid, mask, p,
                                     dt or torch.float32), pos_moments
            out, stats_w, stats_p = gva_reference(
                k, v, q, coord6, idx, idx_valid, mask, p, dt or torch.float32,
                train=True)
        update_running_stats(self.linear_p_bias[1].norm, *stats_p)
        update_running_stats(self.weight_encoding[1].norm, *stats_w)
        return out, pos_moments

    def _pe(self, mlp, pos, idx_valid):
        """Linear(3, C) -> BN over the valid edges -> ReLU -> Linear(C, C)."""
        h = mlp[1](dense(mlp[0], pos, self.dtype), idx_valid, relu=True)
        return dense(mlp[3], h, self.dtype)

    def _legacy_attention(self, q, k, v, pos, idx, idx_valid, mask):
        """Port of the JAX package's ``_legacy_attention``, with its casts:
        the gathered rows, the relation and the pe MLPs in the compute
        dtype, the GroupedLinear product in f32 (a compute-dtype relation
        times the f32 weight), the softmax in f32, masked to -inf on invalid
        slots and zeroed there after, the weighted sum with f32 accumulation
        rounded to the compute dtype."""
        C, G = self.embed_channels, self.groups
        dt = self.dtype
        if dt is not None:
            k, v = k.to(dt), v.to(dt)
        kv_g = grouping(torch.cat([k, v], dim=-1), idx, idx_valid)
        k_g, v_g = kv_g[..., :C], kv_g[..., C:]
        relation = k_g - q[:, :, None, :]
        if self.pe_multiplier:
            relation = relation * self._pe(self.linear_p_multiplier, pos,
                                           idx_valid)
        if self.pe_bias:
            peb = self._pe(self.linear_p_bias, pos, idx_valid)
            relation = relation + peb
            v_g = v_g + peb
        we = self.weight_encoding
        if isinstance(we[0], GroupedLinear):
            w = we[0](relation)
        else:
            w = dense(we[0], relation, dt)
        w = we[1](w, idx_valid, relu=True)
        w = dense(we[3], w, dt)
        w = torch.where(idx_valid[..., None], w.float(), -math.inf)
        w = torch.where(idx_valid[..., None], torch.softmax(w, dim=2), 0.0)
        if dt is not None:
            w = w.to(dt)
        w = self.attn_drop(w)
        B, N, S, _ = v_g.shape
        out = torch.einsum("bnsgi,bnsg->bngi",
                           v_g.reshape(B, N, S, G, C // G).float(), w.float())
        out = out.to(v_g.dtype).reshape(B, N, C).float()
        return torch.where(mask[..., None], out, 0.0)


class Block(nn.Module):
    def __init__(self, embed_channels, groups, qkv_bias=True,
                 pe_multiplier=False, pe_bias=True, attn_drop_rate=0.0,
                 drop_path_rate=0.0, grouped_linear=False, dtype=None):
        super().__init__()
        C = embed_channels
        self.dtype = dtype
        self.attn = GroupedVectorAttention(
            C, groups, attn_drop_rate, qkv_bias, pe_multiplier, pe_bias,
            grouped_linear, dtype)
        self.fc1 = nn.Linear(C, C, bias=False)
        self.fc3 = nn.Linear(C, C, bias=False)
        self.norm1 = PointBatchNorm(C)
        self.norm2 = PointBatchNorm(C)
        self.norm3 = PointBatchNorm(C)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, feat, coord6, idx, idx_valid, mask, fused,
                pos_moments=None, pos=None):
        identity = feat
        h = self.norm1(dense(self.fc1, feat, self.dtype), mask, relu=True)
        h, pos_moments = self.attn(h, coord6, idx, idx_valid, mask, fused,
                                   pos_moments, pos)
        h = self.norm2(h, mask, relu=True)
        h = self.norm3(dense(self.fc3, h, self.dtype), mask)
        h = torch.relu(identity + self.drop_path(h))
        return torch.where(mask[..., None], h, 0.0), pos_moments


class _Recompute:
    """One block under ``torch.utils.checkpoint`` (non-reentrant). The
    checkpoint keeps the block's inputs and recomputes its forward when the
    backward needs the tensors it saved; that recomputation must see what
    the first forward saw and change nothing:

    * random draws: ``preserve_rng_state`` restores only the default
      generators, so the states of the block's explicit generators
      (drop path, attention dropout) are saved before the forward, set for
      the recomputation and put back after it;
    * running statistics: the recomputation's BatchNorm updates are undone
      (every buffer of the block is restored), so they update once, as
      flax's ``nn.remat`` keeps the first forward's;
    * position moments: the recomputation reuses the first forward's, so
      K4 runs once per resolution as without checkpointing."""

    def __init__(self, block):
        self.block = block
        self.generators = list({
            id(m.generator): m.generator for m in block.modules()
            if isinstance(m, (DropPath, Dropout)) and m.generator is not None
        }.values())
        self.states = None
        self.pos_moments = None

    def run(self, feat, coord6, idx, idx_valid, mask, fused, pos_moments, pos):
        if self.pos_moments is not None:  # the recomputation
            pos_moments = self.pos_moments
        out, self.pos_moments = self.block(feat, coord6, idx, idx_valid, mask,
                                           fused, pos_moments, pos)
        return out

    @contextlib.contextmanager
    def forward_context(self):
        self.states = [g.get_state() for g in self.generators]
        yield

    @contextlib.contextmanager
    def recompute_context(self):
        after = [g.get_state() for g in self.generators]
        buffers = list(self.block.buffers())
        saved = [b.clone() for b in buffers]
        for g, s in zip(self.generators, self.states):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(self.generators, after):
                g.set_state(s)
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)

    def __call__(self, *args):
        return torch.utils.checkpoint.checkpoint(
            self.run, *args, use_reentrant=False,
            context_fn=lambda: (self.forward_context(),
                                self.recompute_context())), self.pos_moments


class BlockSequence(nn.Module):
    def __init__(self, depth, embed_channels, groups, neighbours=16,
                 qkv_bias=True, pe_multiplier=False, pe_bias=True,
                 attn_drop_rate=0.0, drop_path_rates: Sequence[float] = (),
                 enable_checkpoint=False, grouped_linear=False, dtype=None):
        super().__init__()
        self.embed_channels = embed_channels
        self.neighbours = neighbours
        self.enable_checkpoint = enable_checkpoint
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList(
            Block(embed_channels, groups, qkv_bias, pe_multiplier, pe_bias,
                  attn_drop_rate, rates[i], grouped_linear, dtype)
            for i in range(depth)
        )
        self.legacy = pe_multiplier or not pe_bias or grouped_linear

    def forward(self, feat, coord, mask, knn_cache=None,
                force: Optional[dict] = None):
        """Returns (feat, knn_cache). The cache holds this resolution's
        neighbour graph (and, on the slab path, its Morton sort) for the
        decoder stage at the same resolution, in train mode the graph's
        position moments, and for the legacy attention the graph's relative
        positions.

        ``force`` (tests only) sets the dispatch explicitly, as
        ``dict(slab=<geometry dict or None>, fused=<bool>)``, so that the
        card's path can be held against the JAX package on the CPU."""
        N = coord.shape[1]
        if force is not None:
            slab = force["slab"]
        elif self.legacy:
            slab = None
        else:
            slab = _slab_geometry(self.embed_channels, N, self.neighbours,
                                  coord.device)
        if knn_cache is not None and knn_cache["slab"] == slab:
            cache = knn_cache
        else:
            cache = dict(slab=slab, order=None, inv=None, pos_moments=None,
                         pos=None)
            if slab is not None:
                order = torch.argsort(morton_code(coord, mask), dim=1,
                                      stable=True)
                cache["order"] = order
                cache["inv"] = torch.argsort(order, dim=1)
                cache["coord"] = torch.gather(
                    coord, 1, order[..., None].expand(-1, -1, 3))
                cache["mask"] = torch.gather(mask, 1, order)
                idx, _, idx_valid = knn_self_presorted(
                    cache["coord"], cache["mask"], k=self.neighbours,
                    tile_q=slab["tile_q"], window=slab["window"],
                    front=slab["front"],
                )
            else:
                cache["coord"], cache["mask"] = coord, mask
                idx, _, idx_valid = _self_knn(coord, mask, self.neighbours)
            cache["idx"], cache["idx_valid"] = idx, idx_valid
            cache["coord6"] = pack_coords(cache["coord"])
        if self.legacy and cache["pos"] is None:
            cache["pos"] = grouping_with_rel_coord(
                cache["coord"], cache["coord"], cache["idx"],
                cache["idx_valid"])
        mask_u = cache["mask"]
        if force is not None:
            fused = force["fused"]
        else:
            fused = all(b.attn.fused_ok(coord.device) for b in self.blocks)
        fused = fused and N >= 64  # below: the reference's pad semantics
        if cache["order"] is not None:
            feat = torch.gather(
                feat, 1, cache["order"][..., None].expand(-1, -1, feat.shape[-1]))
        pos_moments = cache["pos_moments"]
        remat = (self.enable_checkpoint and self.training
                 and torch.is_grad_enabled())
        for blk in self.blocks:
            feat, pos_moments = (_Recompute(blk) if remat else blk)(
                feat, cache["coord6"], cache["idx"], cache["idx_valid"],
                mask_u, fused, pos_moments, cache["pos"])
        cache["pos_moments"] = pos_moments
        if cache["order"] is not None:
            feat = torch.gather(
                feat, 1, cache["inv"][..., None].expand(-1, -1, feat.shape[-1]))
        return feat, cache


class GridPool(nn.Module):
    """fc -> BN -> ReLU, then grid pooling (mean coord / max feat). Also
    returns the count of clusters beyond the static capacity, which merge
    into the last one (the trainer's ``pool_overflow`` metric)."""

    def __init__(self, in_channels, out_channels, grid_size, bias=False):
        super().__init__()
        self.grid_size = grid_size
        self.fc = nn.Linear(in_channels, out_channels, bias=bias)
        self.norm = PointBatchNorm(out_channels)

    def forward(self, feat, coord, mask, max_clusters):
        h = self.norm(dense(self.fc, feat), mask, relu=True)
        pc, pf, pm, cluster, n_clusters = grid_pool(
            coord, h, mask, self.grid_size, max_clusters)
        overflow = torch.clamp_min(n_clusters - max_clusters, 0).sum()
        return pc, pf, pm, cluster, overflow


class UnpoolWithSkip(nn.Module):
    """Map / interp unpooling with skip connection."""

    def __init__(self, in_channels, skip_channels, out_channels, bias=True,
                 skip=True, backend="map"):
        super().__init__()
        self.skip = skip
        self.backend = backend
        self.proj = nn.Sequential(nn.Linear(in_channels, out_channels, bias=bias),
                                  PointBatchNorm(out_channels), nn.ReLU())
        self.proj_skip = nn.Sequential(
            nn.Linear(skip_channels, out_channels, bias=bias),
            PointBatchNorm(out_channels), nn.ReLU())

    def forward(self, feat, coord, mask, skip_feat, skip_coord, skip_mask,
                cluster):
        h = self.proj[1](dense(self.proj[0], feat), mask, relu=True)
        if self.backend == "map" and cluster is not None:
            up = unpool_map(h, cluster, skip_mask)
        else:
            up = interpolation(coord, skip_coord, h, mask, skip_mask, k=3)
        if self.skip:
            s = self.proj_skip[1](dense(self.proj_skip[0], skip_feat),
                                  skip_mask, relu=True)
            up = up + s
        return torch.where(skip_mask[..., None], up, 0.0)


class _Stage(nn.Module):
    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(self, name, m)


@MODELS.register_module("PT-v2m2")
class PointTransformerV2(nn.Module):
    """U-Net of grouped-vector-attention stages over grid-pooled resolutions.

    ``stage_cap_ratios`` bound each pooled stage's static point capacity as
    a fraction of the previous stage's. ``compute_dtype="bfloat16"`` runs
    the attention blocks' activations in bf16; norms and the other layers
    stay f32. After each forward ``pool_overflow`` holds the number of
    clusters that overflowed the stage capacities (0 when they suffice).
    ``grouped_linear`` selects PT-v2m1's weight encoding;
    ``enable_checkpoint`` recomputes every block in the backward of a
    train-mode forward."""

    def __init__(
        self,
        in_channels,
        num_classes,
        patch_embed_depth=1,
        patch_embed_channels=48,
        patch_embed_groups=6,
        patch_embed_neighbours=8,
        enc_depths=(2, 2, 6, 2),
        enc_channels=(96, 192, 384, 512),
        enc_groups=(12, 24, 48, 64),
        enc_neighbours=(16, 16, 16, 16),
        dec_depths=(1, 1, 1, 1),
        dec_channels=(48, 96, 192, 384),
        dec_groups=(6, 12, 24, 48),
        dec_neighbours=(16, 16, 16, 16),
        grid_sizes=(0.06, 0.12, 0.24, 0.48),
        attn_qkv_bias=True,
        pe_multiplier=False,
        pe_bias=True,
        attn_drop_rate=0.0,
        drop_path_rate=0.0,
        enable_checkpoint=False,  # activation remat: training only
        unpool_backend="map",
        stage_cap_ratios=(0.35, 0.35, 0.35, 0.35),
        compute_dtype: Optional[str] = None,
        grouped_linear=False,
    ):
        super().__init__()
        S = len(enc_depths)
        if not S == len(dec_depths) == len(grid_sizes):
            raise ValueError("enc_depths, dec_depths and grid_sizes differ in length")
        dtype = getattr(torch, compute_dtype) if compute_dtype else None
        self.num_classes = num_classes
        self.pool_overflow = None
        self.dec_neighbours = tuple(dec_neighbours)
        self.stage_cap_ratios = tuple(stage_cap_ratios)

        def linspace(total, n):
            return [float(total)] * n if n <= 1 else [
                total * i / (n - 1) for i in range(n)]

        enc_dp = linspace(drop_path_rate, sum(enc_depths))
        dec_dp = linspace(drop_path_rate, sum(dec_depths))
        enc_ch = (patch_embed_channels,) + tuple(enc_channels)
        dec_ch = tuple(dec_channels) + (enc_ch[-1],)
        common = dict(qkv_bias=attn_qkv_bias, pe_multiplier=pe_multiplier,
                      pe_bias=pe_bias, attn_drop_rate=attn_drop_rate,
                      enable_checkpoint=enable_checkpoint,
                      grouped_linear=grouped_linear, dtype=dtype)

        self.patch_embed = _Stage(
            proj=nn.Sequential(
                nn.Linear(in_channels, patch_embed_channels, bias=False),
                PointBatchNorm(patch_embed_channels), nn.ReLU()),
            blocks=BlockSequence(patch_embed_depth, patch_embed_channels,
                                 patch_embed_groups, patch_embed_neighbours,
                                 **common),
        )
        self.enc_stages = nn.ModuleList()
        self.dec_stages = nn.ModuleList()
        for i in range(S):
            e0, e1 = sum(enc_depths[:i]), sum(enc_depths[:i + 1])
            d0, d1 = sum(dec_depths[:i]), sum(dec_depths[:i + 1])
            self.enc_stages.append(_Stage(
                down=GridPool(enc_ch[i], enc_ch[i + 1], grid_sizes[i]),
                blocks=BlockSequence(enc_depths[i], enc_ch[i + 1],
                                     enc_groups[i], enc_neighbours[i],
                                     drop_path_rates=enc_dp[e0:e1], **common),
            ))
            self.dec_stages.append(_Stage(
                up=UnpoolWithSkip(dec_ch[i + 1], enc_ch[i], dec_ch[i],
                                  backend=unpool_backend),
                blocks=BlockSequence(dec_depths[i], dec_ch[i], dec_groups[i],
                                     dec_neighbours[i],
                                     drop_path_rates=dec_dp[d0:d1], **common),
            ))
        if num_classes > 0:
            self.seg_head = nn.Sequential(
                nn.Linear(dec_ch[0], dec_ch[0]), PointBatchNorm(dec_ch[0]),
                nn.ReLU(), nn.Linear(dec_ch[0], num_classes))

    def stage_capacities(self, n: int):
        """Static point capacity of every resolution for padded size n."""
        caps = [n]
        for r in self.stage_cap_ratios[:len(self.enc_stages)]:
            caps.append(max(int(caps[-1] * r), 64))
        return caps

    def forward(self, coord, feat, mask):
        caps = self.stage_capacities(coord.shape[1])
        pe = self.patch_embed
        with tracing.span("ptv2m2/embed"):
            h = pe.proj[1](dense(pe.proj[0], feat), mask, relu=True)
            h, knn0 = pe.blocks(h, coord, mask)

        skips = [(coord, h, mask, knn0)]
        clusters = []
        overflow = torch.zeros((), dtype=torch.int64, device=coord.device)
        for i, stage in enumerate(self.enc_stages):
            with tracing.span(f"ptv2m2/enc{i}"):
                coord, h, mask, cluster, over = stage.down(h, coord, mask,
                                                           caps[i + 1])
                overflow = overflow + over
                h, knn_i = stage.blocks(h, coord, mask)
            clusters.append(cluster)
            skips.append((coord, h, mask, knn_i))

        # decoder: reuses each skip resolution's cached graph
        coord, h, mask, _ = skips.pop()
        for i in reversed(range(len(self.dec_stages))):
            skip_coord, skip_feat, skip_mask, skip_knn = skips.pop()
            stage = self.dec_stages[i]
            with tracing.span(f"ptv2m2/dec{i}"):
                h = stage.up(h, coord, mask, skip_feat, skip_coord, skip_mask,
                             clusters.pop())
                coord, mask = skip_coord, skip_mask
                if skip_knn["idx"].shape[-1] != self.dec_neighbours[i]:
                    skip_knn = None  # neighbour count differs; recompute
                h, _ = stage.blocks(h, coord, mask, skip_knn)
        self.pool_overflow = overflow

        if self.num_classes > 0:
            g = dense(self.seg_head[0], h)
            g = self.seg_head[1](g, mask, relu=True)
            return dense(self.seg_head[3], g)
        return h


@MODELS.register_module("PT-v2m1")
def _ptv2m1(**kwargs):
    """PT-v2m1 (reference point_transformer_v2m1_origin.py): PT-v2m2 with a
    GroupedLinear first weight-encoding layer (and, in its configs, the pe
    multiplier)."""
    kwargs.setdefault("grouped_linear", True)
    return PointTransformerV2(**kwargs)
