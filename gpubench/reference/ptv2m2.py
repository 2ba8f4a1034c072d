"""Plain PT-v2m2 in float32 PyTorch: the benchmark's reference.

It follows Point Transformer V2 (Wu et al., NeurIPS 2022; Pointcept's
point_transformer_v2m2_base.py) as the port computes it, and imports
nothing of the port. Departures from the published model, each the port's
design, kept so that the two compute the same function:

* dense padded ``(B, N, ...)`` batches with a bool mask; BatchNorm over the
  valid rows; grid pooling into static capacities (a fraction of the
  previous stage's), clusters past the capacity merged into the last;
* the neighbour graph of a stage is the window-restricted search of
  ``knn.py`` over Morton-sorted points (the port's slab path on the card:
  C <= 384 and N >= 2048), else its three-probe window search (one probe
  up to 1152 points), not the exact kNN; the decoder reuses the encoder's
  graph of its resolution when the neighbour counts agree;
* grouped vector attention with the port's pad semantics: the softmax runs
  over every slot, slots without a neighbour take zero keys and values and
  are zeroed after it; the two BatchNorms inside take statistics over every
  slot of a valid query;
* the attention's relative positions are those of the coordinates as the
  port carries them to its attention, two bfloat16 halves (hi, lo) whose
  sum keeps about 16 bits of each coordinate (``packed``); the kNN graphs
  and the pooling take the coordinates themselves.

Everything is computed in float32 with TF32 off. ``lowp`` computes the products the configuration states in
its lower precision (bf16 blocks, or f32) one step lower, for the control:
"fp8" rounds both operands of the attention blocks' products to float8
e4m3 (a per-tensor scale), "tf32" rounds every product's operands to TF32's
10-bit mantissa; the gradient passes the rounding straight through.

``ReferencePTv2`` takes the program's state-dict names, so one set of
weights made by the benchmark loads into both.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

from . import knn as knn_ref

_BIG = 1e30
_INT32_MAX = 2**31 - 1
_EPS = 1e-5
_SMALL_N = 1152  # up to this many points one window probe covers a stage
_SLAB_W = 256  # the slab half-window in sorted rows
_EXACT_PAIR_BUDGET = 2_000_000  # interpolation: exact kNN up to this


# ---------------------------------------------------------------------------
# lower-precision operand rounding (the control)
# ---------------------------------------------------------------------------


def _fp8(x):
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _tf32(x):
    bits = x.detach().float().contiguous().view(torch.int32)
    # round to nearest on the 13 dropped mantissa bits
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _straight(fn, x):
    return x + (fn(x) - x).detach()


class Precision:
    """Where the reference rounds matmul operands: nowhere (``None``), the
    attention blocks' products (``"fp8"``) or every product (``"tf32"``)."""

    def __init__(self, lowp=None):
        if lowp not in (None, "fp8", "tf32"):
            raise ValueError(f"unknown lower precision {lowp!r}")
        self.lowp = lowp

    def mm(self, x, w, block):
        """x @ w (w already (in, out))."""
        if self.lowp == "tf32" or (self.lowp == "fp8" and block):
            fn = _tf32 if self.lowp == "tf32" else _fp8
            x, w = _straight(fn, x), _straight(fn, w)
        return x @ w

    def linear(self, layer, x, block=False):
        y = self.mm(x, layer.weight.t(), block)
        return y if layer.bias is None else y + layer.bias


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class BN(nn.Module):
    """BatchNorm over points with a mask; ``norm`` names the affine and the
    running statistics as the program's do."""

    def __init__(self, c):
        super().__init__()
        self.norm = nn.BatchNorm1d(c)

    def forward(self, x, mask=None):
        n = self.norm
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if mask is None:
                mean = x.mean(dims)
                var = ((x - mean) ** 2).mean(dims)
            else:
                m = mask.float()[..., None]
                cnt = torch.clamp_min(m.sum(), 1.0)
                mean = (x * m).sum(dims) / cnt
                var = (((x - mean) ** 2) * m).sum(dims) / cnt
        else:
            mean, var = n.running_mean, n.running_var
        y = (x - mean) * torch.rsqrt(var + _EPS) * n.weight + n.bias
        return y if mask is None else torch.where(mask[..., None], y, 0.0)


def _gather_rows(x, idx):
    """x (B, N, C) rows at idx (B, M, k) -> (B, M, k, C)."""
    B, M, k = idx.shape
    flat = idx.reshape(B, M * k, 1).long().expand(B, M * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, M, k, x.shape[-1])


def packed(coord):
    """The coordinates as the port hands them to its attention: hi + lo,
    each rounded to bfloat16, summed in float32."""
    hi = coord.to(torch.bfloat16)
    return hi.float() + (coord - hi.float()).to(torch.bfloat16).float()


def _take(x, order):
    if x.dim() == 3:
        return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[2]))
    return torch.gather(x, 1, order)


class Attention(nn.Module):
    def __init__(self, C, G, prec):
        super().__init__()
        self.C, self.G, self.prec = C, G, prec
        self.linear_q = nn.Sequential(nn.Linear(C, C), BN(C), nn.ReLU())
        self.linear_k = nn.Sequential(nn.Linear(C, C), BN(C), nn.ReLU())
        self.linear_v = nn.Linear(C, C)
        self.linear_p_bias = nn.Sequential(nn.Linear(3, C), BN(C), nn.ReLU(),
                                           nn.Linear(C, C))
        self.weight_encoding = nn.Sequential(nn.Linear(C, G), BN(G),
                                             nn.ReLU(), nn.Linear(G, G))

    def forward(self, feat, coord, idx, valid, mask):
        P, C, G = self.prec, self.C, self.G
        q = torch.relu(self.linear_q[1](P.linear(self.linear_q[0], feat, True),
                                        mask))
        k = torch.relu(self.linear_k[1](P.linear(self.linear_k[0], feat, True),
                                        mask))
        v = P.linear(self.linear_v, feat, True)
        vm = valid[..., None]
        kv = torch.where(vm, _gather_rows(torch.cat([k, v], -1), idx), 0.0)
        k_g, v_g = kv[..., :C], kv[..., C:]
        pos = torch.where(vm, _gather_rows(coord, idx) - coord[:, :, None], 0.0)
        B, N, S = idx.shape
        slots = mask[:, :, None].expand(B, N, S)  # every slot of a valid query
        pe = self.linear_p_bias
        h = torch.relu(pe[1](P.linear(pe[0], pos, True), slots))
        peb = P.linear(pe[3], h, True)
        r = k_g - q[:, :, None] + peb
        v2 = v_g + peb
        we = self.weight_encoding
        w = torch.relu(we[1](P.linear(we[0], r, True), slots))
        w = P.linear(we[3], w, True)
        w = torch.where(vm, torch.softmax(w, dim=2), 0.0)
        out = (v2.reshape(B, N, S, G, C // G) * w[..., None]).sum(2)
        return torch.where(mask[..., None], out.reshape(B, N, C), 0.0)


class Block(nn.Module):
    def __init__(self, C, G, rate, prec):
        super().__init__()
        self.prec, self.rate = prec, rate
        self.attn = Attention(C, G, prec)
        self.fc1 = nn.Linear(C, C, bias=False)
        self.fc3 = nn.Linear(C, C, bias=False)
        self.norm1, self.norm2, self.norm3 = BN(C), BN(C), BN(C)

    def forward(self, feat, coord, idx, valid, mask, keep):
        """``keep``: the (B, 1, 1) stochastic-depth factor (1, 0 or
        1 / keep rate), drawn by the caller."""
        P = self.prec
        h = torch.relu(self.norm1(P.linear(self.fc1, feat, True), mask))
        h = self.attn(h, coord, idx, valid, mask)
        h = torch.relu(self.norm2(h, mask))
        h = self.norm3(P.linear(self.fc3, h, True), mask)
        h = torch.relu(feat + h * keep)
        return torch.where(mask[..., None], h, 0.0)


class Stage(nn.Module):
    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(self, name, m)


class Blocks(nn.Module):
    """A stage's blocks over one resolution's graph."""

    def __init__(self, depth, C, G, k, rates, prec):
        super().__init__()
        self.C, self.k = C, k
        self.blocks = nn.ModuleList(Block(C, G, r, prec) for r in rates)

    def graph(self, coord, mask, on_card):
        """The resolution's graph: (slab geometry or None, order, coord and
        mask in graph order, idx, valid)."""
        N = coord.shape[1]
        slab = _slab_geometry(self.C, N) if on_card else None
        if slab is not None:
            order = torch.argsort(knn_ref.morton_code(coord, mask), dim=1,
                                  stable=True)
            c, m = _take(coord, order), _take(mask, order)
            idx, _, valid = knn_ref.knn_self_presorted(
                c, m, k=self.k, tile_q=slab["tile_q"], window=slab["window"],
                front=slab["front"])
            return dict(slab=slab, order=order, coord=c, mask=m, idx=idx,
                        valid=valid)
        if N <= _SMALL_N:
            idx, _, valid = knn_ref.knn_self_spatial(coord, mask, k=self.k,
                                                     probes=1,
                                                     exact_dist=False)
        else:
            idx, _, valid = knn_ref.knn_self_spatial(coord, mask, k=self.k,
                                                     exact_dist=False)
        return dict(slab=None, order=None, coord=coord, mask=mask, idx=idx,
                    valid=valid)

    def forward(self, feat, coord, mask, cache, on_card, keeps, remat):
        slab = _slab_geometry(self.C, coord.shape[1]) if on_card else None
        if cache is None or cache["slab"] != slab or cache["idx"].shape[-1] != self.k:
            cache = self.graph(coord, mask, on_card)
        order = cache["order"]
        if order is not None:
            feat = _take(feat, order)
        for blk in self.blocks:
            keep = next(keeps) if blk.rate > 0 and self.training else None
            args = (feat, packed(cache["coord"]), cache["idx"], cache["valid"],
                    cache["mask"],
                    feat.new_ones(()) if keep is None else keep)
            if remat:
                feat = torch.utils.checkpoint.checkpoint(
                    blk, *args, use_reentrant=False)
            else:
                feat = blk(*args)
        if order is not None:
            feat = _take(feat, torch.argsort(order, dim=1))
        return feat, cache


def _slab_geometry(C, N):
    """The program's slab geometry on the card at its defaults (half-window
    256 rows): tile rows TQ by width, the kNN window inside every slab."""
    if C > 384 or N < 2048:
        return None
    TQ = 128 if C <= 96 else (64 if C <= 192 else 32)
    J = 2 * max(_SLAB_W // TQ, 1) + 1
    W = (J - 1) // 2 * TQ
    tile_q = 128 if TQ >= 64 else 64
    window = 2 * W + 2 * TQ - tile_q
    return dict(TQ=TQ, J=J, W=W, tile_q=tile_q, window=window,
                front=W - tile_q + TQ)


def grid_pool(coord, feat, mask, grid_size, M):
    """Mean coordinates and max features of the voxels of ``grid_size``
    (clusters in ascending voxel-key order, past capacity M merged into the
    last): (coord, feat, mask, cluster map (B, N))."""
    B, N, C = feat.shape
    with torch.no_grad():
        start = torch.where(mask[..., None], coord, _BIG).amin(dim=1)
        d = torch.floor((coord - start[:, None]) / grid_size).to(torch.int64)
        d = torch.where(mask[..., None], d, 0)
        ext = d.amax(dim=1) + 1
        key = (d[..., 0] * ext[:, None, 1] + d[..., 1]) * ext[:, None, 2] + d[..., 2]
        key = torch.where(mask, key, _INT32_MAX)
        ks, order = torch.sort(key, dim=1, stable=True)
        ms = torch.gather(mask, 1, order)
        new = torch.ones_like(ms)
        new[:, 1:] = ks[:, 1:] != ks[:, :-1]
        new &= ms
        cid = torch.cumsum(new.to(torch.int64), dim=1) - 1
        cluster = torch.empty_like(cid).scatter_(1, order, cid)
        cluster = torch.clamp_max(cluster, M - 1)
        cluster = torch.where(mask, cluster, M - 1)
        seg = (torch.where(mask, cluster, M)
               + torch.arange(B, device=coord.device)[:, None] * (M + 1))
        seg = seg.reshape(-1)
    counts = torch.zeros(B * (M + 1), device=coord.device)
    counts.index_add_(0, seg, mask.reshape(-1).float())
    csum = torch.zeros((B * (M + 1), 3), device=coord.device)
    csum.index_add_(0, seg, torch.where(mask[..., None], coord, 0.0).reshape(-1, 3))
    pf = torch.full((B * (M + 1), C), -_BIG, device=feat.device)
    pf = pf.scatter_reduce(0, seg[:, None].expand(-1, C),
                           torch.where(mask[..., None], feat, -_BIG).reshape(-1, C),
                           reduce="amax", include_self=True)
    counts = counts.reshape(B, M + 1)[:, :M]
    pc = csum.reshape(B, M + 1, 3)[:, :M] / torch.clamp_min(counts[..., None], 1.0)
    pm = counts > 0
    pf = torch.where(pm[..., None], pf.reshape(B, M + 1, C)[:, :M], 0.0)
    return torch.where(pm[..., None], pc, 0.0), pf, pm, cluster


def _exact_knn(q, kc, k, qmask, kmask):
    """Exact kNN over the whole score matrix, ties to the lower key index."""
    pen = torch.where(kmask, 0.0, _BIG)
    a, b, c = kc[..., 0], kc[..., 1], kc[..., 2]
    k2 = a * a
    k2 = (b.double() * b.double() + k2.double()).float()
    k2 = (c.double() * c.double() + k2.double()).float() + pen
    s = k2[:, None, :] - 2.0 * torch.bmm(q, kc.transpose(1, 2))
    s, order = torch.sort(s, dim=-1, stable=True)
    d2, idx = s[..., :k], order[..., :k]
    valid = (d2 < _BIG / 2) & qmask[:, :, None]
    sel = _gather_rows(kc, idx)
    dist = torch.sqrt(((sel - q[:, :, None, :]) ** 2).sum(-1))
    return (torch.where(valid, idx, 0), torch.where(valid, dist, 0.0), valid)


def interpolation(src_coord, dst_coord, src_feat, src_mask, dst_mask, k=3):
    with torch.no_grad():
        if src_coord.shape[1] * dst_coord.shape[1] > _EXACT_PAIR_BUDGET:
            idx, dist, valid = knn_ref.knn_cross_spatial(
                dst_coord, src_coord, k, dst_mask, src_mask, tile_q=512,
                window=512, probes=2)
        else:
            idx, dist, valid = _exact_knn(dst_coord, src_coord, k, dst_mask,
                                          src_mask)
        w = torch.where(valid, 1.0 / (dist + 1e-8), 0.0)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    neigh = torch.where(valid[..., None], _gather_rows(src_feat, idx), 0.0)
    out = (neigh * w[..., None]).sum(2)
    return torch.where(dst_mask[..., None], out, 0.0)


class ReferencePTv2(nn.Module):
    """PT-v2m2 of a config's ``model.backbone`` keys (the ones the published
    model has), in float32."""

    def __init__(self, backbone, lowp=None, on_card=True):
        super().__init__()
        b = dict(backbone)
        self.prec = prec = Precision(lowp)
        self.on_card = on_card
        self.remat = True
        self.num_classes = b["num_classes"]
        self.unpool = b.get("unpool_backend", "map")
        self.grid_sizes = tuple(b["grid_sizes"])
        self.ratios = tuple(b.get("stage_cap_ratios", (0.35,) * len(self.grid_sizes)))
        enc_depths, dec_depths = b["enc_depths"], b["dec_depths"]
        dp = b.get("drop_path_rate", 0.0)

        def linspace(total, n):
            return [float(total)] * n if n <= 1 else [
                total * i / (n - 1) for i in range(n)]

        enc_dp = linspace(dp, sum(enc_depths))
        dec_dp = linspace(dp, sum(dec_depths))
        pc = b["patch_embed_channels"]
        enc_ch = (pc,) + tuple(b["enc_channels"])
        dec_ch = tuple(b["dec_channels"]) + (enc_ch[-1],)
        self.patch_embed = Stage(
            proj=nn.Sequential(nn.Linear(b["in_channels"], pc, bias=False),
                               BN(pc), nn.ReLU()),
            blocks=Blocks(b["patch_embed_depth"], pc, b["patch_embed_groups"],
                          b["patch_embed_neighbours"],
                          [0.0] * b["patch_embed_depth"], prec))
        self.enc_stages, self.dec_stages = nn.ModuleList(), nn.ModuleList()
        for i in range(len(enc_depths)):
            e0, e1 = sum(enc_depths[:i]), sum(enc_depths[:i + 1])
            d0, d1 = sum(dec_depths[:i]), sum(dec_depths[:i + 1])
            self.enc_stages.append(Stage(
                down=Stage(fc=nn.Linear(enc_ch[i], enc_ch[i + 1], bias=False),
                           norm=BN(enc_ch[i + 1])),
                blocks=Blocks(enc_depths[i], enc_ch[i + 1], b["enc_groups"][i],
                              b["enc_neighbours"][i], enc_dp[e0:e1], prec)))
            self.dec_stages.append(Stage(
                up=Stage(proj=nn.Sequential(nn.Linear(dec_ch[i + 1], dec_ch[i]),
                                            BN(dec_ch[i]), nn.ReLU()),
                         proj_skip=nn.Sequential(nn.Linear(enc_ch[i], dec_ch[i]),
                                                 BN(dec_ch[i]), nn.ReLU())),
                blocks=Blocks(dec_depths[i], dec_ch[i], b["dec_groups"][i],
                              b["dec_neighbours"][i], dec_dp[d0:d1], prec)))
        self.seg_head = nn.Sequential(nn.Linear(dec_ch[0], dec_ch[0]),
                                      BN(dec_ch[0]), nn.ReLU(),
                                      nn.Linear(dec_ch[0], self.num_classes))

    def capacities(self, n):
        caps = [n]
        for r in self.ratios[:len(self.enc_stages)]:
            caps.append(max(int(caps[-1] * r), 64))
        return caps

    def forward(self, coord, feat, mask, keeps=iter(())):
        """Logits (B, N, classes). ``keeps`` yields the stochastic-depth
        factors in the order the blocks run (train mode)."""
        P, card = self.prec, self.on_card
        remat = self.remat and self.training and torch.is_grad_enabled()
        coord = coord.float()
        caps = self.capacities(coord.shape[1])
        pe = self.patch_embed
        h = torch.relu(pe.proj[1](P.linear(pe.proj[0], feat.float()), mask))
        h, cache = pe.blocks(h, coord, mask, None, card, keeps, remat)
        skips = [(coord, h, mask, cache)]
        clusters = []
        for i, st in enumerate(self.enc_stages):
            d = st.down
            h = torch.relu(d.norm(P.linear(d.fc, h), mask))
            coord, h, mask, cluster = grid_pool(coord, h, mask,
                                                self.grid_sizes[i], caps[i + 1])
            h, cache = st.blocks(h, coord, mask, None, card, keeps, remat)
            clusters.append(cluster)
            skips.append((coord, h, mask, cache))
        coord, h, mask, _ = skips.pop()
        for i in reversed(range(len(self.dec_stages))):
            s_coord, s_feat, s_mask, s_cache = skips.pop()
            up = self.dec_stages[i].up
            h = torch.relu(up.proj[1](P.linear(up.proj[0], h), mask))
            cluster = clusters.pop()
            if self.unpool == "map":
                u = torch.gather(h, 1, cluster[..., None].expand(-1, -1, h.shape[-1]))
                u = torch.where(s_mask[..., None], u, 0.0)
            else:
                u = interpolation(coord, s_coord, h, mask, s_mask)
            s = torch.relu(up.proj_skip[1](P.linear(up.proj_skip[0], s_feat),
                                           s_mask))
            h = torch.where(s_mask[..., None], u + s, 0.0)
            coord, mask = s_coord, s_mask
            h, _ = self.dec_stages[i].blocks(h, coord, mask, s_cache, card,
                                             keeps, remat)
        g = torch.relu(self.seg_head[1](P.linear(self.seg_head[0], h), mask))
        return P.linear(self.seg_head[3], g)


def load_program_state(ref, state):
    """Load a state dict in the program's names (``backbone.`` prefix, as
    the segmentor wraps it) into the reference; returns the reference."""
    own = {}
    for k, v in state.items():
        k = k[len("backbone."):] if k.startswith("backbone.") else k
        own[k] = v
    missing, unexpected = ref.load_state_dict(own, strict=False)
    # the running statistics keep their initial values where not given
    missing = [m for m in missing if not m.endswith(
        ("num_batches_tracked", "running_mean", "running_var"))]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the reference: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    return ref


def drop_keeps(generator, blocks_rates, batch, device):
    """The stochastic-depth factors of one train forward, drawn as the
    program draws them: one uniform (B, 1, 1) a block of rate > 0, in the
    order the blocks run, keep where u < 1 - rate, scaled by 1 / (1 - rate)."""
    for rate in blocks_rates:
        keep = 1.0 - rate
        u = torch.rand((batch, 1, 1), generator=generator, device=device)
        yield torch.where(u < keep, 1.0 / keep, 0.0)


def block_rates(ref):
    """The rates > 0 of the reference's blocks in the order a forward runs
    them: patch embed, encoder stages, decoder stages from the deepest."""
    seq = [b.rate for b in ref.patch_embed.blocks.blocks]
    for st in ref.enc_stages:
        seq += [b.rate for b in st.blocks.blocks]
    for i in reversed(range(len(ref.dec_stages))):
        seq += [b.rate for b in ref.dec_stages[i].blocks.blocks]
    return [r for r in seq if r > 0]


def cross_entropy(logits, target, mask, ignore=-1):
    v = (target != ignore) & mask
    t = torch.where(v, target, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, t[..., None])[..., 0]
    return torch.where(v, nll, 0.0).sum() / torch.clamp_min(v.float().sum(), 1.0)


def lr_schedule(scheduler, base_lr, total_steps):
    """lr of each step k (0-based) of the config's schedule: MultiStepLR
    (base lr times gamma per milestone passed) or a cosine one-cycle warm-up
    from max_lr / div_factor to max_lr over pct_start of the steps, then a
    cosine fall to max_lr / div_factor / final_div_factor."""
    kind = scheduler["type"]
    if kind == "MultiStepLR":
        bounds = sorted({int(r * total_steps) for r in scheduler["milestones"]})
        g = scheduler.get("gamma", 0.1)
        return lambda k: base_lr * g ** sum(b <= k for b in bounds)
    if kind == "OneCycleLR":
        mx = scheduler["max_lr"]
        lo = mx / scheduler.get("div_factor", 25.0)
        end = lo / scheduler.get("final_div_factor", 1e4)
        up = scheduler.get("pct_start", 0.3) * total_steps

        def lr(k):
            if k <= up:
                return lo + (mx - lo) * (1 - math.cos(math.pi * k / up)) / 2
            f = (k - up) / max(total_steps - up, 1)
            return end + (mx - end) * (1 + math.cos(math.pi * f)) / 2
        return lr
    raise ValueError(f"no reference schedule for {kind!r}")
