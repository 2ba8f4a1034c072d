"""Operations and bytes of PT-v2m2, counted from a batch's stage shapes.

A batch's stage sizes come from its own coordinates: the benchmark pools
them itself (voxels of each grid size in turn over the previous stage's
mean coordinates, as the configuration's grid pooling defines them, each
stage capped at its static capacity). Every count is of the valid points
and of the neighbour slots of valid points; padding is not counted.

* ``forward_flops``: the model's multiply-adds (x2) over all its matrix
  products and the attention's per-neighbour products of one forward; a
  train step counts three forwards (recomputation is not counted).
* ``kernel_bounds``: per port kernel (K1 ``knn_window``, K3 ``gva_eval``,
  K6 ``gva_bwd``), the operations at each data-sheet rate and the bytes
  (each input read once, each output written once) of a forward or a train
  step, for its roofline share.
"""

from __future__ import annotations

import torch

_BIG = 1e30
_INT32_MAX = 2**31 - 1


def capacities(n, ratios, stages):
    caps = [n]
    for r in tuple(ratios)[:stages]:
        caps.append(max(int(caps[-1] * r), 64))
    return caps


@torch.no_grad()
def stage_sizes(coord, mask, backbone):
    """Valid points of each resolution of each row, [(B,) int64 tensor per
    stage], for coord (B, N, 3) and mask (B, N) on any device."""
    grids = tuple(backbone["grid_sizes"])
    caps = capacities(coord.shape[1], backbone.get("stage_cap_ratios",
                                                   (0.35,) * len(grids)),
                      len(grids))
    coord, mask = coord.float(), mask.bool()
    sizes = [mask.sum(1)]
    B = coord.shape[0]
    for g, M in zip(grids, caps[1:]):
        start = torch.where(mask[..., None], coord, _BIG).amin(dim=1)
        d = torch.floor((coord - start[:, None]) / g).to(torch.int64)
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
        cluster = torch.empty_like(cid).scatter_(1, order, cid).clamp_max(M - 1)
        seg = (torch.where(mask, cluster, M)
               + torch.arange(B, device=coord.device)[:, None] * (M + 1)).reshape(-1)
        cnt = torch.zeros(B * (M + 1), device=coord.device)
        cnt.index_add_(0, seg, mask.reshape(-1).float())
        csum = torch.zeros((B * (M + 1), 3), device=coord.device)
        csum.index_add_(0, seg, torch.where(mask[..., None], coord, 0.0).reshape(-1, 3))
        cnt = cnt.reshape(B, M + 1)[:, :M]
        coord = csum.reshape(B, M + 1, 3)[:, :M] / torch.clamp_min(cnt[..., None], 1.0)
        mask = cnt > 0
        sizes.append(mask.sum(1))
    return sizes


def forward_shape(batch, mask, backbone, device):
    """((B, N), [valid points of each resolution summed over the rows]) of
    one forward's batch: its coordinates (or a dict holding them under
    "coord") and its mask."""
    coord = batch["coord"] if isinstance(batch, dict) else batch
    sizes = stage_sizes(coord.to(device), mask.to(device), backbone)
    return tuple(mask.shape), [int(s.sum()) for s in sizes]


def _widths(b):
    enc = (b["patch_embed_channels"],) + tuple(b["enc_channels"])
    dec = tuple(b["dec_channels"]) + (enc[-1],)
    return enc, dec


def blocks(b):
    """[(resolution, C, G, S, count)] of every attention block of a
    forward: the patch embed's, each encoder stage's and each decoder
    stage's."""
    enc, dec = _widths(b)
    out = [(0, enc[0], b["patch_embed_groups"], b["patch_embed_neighbours"],
            b["patch_embed_depth"])]
    for i, d in enumerate(b["enc_depths"]):
        out.append((i + 1, enc[i + 1], b["enc_groups"][i],
                    b["enc_neighbours"][i], d))
    for i, d in enumerate(b["dec_depths"]):
        out.append((i, dec[i], b["dec_groups"][i], b["dec_neighbours"][i], d))
    return out


def _block_flops(C, G, S):
    """Multiply-adds x2 of one block per valid point: fc1, fc3, q, k, v
    (C x C each), and per neighbour slot the position MLP (3 x C, C x C),
    the weight encoding (C x G, G x G) and the weighted sum of values."""
    return 10 * C * C + S * (2 * 3 * C + 2 * C * C + 2 * C * G + 2 * G * G
                             + 2 * C)


def forward_flops(b, n):
    """FLOPs of one forward over valid points n[r] of each resolution r
    (summed over the batch's rows)."""
    enc, dec = _widths(b)
    K = b["num_classes"]
    f = 2 * b["in_channels"] * enc[0] * n[0]
    for r, C, G, S, count in blocks(b):
        f += count * n[r] * _block_flops(C, G, S)
    for i in range(len(b["enc_depths"])):
        f += 2 * enc[i] * enc[i + 1] * n[i]  # grid pool's fc
        # unpool: proj on the coarse points, proj_skip on the fine, and
        # the three-neighbour blend where it interpolates
        f += 2 * dec[i + 1] * dec[i] * n[i + 1] + 2 * enc[i] * dec[i] * n[i]
        if b.get("unpool_backend", "map") == "interp":
            f += 2 * 3 * dec[i] * n[i]
    f += (2 * dec[0] * dec[0] + 2 * dec[0] * K) * n[0]
    return float(f)


def _gva_rows_bytes(B, N, C, S):
    """Bytes of a GVA kernel's row inputs: source rows [k | v | coord6] and
    query rows [q | coord6 | mask] in bf16, ids (int32) and validity."""
    return B * N * ((2 * C + 6) * 2 + (C + 7) * 2 + S * 5)


def kernel_bounds(b, shape, n, train):
    """{kernel: (bf16 ops, f32 ops, bytes)} of one forward (``train``:
    one train step) at a batch of (B, N) padded rows, n[r] valid points of
    resolution r. K3 and K6 run every block on the fused path; K1 runs
    every graph search and unpooling probe of the window search."""
    B, N = shape
    caps = capacities(N, b.get("stage_cap_ratios", (0.35,) * len(b["grid_sizes"])),
                      len(b["grid_sizes"]))
    out = {"gva_eval": [0.0, 0.0, 0.0], "gva_bwd": [0.0, 0.0, 0.0],
           "knn_window": [0.0, 0.0, 0.0]}
    for r, C, G, S, count in blocks(b):
        edges = float(n[r]) * S
        rows = _gva_rows_bytes(B, caps[r], C, S)
        params = 4 * (3 * C + C * C + 2 * C * G + G * G + 6 * C + 4 * G)
        ev = out["gva_eval"]
        ev[0] += count * edges * (2 * 3 * C + 2 * C * C + 2 * C * G)
        ev[1] += count * edges * (2 * G * G + 8 * C + 6 * G)
        ev[2] += count * (rows + params + B * caps[r] * C * 4)
        if train:
            bw = out["gva_bwd"]
            bw[0] += count * edges * (2 * 3 * C + 6 * C * C + 6 * C * G
                                      + 12 * C * (1 + G))
            bw[1] += count * edges * (6 * G * G + 36 * C)
            bw[2] += count * (rows + params + B * caps[r] * C * 2
                              + B * caps[r] * (2 * C + 1 + G) * 4
                              + B * caps[r] * (C + 1 + G) * 4)
    kn = out["knn_window"]
    for Bq, Nqp, Nk, window, k in knn_calls(b, B, caps):
        kn[1] += 8.0 * Bq * Nqp * window
        kn[2] += Bq * (Nk * 20 + Nqp * 12 + Nqp * k * 8)
    return {name: tuple(v) for name, v in out.items()}


def _slab(C, N):
    if C > 384 or N < 2048:
        return None
    TQ = 128 if C <= 96 else (64 if C <= 192 else 32)
    W = max(256 // TQ, 1) * TQ  # the program's default half-window
    tile_q = 128 if TQ >= 64 else 64
    return tile_q, 2 * W + 2 * TQ - tile_q, W - tile_q + TQ


def knn_calls(b, B, caps):
    """(B, query rows, key rows, window, k) of every window search of a
    forward: each resolution's graph (a decoder stage whose neighbour count
    differs searches again), and each interpolating unpooling's two probes."""
    enc, dec = _widths(b)
    calls = []

    def graph(C, N, k):
        s = _slab(C, N)
        if s is not None:
            tile_q, window, front = s
            nqp = -(-N // tile_q) * tile_q
            calls.append((B, nqp, front + window + nqp, window, k))
            return
        tile_q = min(256, N)
        window = max(min(1024, N), tile_q)
        probes = 1 if N <= 1152 else 3
        nkp = -(-N // 128) * 128
        for _ in range(probes):
            calls.append((B, -(-N // tile_q) * tile_q, nkp,
                          min(window + 128, N), k))

    ks = [b["patch_embed_neighbours"]] + list(b["enc_neighbours"])
    for r, C in enumerate(enc):
        graph(C, caps[r], ks[r])
    for i, k in enumerate(b["dec_neighbours"]):
        if k != ks[i]:
            graph(dec[i], caps[i], k)
        if (b.get("unpool_backend", "map") == "interp"
                and caps[i] * caps[i + 1] > 2_000_000):
            nq, nk = caps[i], caps[i + 1]
            tile_q = min(512, nq)
            window = max(min(512, nk), min(tile_q, nk))
            for _ in range(2):
                calls.append((B, -(-nq // tile_q) * tile_q, -(-nk // 128) * 128,
                              min(window + 128, nk), 3))
    return calls


def bound_seconds(ops_bf16, ops_f32, nbytes, peaks):
    """The least time of a kernel: the larger of its operations at the
    data-sheet rates and its bytes at the memory rate."""
    t_ops = ops_bf16 / peaks["bf16_flop_per_s"] + ops_f32 / peaks["f32_flop_per_s"]
    return max(t_ops, nbytes / peaks["hbm_bytes_per_s"])

