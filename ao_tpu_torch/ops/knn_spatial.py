"""Space-filling-curve window kNN (port of ao_tpu/ops/knn_spatial.py).

Points are sorted along a Morton (Z-order) curve; each tile of
``tile_q`` curve-sorted queries searches one contiguous window of
curve-sorted keys. Multi-probe search repeats this on grids shifted by
irrational fractions of the scene extent and merges the probes with
duplicate suppression. ``knn_self_presorted`` is the window-RESTRICTED
graph of the slab path: tile t searches exactly rows
``[t*tile_q - front, t*tile_q - front + window)`` of the sorted array.

This module carries two kernels (CUDA sources under ``csrc/``):

* K1 ``knn_window`` -- the per-tile windowed k-smallest search;
* K2 ``merge_topk`` -- the probe merge with duplicate suppression; on
  the card a multi-probe search hands its probes' raw outputs to
  ``merge_topk_probes``, the same kernel with every probe's tail (|q|^2,
  the missing mask, the gather back to query order) folded into its loads.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in ``<wrapper>.launches``; for CPU tensors it runs the plain PyTorch
version beside it, which computes the same function.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _native

_BIG = 1e30
_FLT_MIN = 1.1754943508222875e-38  # smallest normal float32
_INT32_MAX = 2**31 - 1
# Irrational-ish origin shifts (fractions of scene extent) per probe.
_PROBE_SHIFTS = (0.0, 0.331, 0.613, 0.459)


# ---------------------------------------------------------------------------
# K1: windowed k-smallest search
# ---------------------------------------------------------------------------


def knn_window_plain(keys_sorted, k2, order, queries_sorted, window_starts,
                     k, tile_q, window):
    """Plain PyTorch K1. For tile t of batch b, score the ``window`` keys
    from ``window_starts[b, t]`` (clamped into range) as |k|^2 - 2 q.k and
    return the k smallest ascending (ties: lowest window column) with the
    ORIGINAL id ``order`` of each: (d2 (B, Nqp, k), idx (B, Nqp, k))."""
    B, Nk, _ = keys_sorted.shape
    Nqp = queries_sorted.shape[1]
    T = Nqp // tile_q
    start = window_starts.long().clamp(0, Nk - window)
    cols = start[..., None] + torch.arange(window, device=start.device)
    flat = cols.reshape(B, T * window)
    wk = torch.gather(keys_sorted, 1, flat[..., None].expand(B, T * window, 3))
    wk2 = torch.gather(k2, 1, flat).reshape(B, T, 1, window)
    wo = torch.gather(order, 1, flat).reshape(B, T, window)
    qt = queries_sorted.reshape(B, T, tile_q, 3)
    s = wk2 - 2.0 * torch.matmul(qt, wk.reshape(B, T, window, 3).transpose(-1, -2))
    s, pos = torch.sort(s, dim=-1, stable=True)
    kk = min(k, window)
    d2, pos = s[..., :kk], pos[..., :kk]
    idx = torch.gather(wo[:, :, None, :].expand(B, T, tile_q, window), 3, pos)
    if kk < k:
        d2 = torch.cat([d2, d2.new_full(d2.shape[:-1] + (k - kk,), _BIG)], -1)
        idx = torch.cat(
            [idx, wo[:, :, None, :1].expand(B, T, tile_q, k - kk)], -1
        )
    return d2.reshape(B, Nqp, k), idx.reshape(B, Nqp, k).to(torch.int32)


# the neighbour counts K1 is built for: the self graphs (16; 8 for the
# ScanNet config's patch embed) and the unpool search (3)
KNN_WINDOW_K = (3, 8, 16)


def knn_window(keys_sorted, k2, order, queries_sorted, window_starts, k,
               tile_q, window):
    """K1 (replaces ops/pallas/knn_window.py:knn_window_pallas).

    keys_sorted (B, Nk, 3) f32, k2 (B, Nk) f32 (|k|^2 + invalid penalty),
    order (B, Nk) int32 original ids, queries_sorted (B, Nqp, 3) f32 with
    Nqp a multiple of tile_q, window_starts (B, Nqp // tile_q) int32.
    Returns (d2 scores, ORIGINAL key ids), each (B, Nqp, k)."""
    if keys_sorted.device.type == "cpu":
        return knn_window_plain(keys_sorted, k2, order, queries_sorted,
                                window_starts, k, tile_q, window)
    B, Nk, _ = keys_sorted.shape
    Nqp = queries_sorted.shape[1]
    if not (k in KNN_WINDOW_K and k <= window <= Nk and Nqp % tile_q == 0):
        raise ValueError(
            f"knn_window: k={k} tile_q={tile_q} window={window} Nk={Nk} "
            f"Nqp={Nqp} out of the kernel's range"
        )
    keys_sorted = keys_sorted.float().contiguous()
    k2 = k2.float().contiguous()
    order = order.to(torch.int32).contiguous()
    queries_sorted = queries_sorted.float().contiguous()
    window_starts = window_starts.to(torch.int32).contiguous()
    _native.require_cuda("knn_window", keys_sorted, k2, order,
                         queries_sorted, window_starts)
    d2 = torch.empty((B, Nqp, k), dtype=torch.float32, device=k2.device)
    idx = torch.empty((B, Nqp, k), dtype=torch.int32, device=k2.device)
    err = _native.lib().knn_window_launch(
        keys_sorted.data_ptr(), k2.data_ptr(), order.data_ptr(),
        queries_sorted.data_ptr(), window_starts.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), B, Nk, Nqp, Nqp // tile_q, k, tile_q, window,
        _native.stream_ptr(k2),
    )
    _native.check(err, "knn_window")
    knn_window.launches += 1
    return d2, idx


knn_window.launches = 0


# ---------------------------------------------------------------------------
# K2: probe merge with duplicate suppression
# ---------------------------------------------------------------------------


def merge_topk_plain(d2, idx, k):
    """Plain PyTorch K2, bit for bit the TPU kernel's output contract:
    scores clamp to FLT_MIN and carry their column in the 6 low mantissa
    bits; k rounds take the minimum packed value (ties: lowest column),
    emit its score with the column bits cleared and its id, and mask every
    still-active slot holding that id to 1e30."""
    width = d2.shape[-1]
    col = torch.arange(width, dtype=torch.int32, device=d2.device)
    sbits = torch.clamp_min(d2.float(), _FLT_MIN).view(torch.int32)
    packed = ((sbits & ~63) | col).view(torch.float32)
    idx = idx.to(torch.int32)
    big = torch.tensor(_BIG, dtype=torch.float32, device=d2.device)
    imax = torch.tensor(_INT32_MAX, dtype=torch.int32, device=d2.device)
    d2_cols, idx_cols = [], []
    for _ in range(k):
        m = packed.min(dim=-1).values
        mbits = m.view(torch.int32)
        am = mbits & 63
        chosen = torch.where(col == am[..., None], idx, imax).min(-1).values
        d2_cols.append((mbits & ~63).view(torch.float32))
        idx_cols.append(chosen)
        hit = (idx == chosen[..., None]) & (packed < big / 2)
        packed = torch.where(hit, big, packed)
    return torch.stack(d2_cols, -1), torch.stack(idx_cols, -1)


def merge_topk(d2, idx, k):
    """K2 (replaces ops/pallas/merge_topk.py:merge_topk_dedup).

    d2 (B, N, W) scores (1e30 = missing), idx (B, N, W) candidate ids,
    W <= 64. Returns the k best distinct candidates, (B, N, k) each."""
    if d2.shape[-1] > 64:
        raise ValueError(
            f"merge_topk packs the column into 6 mantissa bits: candidate "
            f"width {d2.shape[-1]} > 64"
        )
    if d2.device.type == "cpu":
        return merge_topk_plain(d2, idx, k)
    B, N, width = d2.shape
    d2 = d2.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    _native.require_cuda("merge_topk", d2, idx)
    out_d2 = torch.empty((B, N, k), dtype=torch.float32, device=d2.device)
    out_idx = torch.empty((B, N, k), dtype=torch.int32, device=d2.device)
    err = _native.lib().merge_topk_launch(
        d2.data_ptr(), idx.data_ptr(), out_d2.data_ptr(), out_idx.data_ptr(),
        B * N, width, k, _native.stream_ptr(d2),
    )
    _native.check(err, "merge_topk")
    merge_topk.launches += 1
    return out_d2, out_idx


merge_topk.launches = 0

# (probes, k) with a fused instance of K2: the unpool search's and the
# multi-probe self graph's
_FUSED = ((2, 3), (3, 16))


def merge_topk_probes_plain(s, idx, q2, inv, k):
    """Plain PyTorch version of the fused K2: each probe's tail
    (``_probe_tail``), their concatenation and ``merge_topk_plain``."""
    tails = [_probe_tail(*p) for p in zip(s, idx, q2, inv)]
    return merge_topk_plain(torch.cat([t[0] for t in tails], -1),
                            torch.cat([t[1] for t in tails], -1), k)


def merge_topk_probes(s, idx, q2, inv, k):
    """K2 with every probe's tail folded into its loads (replaces
    ops/pallas/merge_topk.py:merge_topk_dedup on the concatenated probes,
    and the per-probe tail ``_probe_tail`` before it).

    Per probe p (tuples of P tensors each): the window search's scores
    s[p] (B, Nqp, k) and ids idx[p] (B, Nqp, k) in that probe's sorted
    query order, |q|^2 q2[p] (B, Nqp) in the same order, and the inverse
    permutation inv[p] (B, Nq) from original query to sorted row. Returns
    the k best distinct candidates in original query order, (B, Nq, k)
    each, bit for bit ``merge_topk_probes_plain``."""
    if s[0].device.type == "cpu":
        return merge_topk_probes_plain(s, idx, q2, inv, k)
    P = len(s)
    B, Nqp = q2[0].shape
    Nq = inv[0].shape[1]
    if (P, k) not in _FUSED:
        raise ValueError(f"merge_topk_probes: no instance for {P} probes "
                         f"of k={k}")
    s = [x.float().contiguous() for x in s]
    idx = [x.to(torch.int32).contiguous() for x in idx]
    q2 = [x.float().contiguous() for x in q2]
    inv = [x.to(torch.int32).contiguous() for x in inv]
    for a, b, c, d in zip(s, idx, q2, inv):
        if (a.shape != (B, Nqp, k) or b.shape != (B, Nqp, k)
                or c.shape != (B, Nqp) or d.shape != (B, Nq)):
            raise ValueError("merge_topk_probes: probe shapes differ")
    _native.require_cuda("merge_topk_probes", *s, *idx, *q2, *inv)
    out_d2 = torch.empty((B, Nq, k), dtype=torch.float32, device=q2[0].device)
    out_idx = torch.empty((B, Nq, k), dtype=torch.int32, device=q2[0].device)

    def ptrs(ts):
        return (ctypes.c_void_p * P)(*[t.data_ptr() for t in ts])

    err = _native.lib().merge_topk_probes_launch(
        ptrs(s), ptrs(idx), ptrs(q2), ptrs(inv), out_d2.data_ptr(),
        out_idx.data_ptr(), P, k, B, Nq, Nqp, _native.stream_ptr(out_d2),
    )
    _native.check(err, "merge_topk_probes")
    merge_topk_probes.launches += 1
    return out_d2, out_idx


merge_topk_probes.launches = 0


# ---------------------------------------------------------------------------
# curve codes and probes
# ---------------------------------------------------------------------------


def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code_with_bbox(coord, mask, lo, hi, shift: float = 0.0):
    """30-bit Z-order codes on an explicit per-scene bbox, grid origin
    shifted by ``shift`` x extent. Invalid points get the max code so they
    sort last. coord (B, N, 3), mask (B, N), lo/hi (B, 3)."""
    ext = torch.clamp_min(hi - lo, 1e-6)
    lo_s = lo - shift * ext
    scale = 1023.0 / ((1.0 + shift) * ext)
    q = torch.clamp((coord - lo_s[:, None, :]) * scale[:, None, :], 0, 1023)
    q = q.to(torch.int32)
    code = (_part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1)
            | (_part1by2(q[..., 2]) << 2))
    return torch.where(mask, code, _INT32_MAX)


def _bbox(coord, mask):
    lo = torch.where(mask[..., None], coord, _BIG).amin(dim=1)
    hi = torch.where(mask[..., None], coord, -_BIG).amax(dim=1)
    return lo, hi


def morton_code(coord, mask, shift: float = 0.0):
    """Per-scene-bbox Z-order codes of (B, N, 3) points."""
    lo, hi = _bbox(coord, mask)
    return morton_code_with_bbox(coord, mask, lo, hi, shift)


def _take_rows(x, order):
    """Batched row gather: x (B, N, ...) by order (B, M)."""
    if x.dim() == 3:
        return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[2]))
    return torch.gather(x, 1, order)


def _pad_rows(x, before, after, value=0.0):
    """Pad dim 1 of (B, N) or (B, N, C) with ``value`` rows."""
    pad = (0, 0, before, after) if x.dim() == 3 else (before, after)
    return torch.nn.functional.pad(x, pad, value=value)


def _window_probe(query, key, qmask, kmask, k, tile_q, window, shift,
                  self_mode):
    """One curve probe (self or cross), as the window search left it in the
    probe's curve-sorted query order: (scores s (B, Nqp, k) without |q|^2,
    ORIGINAL key ids (B, Nqp, k), |q|^2 (B, Nqp), the inverse permutation
    (B, Nq) from original query to sorted row). ``_probe_tail`` turns it
    into full squared distances in original query order, on which probes
    merge."""
    B, Nq, _ = query.shape
    Nk = key.shape[1]
    Nqp = -(-Nq // tile_q) * tile_q
    # +128: the 128-alignment of window starts never shrinks coverage
    window = min(window + 128, Nk)
    lo, hi = _bbox(key, kmask)
    code_k = morton_code_with_bbox(key, kmask, lo, hi, shift)
    order_k = torch.argsort(code_k, dim=1, stable=True)
    k_sorted = _take_rows(key, order_k)
    pen = torch.where(_take_rows(kmask, order_k), 0.0, _BIG)
    # keys pad to a 128 multiple so the clip bound stays 128-aligned
    Nkp = -(-Nk // 128) * 128
    k_sorted = _pad_rows(k_sorted, 0, Nkp - Nk)
    pen = _pad_rows(pen, 0, Nkp - Nk, _BIG)
    order_k_pad = _pad_rows(order_k, 0, Nkp - Nk).to(torch.int32)
    k2 = (k_sorted * k_sorted).sum(-1) + pen

    T = Nqp // tile_q
    tiles = torch.arange(T, device=key.device)
    if self_mode:
        order_q = order_k
        q_sorted = _pad_rows(k_sorted[:, :Nq], 0, Nqp - Nq)
        starts = tiles * tile_q - (window - tile_q) // 2
        ws = starts.clamp(0, max(Nkp - window, 0))[None].expand(B, T)
    else:
        code_q = morton_code_with_bbox(query, qmask, lo, hi, shift)
        order_q = torch.argsort(code_q, dim=1, stable=True)
        q_sorted = _pad_rows(_take_rows(query, order_q), 0, Nqp - Nq)
        code_q_sorted = _take_rows(code_q, order_q)
        center_rows = torch.clamp_max(tiles * tile_q + tile_q // 2, Nq - 1)
        centers = torch.searchsorted(
            _take_rows(code_k, order_k).contiguous(),
            code_q_sorted[:, center_rows].contiguous(),
        )
        ws = (centers - window // 2).clamp(0, max(Nkp - window, 0))
    ws = ((ws // 128) * 128).to(torch.int32)

    s, idx_orig = knn_window(
        k_sorted, k2, order_k_pad, q_sorted, ws, k, tile_q, window
    )
    if self_mode:
        # queries ARE the sorted keys: |q|^2 = k2 - pen
        q2 = _pad_rows(k2[:, :Nq], 0, Nqp - Nq)
    else:
        q2 = (q_sorted * q_sorted).sum(-1)  # pad rows are 0
    return s, idx_orig, q2, _inverse_permutation(order_q)


def _inverse_permutation(order):
    """int32 ``inv`` with ``inv[b, order[b, i]] = i``, by one scatter."""
    B, N = order.shape
    inv = torch.empty((B, N), dtype=torch.int32, device=order.device)
    return inv.scatter_(1, order, torch.arange(
        N, dtype=torch.int32, device=order.device).expand(B, N))


def _probe_tail(s, idx, q2, inv):
    """One probe's window-search output (``_window_probe``) as full squared
    distances (1e30 = missing) and ids >= 0, in original query order."""
    Nq = inv.shape[1]
    d2 = (s + q2[:, :, None])[:, :Nq]
    idx = idx[:, :Nq].clamp_min(0)
    d2 = torch.where(s[:, :Nq] > _BIG / 2, _BIG, d2)
    inv = inv.long()
    return _take_rows(d2, inv), _take_rows(idx, inv)


def _merge_probes(d2s, idxs, k):
    """Merge per-probe candidates with duplicate suppression. On the card
    K2 for candidate widths <= 64; otherwise, as the TPU package does off
    the TPU, a sort by id (duplicates adjacent), masking and a selection
    of the k best."""
    d2 = torch.cat(d2s, dim=-1)
    idx = torch.cat(idxs, dim=-1)
    if d2.is_cuda and d2.shape[-1] <= 64:
        return merge_topk(d2, idx, k)
    idx_s, perm = torch.sort(idx, dim=-1, stable=True)
    d2_s = torch.gather(d2, -1, perm)
    dup = torch.cat(
        [torch.zeros_like(idx_s[..., :1], dtype=torch.bool),
         idx_s[..., 1:] == idx_s[..., :-1]], dim=-1,
    )
    d2_s = torch.where(dup, _BIG, d2_s)
    d2_s, pos = torch.sort(d2_s, dim=-1, stable=True)
    return d2_s[..., :k], torch.gather(idx_s, -1, pos[..., :k])


def _finalize(d2, idx, query_coord, key_coord, query_mask, exact_dist=True):
    valid = (d2 < _BIG / 2) & query_mask[:, :, None]
    idx = torch.where(valid, idx, 0).to(torch.int32)
    idx = torch.clamp_max(idx, key_coord.shape[1] - 1)
    if exact_dist:
        # subtract-square recompute: the score form cancels near zero
        B, Nq, k = idx.shape
        sel = _take_rows(key_coord, idx.reshape(B, Nq * k).long())
        diff = sel.reshape(B, Nq, k, 3) - query_coord[:, :, None, :]
        dist = torch.sqrt((diff * diff).sum(-1))
    else:
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    dist = torch.where(valid, dist, 0.0)
    return idx, dist, valid


def _multi_probe(query, key, qmask, kmask, k, tile_q, window, probes,
                 self_mode):
    raw = [_window_probe(query, key, qmask, kmask, k, tile_q, window,
                         _PROBE_SHIFTS[p], self_mode) for p in range(probes)]
    if probes == 1:
        return _probe_tail(*raw[0])
    if query.is_cuda and (probes, k) in _FUSED:
        return merge_topk_probes(*zip(*raw), k)
    d2s, idxs = zip(*(_probe_tail(*r) for r in raw))
    return _merge_probes(list(d2s), list(idxs), k)


def _ones_mask(x):
    return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)


@torch.no_grad()
def knn_self_spatial(coord, mask=None, k: int = 16, tile_q: int = 256,
                     window: int = 1024, probes: int = 3,
                     exact_dist: bool = True):
    """Approximate self-kNN: (idx, dist, valid), each (B, N, k), ascending
    distance, the query itself first."""
    N = coord.shape[1]
    mask = _ones_mask(coord) if mask is None else mask
    coord = coord.float()
    tile_q = min(tile_q, N)
    window = max(min(window, N), tile_q)
    d2, idx = _multi_probe(coord, coord, mask, mask, k, tile_q, window,
                           probes, self_mode=True)
    return _finalize(d2, idx, coord, coord, mask, exact_dist)


@torch.no_grad()
def knn_self_presorted(coord, mask=None, k: int = 16, tile_q: int = 128,
                       window: int = 1152, front: int = 512,
                       exact_dist: bool = False):
    """Window-RESTRICTED self-kNN on curve-sorted points (invalid last).

    Tile t's queries search exactly rows
    ``[t*tile_q - front, t*tile_q - front + window)`` of the sorted array
    (keys front-padded so starts never clamp). Returned ids index the
    sorted array; ascending distance, self first."""
    B, N, _ = coord.shape
    mask = _ones_mask(coord) if mask is None else mask
    coord = coord.float()
    if window >= N + front:
        # the window covers everything: plain exact window search
        return knn_self_spatial(coord, mask, k=k, probes=1,
                                exact_dist=exact_dist)
    Nqp = -(-N // tile_q) * tile_q
    back = window + Nqp - N  # tail pad: the last tile's window stays in range
    pen = _pad_rows(torch.where(mask, 0.0, _BIG), front, back, _BIG)
    k_sorted = _pad_rows(coord, front, back)
    k2 = (k_sorted * k_sorted).sum(-1) + pen
    # ids relative to the UNPADDED sorted array (pad rows go negative or
    # past N; their 1e30 scores mark them invalid before _finalize clips)
    order = (torch.arange(k_sorted.shape[1], dtype=torch.int32,
                          device=coord.device) - front)[None].expand(B, -1)
    q_sorted = _pad_rows(coord, 0, Nqp - N)
    T = Nqp // tile_q
    ws = (torch.arange(T, dtype=torch.int32, device=coord.device)
          * tile_q)[None].expand(B, T)
    s, idx = knn_window(k_sorted, k2, order, q_sorted, ws, k, tile_q, window)
    q2 = _pad_rows((coord * coord).sum(-1), 0, Nqp - N)
    d2 = (s + q2[:, :, None])[:, :N]
    d2 = torch.where(s[:, :N] > _BIG / 2, _BIG, d2)
    return _finalize(d2, idx[:, :N], coord, coord, mask, exact_dist)


@torch.no_grad()
def knn_cross_spatial(query_coord, key_coord, k: int, query_mask=None,
                      key_mask=None, tile_q: int = 256, window: int = 1024,
                      probes: int = 3, exact_dist: bool = True):
    """Approximate cross-cloud kNN with the knn.knn return contract."""
    Nq = query_coord.shape[1]
    Nk = key_coord.shape[1]
    query_mask = _ones_mask(query_coord) if query_mask is None else query_mask
    key_mask = _ones_mask(key_coord) if key_mask is None else key_mask
    query_coord = query_coord.float()
    key_coord = key_coord.float()
    tile_q = min(tile_q, Nq)
    window = max(min(window, Nk), min(tile_q, Nk))
    d2, idx = _multi_probe(query_coord, key_coord, query_mask, key_mask, k,
                           tile_q, window, probes, self_mode=False)
    return _finalize(d2, idx, query_coord, key_coord, query_mask, exact_dist)
