"""The port's kernels K1-K3, plain PyTorch versions, against the TPU
kernels run in Pallas interpret mode on the same numpy inputs.

On the CPU every wrapper of ao_tpu_torch runs its kernel's plain version
(the CUDA kernels themselves are held against the same plain versions on
the card by chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.ops.pallas import gva_fused as gf
from ao_tpu.ops.pallas import gva_slab as gs
from ao_tpu.ops.pallas.knn_window import knn_window_pallas
from ao_tpu.ops.pallas.merge_topk import merge_topk_dedup
from ao_tpu_torch.ops import gva as tgva
from ao_tpu_torch.ops import knn_spatial as tks

_BIG = 1e30


# ---------------------------------------------------------------- K1


@pytest.mark.parametrize(
    "tile_q,window,k",
    [(128, 640, 16), (128, 512, 16), (64, 512, 16), (512, 640, 3),
     (128, 640, 8)],
)
def test_knn_window_plain_matches_pallas(tile_q, window, k):
    """Identical ids on tie-free inputs and d2 within 1e-5 relative, at the
    (tile_q, window) pairs of the S3DIS path: self graph (128, 640) /
    (128, 512) / (64, 512), unpool cross search (512, 512 + 128); and the
    ScanNet patch embed's k = 8 self graph at (128, 640)."""
    rng = np.random.default_rng(tile_q + window + k)
    B, T = 2, 2
    Nk, Nqp = window + 384, T * tile_q
    keys = rng.uniform(-3, 3, (B, Nk, 3)).astype(np.float32)
    pen = np.where(rng.random((B, Nk)) < 0.05, _BIG, 0.0).astype(np.float32)
    k2 = (keys**2).sum(-1) + pen
    order = np.stack([rng.permutation(Nk) for _ in range(B)]).astype(np.int32)
    queries = rng.uniform(-3, 3, (B, Nqp, 3)).astype(np.float32)
    ws = (rng.integers(0, (Nk - window) // 128 + 1, (B, T)) * 128).astype(np.int32)

    jd2, jidx = knn_window_pallas(
        jnp.asarray(keys), jnp.asarray(k2), jnp.asarray(order),
        jnp.asarray(queries), jnp.asarray(ws), k, tile_q, window,
        interpret=True,
    )
    td2, tidx = tks.knn_window(
        *(torch.from_numpy(a) for a in (keys, k2, order, queries, ws)),
        k, tile_q, window,
    )
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jd2 = np.asarray(jd2)
    assert np.all(np.abs(td2.numpy() - jd2) <= 1e-5 * np.maximum(np.abs(jd2), 1.0))
    assert tks.knn_window.launches == 0  # CPU tensors: the plain version


def _lattice_case(kind, tile_q, window, k, seed):
    """K1 inputs on a 0.25 lattice (every score exact in f32 in both
    frameworks, so ties between valid keys are exact): ``ties`` with 5% of
    the keys invalid; ``few_valid`` with 99% invalid, so windows hold fewer
    than k valid keys; ``all_invalid`` with the second tile's window made
    wholly invalid and its queries zero (a tile of pad queries)."""
    rng = np.random.default_rng(seed)
    B, T = 2, 2
    Nk, Nqp = window + 384, T * tile_q
    keys = (rng.integers(0, 12, (B, Nk, 3)) * 0.25).astype(np.float32)
    pen = rng.random((B, Nk)) < {"ties": 0.05, "few_valid": 0.99,
                                 "all_invalid": 0.05}[kind]
    queries = (rng.integers(0, 12, (B, Nqp, 3)) * 0.25).astype(np.float32)
    ws = (rng.integers(0, (Nk - window) // 128 + 1, (B, T)) * 128).astype(np.int32)
    if kind == "all_invalid":
        ws[:, 1] = Nk - window
        pen[:, Nk - window:] = True
        ws[:, 0] = 0
        pen[:, :Nk - window] = False
        queries[:, tile_q:] = 0.0
    k2 = ((keys ** 2).sum(-1) + np.where(pen, _BIG, 0.0)).astype(np.float32)
    order = np.stack([rng.permutation(Nk) for _ in range(B)]).astype(np.int32)
    return keys, k2, order, queries, ws, pen


@pytest.mark.parametrize("kind", ["ties", "few_valid", "all_invalid"])
@pytest.mark.parametrize(
    "tile_q,window,k",
    [(128, 640, 16), (64, 512, 16), (512, 640, 3), (128, 640, 8)])
def test_knn_window_plain_matches_pallas_ties_and_invalid_keys(
        kind, tile_q, window, k):
    """The semantics K1 keeps on the card: bit-identical scores against the
    TPU kernel; identical ids at every slot of a valid key, exact ties
    included (both take the lowest window column); at the slots past a
    window's valid keys (score 1e30) the port emits the window's invalid
    keys in column order, each once. (The TPU kernel masks a taken column
    to the same 1e30 and repeats the window's first column there; both
    graphs drop those slots in ``_finalize``.)"""
    keys, k2, order, queries, ws, pen = _lattice_case(
        kind, tile_q, window, k, seed=tile_q + window + k)
    jd2, jidx = knn_window_pallas(
        jnp.asarray(keys), jnp.asarray(k2), jnp.asarray(order),
        jnp.asarray(queries), jnp.asarray(ws), k, tile_q, window,
        interpret=True,
    )
    td2, tidx = tks.knn_window(
        *(torch.from_numpy(a) for a in (keys, k2, order, queries, ws)),
        k, tile_q, window,
    )
    assert tks.knn_window.launches == 0
    jd2, jidx, td2, tidx = (np.asarray(jd2), np.asarray(jidx), td2.numpy(),
                            tidx.numpy())
    np.testing.assert_array_equal(td2.view(np.int32), jd2.view(np.int32))
    live = td2 < _BIG / 2
    np.testing.assert_array_equal(tidx[live], jidx[live])
    B, Nqp = queries.shape[:2]
    n_dead = 0
    for b in range(B):
        for t in range(Nqp // tile_q):
            cols = np.arange(ws[b, t], ws[b, t] + window)
            inv = order[b, cols[pen[b, cols]]]
            for qi in range(t * tile_q, (t + 1) * tile_q):
                dead = ~live[b, qi]
                n_dead += int(dead.sum())
                np.testing.assert_array_equal(tidx[b, qi, dead],
                                              inv[:int(dead.sum())])
    if kind != "ties":
        assert n_dead > 0
    if kind == "all_invalid":
        assert not live[:, tile_q:].any()


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("probes,k", [(2, 3), (3, 16)])
def test_merge_topk_plain_matches_pallas_bitwise(probes, k):
    """Widths 6 (k=3, the unpool merge) and 48 (k=16, the 3-probe self
    merge), with planted duplicates, exact ties, zero (self) scores,
    missing candidates and rows with fewer than k distinct ids: identical
    ids and bit-identical scores."""
    rng = np.random.default_rng(probes * 100 + k)
    B, N, W = 2, 300, probes * k
    d2 = rng.uniform(0, 4, (B, N, W)).astype(np.float32)
    idx = rng.integers(0, 50, (B, N, W)).astype(np.int32)
    # duplicates across probes with nearby scores
    dup = rng.random((B, N, W)) < 0.3
    src_col = rng.integers(0, W, (B, N, W))
    idx = np.where(dup, np.take_along_axis(idx, src_col, -1), idx)
    d2 = np.where(dup, np.take_along_axis(d2, src_col, -1) * 1.0000001, d2)
    # exact ties between different ids
    tie = rng.random((B, N, W)) < 0.1
    d2 = np.where(tie, np.take_along_axis(d2, src_col, -1), d2).astype(np.float32)
    d2[:, :, 0] = np.where(rng.random((B, N)) < 0.5, 0.0, d2[:, :, 0])
    d2 = np.where(rng.random((B, N, W)) < 0.1, _BIG, d2).astype(np.float32)
    idx[:, :5] = 7  # rows holding a single distinct id
    jd2, jidx = merge_topk_dedup(jnp.asarray(d2), jnp.asarray(idx), k,
                                 interpret=True)
    td2, tidx = tks.merge_topk(torch.from_numpy(d2), torch.from_numpy(idx), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        td2.numpy().view(np.int32), np.asarray(jd2).view(np.int32)
    )
    assert tks.merge_topk.launches == 0


def _old_probe_tail(s, idx, q2, order):
    """The multi-probe tail as the port computed it before K2 took it in:
    d2 = s + |q|^2 (1e30 where s is), ids clamped at 0, and a gather back
    to query order by the argsort of the probe's query order."""
    Nq = order.shape[1]
    d2 = (s + q2[:, :, None])[:, :Nq]
    idx = idx[:, :Nq].clamp_min(0)
    d2 = torch.where(s[:, :Nq] > _BIG / 2, _BIG, d2)
    inv = torch.argsort(order, dim=1)
    return (torch.gather(d2, 1, inv[..., None].expand(-1, -1, d2.shape[2])),
            torch.gather(idx, 1, inv[..., None].expand(-1, -1, idx.shape[2])))


@pytest.mark.parametrize("probes,k", [(2, 3), (3, 16)])
def test_merge_topk_probes_plain_matches_old_tail_and_merge(probes, k):
    """The fused K2's plain version against the old per-probe tail, their
    concatenation and merge_topk_plain, bit for bit: duplicate ids across
    probes at one query, queries with fewer than k valid candidates
    (1e30 scores with negative ids, as the window search pads them),
    masked pad queries, and sorted pad rows past Nq holding NaN, which no
    output may read."""
    rng = np.random.default_rng(probes * 10 + k)
    B, Nq, tile_q = 2, 700, 256
    Nqp = -(-Nq // tile_q) * tile_q
    base_ids = rng.integers(0, 400, (B, Nq, k))
    s_list, i_list, q_list, o_list, inv_list = [], [], [], [], []
    for p in range(probes):
        ids = rng.integers(0, 400, (B, Nq, k))
        # a third of every query's candidates are its probe 0 candidates
        share = rng.random((B, Nq, k)) < 0.35
        ids = np.where(share, base_ids, ids) if p else base_ids
        q = rng.uniform(0, 9, (B, Nq)).astype(np.float32)
        s = np.sort(rng.uniform(-q[..., None], 1.0, (B, Nq, k)), -1)
        s = s.astype(np.float32)
        # fewer than k valid candidates: the tail of the row missing
        n_valid = rng.integers(0, k + 1, (B, Nq))
        missing = np.arange(k) >= np.where(rng.random((B, Nq)) < 0.2,
                                           n_valid, k)[..., None]
        s = np.where(missing, np.float32(_BIG), s)
        ids = np.where(missing, -rng.integers(1, 5, (B, Nq, k)), ids)
        ids[:, -40:] = rng.integers(0, 400, (B, 40, k))  # masked pad queries
        order = np.stack([rng.permutation(Nq) for _ in range(B)])
        # to the probe's sorted query order, with NaN pad rows past Nq
        s_sorted = np.full((B, Nqp, k), np.nan, np.float32)
        i_sorted = np.full((B, Nqp, k), 2**31 - 1, np.int32)
        q_sorted = np.full((B, Nqp), np.nan, np.float32)
        for b in range(B):
            s_sorted[b, :Nq] = s[b, order[b]]
            i_sorted[b, :Nq] = ids[b, order[b]]
            q_sorted[b, :Nq] = q[b, order[b]]
        order_t = torch.from_numpy(order)
        s_list.append(torch.from_numpy(s_sorted))
        i_list.append(torch.from_numpy(i_sorted))
        q_list.append(torch.from_numpy(q_sorted))
        o_list.append(order_t)
        inv_list.append(tks._inverse_permutation(order_t))
    old = [_old_probe_tail(*a) for a in zip(s_list, i_list, q_list, o_list)]
    rd2, ridx = tks.merge_topk_plain(torch.cat([o[0] for o in old], -1),
                                     torch.cat([o[1] for o in old], -1), k)
    tks.merge_topk_probes.launches = 0
    for fn in (tks.merge_topk_probes_plain, tks.merge_topk_probes):
        d2, idx = fn(s_list, i_list, q_list, inv_list, k)
        assert d2.shape == (B, Nq, k) and idx.shape == (B, Nq, k)
        np.testing.assert_array_equal(idx.numpy(), ridx.numpy())
        np.testing.assert_array_equal(d2.numpy().view(np.int32),
                                      rd2.numpy().view(np.int32))
    assert tks.merge_topk_probes.launches == 0
    # the cases occurred: no NaN pad row read, rows short of k distinct
    # ids, and most queries with an id in two probes
    assert np.isfinite(rd2.numpy()).all() and (rd2.numpy() >= _BIG / 2).any()
    dup = (old[1][1][..., :, None] == old[0][1][..., None, :]).any(-1).any(-1)
    assert float(dup.float().mean()) > 0.5


# ---------------------------------------------------------------- K3


def _gva_case(C, G, N, TQ, J, seed, S=16, B=1):
    rng = np.random.default_rng(seed)
    W = (J - 1) // 2 * TQ
    Np = -(-N // TQ) * TQ
    k = (rng.normal(size=(B, N, C)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(B, N, C)) * 0.5).astype(np.float32)
    coord = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    q = (rng.normal(size=(B, Np, C)) * 0.5).astype(np.float32)
    qcoord = rng.uniform(0, 4, (B, Np, 3)).astype(np.float32)
    idx = np.zeros((B, Np, S), np.int32)
    for i in range(Np):  # every edge in-slab
        t = i // TQ
        lo, hi = max(t * TQ - W, 0), min(t * TQ + TQ + W, N)
        idx[:, i] = rng.integers(lo, hi, (B, S))
    valid = rng.random((B, Np, S)) < 0.9
    valid[:, N:] = False
    qmask = np.ones((B, Np), bool)
    qmask[:, N:] = False
    qmask[:, 3] = False  # a padded query row among valid ones
    p = dict(
        Wp1=rng.normal(size=(3, C)) * 0.3, bp1=rng.normal(size=C) * 0.1,
        gp=rng.uniform(0.8, 1.2, C), bp=rng.normal(size=C) * 0.05,
        pe_mean=rng.normal(size=C) * 0.1, pe_var=rng.uniform(0.5, 1.5, C),
        Wp2=rng.normal(size=(C, C)) * (1.0 / np.sqrt(C)),
        bp2=rng.normal(size=C) * 0.1,
        W1=rng.normal(size=(C, G)) * (1.0 / np.sqrt(C)),
        b1=rng.normal(size=G) * 0.1, gw=rng.uniform(0.8, 1.2, G),
        bw=rng.normal(size=G) * 0.05, we_mean=rng.normal(size=G) * 0.1,
        we_var=rng.uniform(0.5, 1.5, G),
        W2=rng.normal(size=(G, G)) * 0.4, b2=rng.normal(size=G) * 0.1,
    )
    p = {n: a.astype(np.float32) for n, a in p.items()}
    return dict(k=k, v=v, coord=coord, q=q, qcoord=qcoord, idx=idx,
                valid=valid, qmask=qmask, p=p, W=W, Np=Np)


def _jax_rows(c):
    bf = jnp.bfloat16
    c6 = gf.pack_coords(jnp.asarray(c["coord"]))
    qrow = jnp.concatenate(
        [jnp.asarray(c["q"]).astype(bf), gf.pack_coords(jnp.asarray(c["qcoord"])),
         jnp.asarray(c["qmask"])[..., None].astype(bf)], axis=-1)
    return c6, qrow


def _jax_params(c):
    p = {n: jnp.asarray(a) for n, a in c["p"].items()}
    wp = (p["W1"], p["b1"], p["gw"], p["bw"], p["W2"], p["b2"])
    return ((p["Wp1"], p["bp1"], p["gp"], p["bp"], p["Wp2"], p["bp2"], wp),
            (p["pe_mean"], p["pe_var"]), (p["we_mean"], p["we_var"]))


def _port_out(c, nq=None):
    """The port's K3 on the case's rows; with ``nq``, on its first nq
    queries only."""
    bf = torch.bfloat16
    nq = c["Np"] if nq is None else nq
    c6 = tgva.pack_coords(torch.from_numpy(c["coord"]))
    src = torch.cat([torch.from_numpy(c["k"]).to(bf),
                     torch.from_numpy(c["v"]).to(bf), c6], -1)
    qrow = torch.cat([torch.from_numpy(c["q"]).to(bf),
                      tgva.pack_coords(torch.from_numpy(c["qcoord"])),
                      torch.from_numpy(c["qmask"])[..., None].to(bf)], -1)
    fp = tgva.folded_params({n: torch.from_numpy(a) for n, a in c["p"].items()})
    out = tgva.gva_eval(src, qrow[:, :nq], torch.from_numpy(c["idx"][:, :nq]),
                        torch.from_numpy(c["valid"][:, :nq]), fp)
    assert tgva.gva_eval.launches == 0
    return out.numpy()


def _assert_close(got, ref):
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) < 5e-3 * scale


def _slab_tiling(C):
    """(TQ, J) of the slab kernel at width C (the S3DIS stages' tiling)."""
    TQ = 128 if C <= 96 else 64
    return TQ, 2 * (256 // TQ) + 1


def _gathered_tq(C):
    return 128 if C <= 48 else (64 if C <= 96 else 32)


def _slab_ref(c, C, G, N, TQ, J):
    """gva_slab_core_eval (Pallas, interpret mode) on the case's rows."""
    bf = jnp.bfloat16
    c6, qrow = _jax_rows(c)
    lay = gs.lane_layout(C)
    k, v = jnp.asarray(c["k"]).astype(bf), jnp.asarray(c["v"]).astype(bf)
    if lay["split"]:
        zk = jnp.zeros(k.shape[:-1] + (lay["KW"] - C - 6,), bf)
        zv = jnp.zeros(k.shape[:-1] + (lay["row_w"] - lay["KW"] - C,), bf)
        parts = [k, c6, zk, v, zv]
    else:
        parts = [k, v, c6]
    src = jnp.concatenate([x for x in parts if x.shape[-1]], axis=-1)
    kv_pad = gs.pad_for_slab(src, N, TQ, J)
    (Wp1, bp1, gp, bp, Wp2, bp2, wp), rp, rw = _jax_params(c)
    return np.asarray(gs.gva_slab_core_eval(
        kv_pad, jnp.asarray(c["idx"] + c["W"], jnp.int32), qrow,
        jnp.asarray(c["valid"]).astype(bf), Wp1, bp1, gp, bp, Wp2, bp2, wp,
        rp, rw, c["Np"], c["idx"].shape[-1], C, G, TQ, J, interpret=True,
    ))


def _gathered_ref(c, C, G, TQ):
    """gva_core_eval (Pallas, interpret mode) on the case's gathered rows."""
    bf = jnp.bfloat16
    c6, qrow = _jax_rows(c)
    src = jnp.concatenate([jnp.asarray(c["k"]).astype(bf),
                           jnp.asarray(c["v"]).astype(bf), c6], axis=-1)
    B, Np, S = c["idx"].shape
    kvp = jnp.take_along_axis(
        src, jnp.asarray(c["idx"].reshape(B, Np * S))[..., None], axis=1)
    (Wp1, bp1, gp, bp, Wp2, bp2, wp), rp, rw = _jax_params(c)
    return np.asarray(gf.gva_core_eval(
        kvp, qrow, jnp.asarray(c["valid"]).astype(bf), Wp1, bp1, gp, bp, Wp2,
        bp2, wp, rp, rw, S, C, G, TQ, interpret=True,
    ))


@pytest.mark.parametrize("C,G,N,S", [
    pytest.param(48, 6, 300, 16, id="48-6-300"),
    pytest.param(96, 12, 300, 16, id="96-12-300"),
    pytest.param(192, 24, 160, 16, id="192-24-160"),
    pytest.param(384, 48, 96, 16, id="384-48-96"),
    pytest.param(48, 6, 300, 8, id="48-6-300-S8")])
def test_gva_eval_plain_matches_slab_kernel(C, G, N, S):
    """K3a: sorted-slab call mode against gva_slab_core_eval, at the slab
    tilings of the S3DIS stages (C=192 and 384 at a narrowed N), and with
    the ScanNet patch embed's S = 8 neighbours."""
    TQ, J = _slab_tiling(C)
    c = _gva_case(C, G, N, TQ, J, seed=C, S=S)
    _assert_close(_port_out(c), _slab_ref(c, C, G, N, TQ, J))


@pytest.mark.parametrize("C,G,N,S", [
    pytest.param(48, 6, 256, 16, id="48-6-256"),
    pytest.param(96, 12, 192, 16, id="96-12-192"),
    pytest.param(192, 24, 96, 16, id="192-24-96"),
    pytest.param(384, 48, 64, 16, id="384-48-64"),
    pytest.param(48, 6, 256, 8, id="48-6-256-S8"),
    pytest.param(512, 64, 48, 16, id="512-64-48")])
def test_gva_eval_plain_matches_gathered_kernel(C, G, N, S):
    """K3b: gathered-rows call mode against gva_core_eval (C=384: the small
    batch's gathered deepest stage; S=8: the ScanNet patch embed's
    neighbours; C=512: the ScanNet config's deepest stage, G=64)."""
    TQ = _gathered_tq(C)
    c = _gva_case(C, G, N, TQ, J=3, seed=C + 1, S=S)
    _assert_close(_port_out(c), _gathered_ref(c, C, G, TQ))


@pytest.mark.parametrize("mode", ["slab", "gathered"])
def test_gva_eval_plain_ragged_queries_and_empty_slots(mode):
    """The port on Nq = 299 queries (not a multiple of the card kernel's 8
    or 4 queries per tile, so its last tile is ragged), one of them (row 5,
    a valid query) with every slot invalid, against the TPU kernel on the
    same rows padded to its tiling: the first 299 rows agree in the 5e-3
    band, and the empty query's output is 0 (its softmax has no slot)."""
    C, G, N, nq = 96, 12, 300, 299
    if mode == "slab":
        TQ, J = _slab_tiling(C)
    else:
        TQ, J = _gathered_tq(C), 3
    c = _gva_case(C, G, N, TQ, J, seed=7)
    c["valid"][:, 5] = False
    assert c["qmask"][:, 5].all()
    ref = (_slab_ref(c, C, G, N, TQ, J) if mode == "slab"
           else _gathered_ref(c, C, G, TQ))
    got = _port_out(c, nq)
    assert got.shape == (1, nq, C)
    _assert_close(got, ref[:, :nq])
    assert np.all(got[:, 5] == 0.0)
    assert np.all(np.abs(ref[:, 5]) < 1e-6)


@pytest.mark.parametrize("C,G", [(64, 8), (48, 12), (768, 96)])
def test_gva_eval_raises_outside_its_instances(C, G):
    """Off the CPU the K3 wrapper takes only the kernel's instances
    (C in 48, 96, 192, 384, 512 with G = C / 8): other widths raise before any
    device work, never falling back to the plain version. Tensors on the
    meta device stand for the card's here."""
    B, N, S = 1, 32, 16
    meta = torch.device("meta")
    src = torch.empty((B, N, 2 * C + 6), dtype=torch.bfloat16, device=meta)
    qrow = torch.empty((B, N, C + 7), dtype=torch.bfloat16, device=meta)
    idx = torch.empty((B, N, S), dtype=torch.int32, device=meta)
    valid = torch.empty((B, N, S), dtype=torch.bool, device=meta)
    fp = dict(A=torch.empty((3, C), device=meta), W2=torch.empty((G, G), device=meta))
    with pytest.raises(ValueError, match="instances"):
        tgva.gva_eval(src, qrow, idx, valid, fp)
    assert tgva.gva_eval.launches == 0
