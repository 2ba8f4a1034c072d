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
    [(128, 640, 16), (128, 512, 16), (64, 512, 16), (512, 640, 3)],
)
def test_knn_window_plain_matches_pallas(tile_q, window, k):
    """Identical ids on tie-free inputs and d2 within 1e-5 relative, at the
    (tile_q, window) pairs of the S3DIS path: self graph (128, 640) /
    (128, 512) / (64, 512), unpool cross search (512, 512 + 128)."""
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


def _port_out(c):
    bf = torch.bfloat16
    c6 = tgva.pack_coords(torch.from_numpy(c["coord"]))
    src = torch.cat([torch.from_numpy(c["k"]).to(bf),
                     torch.from_numpy(c["v"]).to(bf), c6], -1)
    qrow = torch.cat([torch.from_numpy(c["q"]).to(bf),
                      tgva.pack_coords(torch.from_numpy(c["qcoord"])),
                      torch.from_numpy(c["qmask"])[..., None].to(bf)], -1)
    fp = tgva.folded_params({n: torch.from_numpy(a) for n, a in c["p"].items()})
    out = tgva.gva_eval(src, qrow, torch.from_numpy(c["idx"]),
                        torch.from_numpy(c["valid"]), fp)
    assert tgva.gva_eval.launches == 0
    return out.numpy()


def _assert_close(got, ref):
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) < 5e-3 * scale


@pytest.mark.parametrize("C,G,N", [(48, 6, 300), (96, 12, 300), (192, 24, 160)])
def test_gva_eval_plain_matches_slab_kernel(C, G, N):
    """K3a: sorted-slab call mode against gva_slab_core_eval, at the slab
    tilings of the S3DIS stages (C=192 at a narrowed N)."""
    TQ = 128 if C <= 96 else 64
    J = 2 * (256 // TQ) + 1
    c = _gva_case(C, G, N, TQ, J, seed=C)
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
    ref = gs.gva_slab_core_eval(
        kv_pad, jnp.asarray(c["idx"] + c["W"], jnp.int32), qrow,
        jnp.asarray(c["valid"]).astype(bf), Wp1, bp1, gp, bp, Wp2, bp2, wp,
        rp, rw, c["Np"], 16, C, G, TQ, J, interpret=True,
    )
    _assert_close(_port_out(c), np.asarray(ref))


@pytest.mark.parametrize("C,G,N", [(48, 6, 256), (96, 12, 192), (192, 24, 96)])
def test_gva_eval_plain_matches_gathered_kernel(C, G, N):
    """K3b: gathered-rows call mode against gva_core_eval."""
    TQ = 128 if C <= 48 else (64 if C <= 96 else 32)
    c = _gva_case(C, G, N, TQ, J=3, seed=C + 1)
    bf = jnp.bfloat16
    c6, qrow = _jax_rows(c)
    src = jnp.concatenate([jnp.asarray(c["k"]).astype(bf),
                           jnp.asarray(c["v"]).astype(bf), c6], axis=-1)
    B, Np, S = c["idx"].shape
    kvp = jnp.take_along_axis(
        src, jnp.asarray(c["idx"].reshape(B, Np * S))[..., None], axis=1)
    (Wp1, bp1, gp, bp, Wp2, bp2, wp), rp, rw = _jax_params(c)
    ref = gf.gva_core_eval(
        kvp, qrow, jnp.asarray(c["valid"]).astype(bf), Wp1, bp1, gp, bp, Wp2,
        bp2, wp, rp, rw, S, C, G, TQ, interpret=True,
    )
    _assert_close(_port_out(c), np.asarray(ref))
