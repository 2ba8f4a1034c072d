"""Graph, pooling and collation ops of ao_tpu_torch against ao_tpu on the
same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.ops.knn_spatial as jks
from ao_tpu.datasets.collate import collate_fn as jcollate
from ao_tpu.ops import grid_pool as jgrid_pool
from ao_tpu.ops import interpolation as jinterp
from ao_tpu.ops.pallas.merge_topk import merge_topk_dedup
from ao_tpu_torch.datasets.collate import collate_fn as tcollate
from ao_tpu_torch.ops import grid_pool as tgrid_pool
from ao_tpu_torch.ops import interpolation as tinterp
from ao_tpu_torch.ops import knn_spatial as tks

T = torch.from_numpy


def _assert_same_graph(ti, td, ji, jd):
    """Identical neighbour ids except at distance near-ties (the score
    |k|^2 - 2 q.k rounds differently in the two matmuls): a differing slot
    must hold the same squared distance within 1e-4 and be rare."""
    ti, td, ji, jd = ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd)
    diff = ti != ji
    assert diff.mean() < 1e-3
    assert np.all(np.abs(td[diff] ** 2 - jd[diff] ** 2) <= 1e-4)


def _room(rng, B, N, n_valid):
    coord = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    coord[..., 2] *= 0.5
    mask = np.zeros((B, N), bool)
    for b, nv in enumerate(n_valid):
        mask[b, :nv] = True
    return coord, mask


@pytest.mark.parametrize("tile_q,window,front", [(128, 640, 256), (64, 512, 224)])
def test_knn_self_presorted_matches_jax(tile_q, window, front):
    rng = np.random.default_rng(window)
    coord, mask = _room(rng, 2, 2000, (2000, 1700))
    code = np.asarray(jks.morton_code(jnp.asarray(coord), jnp.asarray(mask)))
    order = np.argsort(code, axis=1, kind="stable")
    coord = np.take_along_axis(coord, order[..., None], 1)
    mask = np.take_along_axis(mask, order, 1)
    ji, jd, jv = jks.knn_self_presorted(
        jnp.asarray(coord), jnp.asarray(mask), k=16, tile_q=tile_q,
        window=window, front=front)
    ti, td, tv = tks.knn_self_presorted(
        T(coord), T(mask), k=16, tile_q=tile_q, window=window, front=front)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _assert_same_graph(ti, td, ji, jd)
    # exact_dist=False: distances are sqrt(|k|^2 - 2 q.k + |q|^2), whose
    # rounding noise is absolute on the squared scale (coords up to 4)
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, atol=1e-4)


def test_knn_cross_spatial_matches_jax_with_pallas_merge(monkeypatch):
    """The unpool search (k=3, tile_q=512, window=512, 2 probes) as the
    card and the TPU run it: the JAX side merges its probes with the
    Pallas kernel (interpret mode), the port side with K2's plain version,
    so both sides merge with the same contract."""
    rng = np.random.default_rng(3)
    key, kmask = _room(rng, 2, 1400, (1400, 1100))
    query, qmask = _room(rng, 2, 3000, (3000, 2500))

    def pallas_merge(d2s, idxs, k):
        return merge_topk_dedup(jnp.concatenate(d2s, -1),
                                jnp.concatenate(idxs, -1), k, interpret=True)

    def k2_merge(d2s, idxs, k):
        return tks.merge_topk(torch.cat(d2s, -1), torch.cat(idxs, -1), k)

    monkeypatch.setattr(jks, "_merge_probes", pallas_merge)
    monkeypatch.setattr(tks, "_merge_probes", k2_merge)
    # traced afresh: these shapes are this test's own, so the patched merge
    # is the one the trace sees
    ji, jd, jv = jks.knn_cross_spatial(
        jnp.asarray(query), jnp.asarray(key), 3, jnp.asarray(qmask),
        jnp.asarray(kmask), tile_q=512, window=512, probes=2)
    ti, td, tv = tks.knn_cross_spatial(
        T(query), T(key), 3, T(qmask), T(kmask), tile_q=512, window=512,
        probes=2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_grid_pool_and_unpool_map_match_jax():
    rng = np.random.default_rng(1)
    coord, mask = _room(rng, 2, 1500, (1500, 1200))
    feat = rng.normal(size=(2, 1500, 8)).astype(np.float32)
    jout = jgrid_pool(jnp.asarray(coord), jnp.asarray(feat), jnp.asarray(mask),
                      0.4, 400)
    tout = tgrid_pool(T(coord), T(feat), T(mask), 0.4, 400)
    jc, jf, jm, jcl, jn = (np.asarray(x) for x in jout)
    tc, tf, tm, tcl, tn = (x.numpy() for x in tout)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tcl, jcl)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-6)
    from ao_tpu.ops import unpool_map as junpool
    from ao_tpu_torch.ops import unpool_map as tunpool

    np.testing.assert_array_equal(
        tunpool(T(tf), T(tcl), T(mask)).numpy(),
        np.asarray(junpool(jnp.asarray(jf), jnp.asarray(jcl), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("n_src,n_dst", [(300, 1200), (1100, 2600)])
def test_interpolation_matches_jax(n_src, n_dst):
    """Below 2M pairs the exact kNN, above it the 2-probe curve search."""
    rng = np.random.default_rng(n_src)
    src, smask = _room(rng, 2, n_src, (n_src, n_src - 50))
    dst, dmask = _room(rng, 2, n_dst, (n_dst, n_dst - 200))
    feat = rng.normal(size=(2, n_src, 8)).astype(np.float32)
    j = jinterp(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(feat),
                jnp.asarray(smask), jnp.asarray(dmask))
    t = tinterp(T(src), T(dst), T(feat), T(smask), T(dmask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_collate_fn_matches_jax():
    rng = np.random.default_rng(2)
    batch = [
        dict(coord=rng.normal(size=(n, 3)).astype(np.float32),
             feat=rng.normal(size=(n, 6)).astype(np.float32),
             segment=rng.integers(0, 13, n), name=f"s{n}")
        for n in (70, 130)
    ]
    j = jcollate(batch, pad_multiple=64)
    t = tcollate(batch, pad_multiple=64)
    assert set(t) == set(j)
    for key in ("coord", "feat", "segment", "mask"):
        assert t[key].dtype == getattr(torch, str(j[key].dtype)) or key == "mask"
        np.testing.assert_array_equal(t[key].numpy(), j[key])
    assert t["extras"] == j["extras"]


def test_s3dis_test_transforms_match_jax():
    """The S3DIS test pipeline (base transform, a TTA view, GridSample test
    fragments, post transform) gives identical fragments in both packages;
    GridSample train mode keeps exactly one point of every voxel."""
    from ao_tpu.datasets.transform import Compose as JCompose
    from ao_tpu_torch.datasets.transform import Compose as TCompose
    from ao_tpu_torch.datasets.transform import GridSample

    rng = np.random.default_rng(4)
    n = 3000
    scene = dict(coord=rng.uniform(0, 2, (n, 3)).astype(np.float32),
                 color=rng.uniform(0, 255, (n, 3)).astype(np.float32))
    base = [dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor"),
            dict(type="Copy", keys_dict={"coord": "origin_coord"})]
    view = [dict(type="RandomScale", scale=[1.05, 1.05], anisotropic=True),
            dict(type="RandomFlip", p=1)]
    vox = [dict(type="GridSample", grid_size=0.04, hash_type="fnv",
                mode="test", keys=("coord", "color"),
                return_discrete_coord=True)]
    post = [dict(type="CenterShift", apply_z=False), dict(type="ToTensor"),
            dict(type="Collect", keys=("coord", "discrete_coord", "index"),
                 feat_keys=("coord", "color"))]
    frags = []
    for compose in (JCompose, TCompose):
        d = compose(view)(compose(base)({k: v.copy() for k, v in scene.items()}))
        frags.append([compose(post)(f) for f in compose(vox)(d)])
    assert len(frags[0]) == len(frags[1]) > 1
    for jf, tf in zip(*frags):
        assert set(jf) == set(tf)
        for key in jf:
            np.testing.assert_array_equal(tf[key], jf[key])

    d = TCompose(base)({k: v.copy() for k, v in scene.items()})
    disc = np.floor(d["coord"] / 0.04).astype(int)
    sampled = GridSample(grid_size=0.04, mode="train", keys=("coord", "color"),
                         return_discrete_coord=True,
                         generator=torch.Generator().manual_seed(0))(d)
    kept = sampled["discrete_coord"]
    assert len(np.unique(kept, axis=0)) == len(kept) == len(
        np.unique(disc, axis=0))
