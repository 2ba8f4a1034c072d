"""The last modules of ao_tpu_torch against ao_tpu's on the same seeded
numpy inputs: PT-v2m2's AO_* kernel-path switches (the slab geometry over
a grid of stages, the fused gate, and a tiny model on the exact kNN),
ConcatDataset, GridSample's ravel hash and its min-coord / displacement
outputs, the PLY reader and writer and the visualization dumps,
ball_query and random_ball_query, the shared-memory cache with
DataCacheOperator, EventStorage with JSONWriter, RuntimeProfilerV2's
schedule on the CPU profiler, the path helpers, copy_best and
make_divisible. One intra-op thread (many small ops)."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.datasets.transform as jt
import ao_tpu.engines.hooks.misc as jhooks
import ao_tpu.models.point_transformer_v2.ptv2m2 as jm
import ao_tpu.utils.cache as jcache
import ao_tpu.utils.events as jevents
import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.datasets.builder import build_dataset as jax_build_dataset
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops.ball_query import ball_query as jax_ball_query
from ao_tpu.utils import checkpoint as jckpt
from ao_tpu.utils import misc as jmisc
from ao_tpu.utils import path as jpath
from ao_tpu.utils import ply as jply
from ao_tpu.utils import visualization as jvis
from ao_tpu_torch.datasets import build_dataset, load_scene
from ao_tpu_torch.datasets import transform as tt
from ao_tpu_torch.engines.hooks import misc as thooks
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.ops.ball_query import ball_query, random_ball_query
from ao_tpu_torch.ops.knn import knn
from ao_tpu_torch.ops.knn_spatial import knn_window_fits
from ao_tpu_torch.utils import cache as tcache
from ao_tpu_torch.utils import checkpoint as tckpt
from ao_tpu_torch.utils import events as tevents
from ao_tpu_torch.utils import misc as tmisc
from ao_tpu_torch.utils import path as tpath
from ao_tpu_torch.utils import ply as tply
from ao_tpu_torch.utils import visualization as tvis

torch.set_num_threads(1)
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
SWITCHES = ("AO_EXACT_KNN", "AO_GVA_SLAB", "AO_SLAB_W", "AO_GVA_FUSED")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------------ the switches


@pytest.mark.parametrize("slab_w", [None, "128", "256", "512", "1024"])
@pytest.mark.parametrize("gva_slab,exact", [(None, None), ("0", None),
                                             (None, "1"), ("0", "1"),
                                             ("true", None), ("false", "yes")])
def test_slab_geometry_matches_jax(monkeypatch, slab_w, gva_slab, exact):
    """_slab_geometry equals ao_tpu's dict (or None) for every stage of a
    grid of widths C (48-512), point counts N (around the 2048 gate and
    the main path's) and neighbour counts S, under each setting of
    AO_SLAB_W, AO_GVA_SLAB and AO_EXACT_KNN (unset: the defaults; a
    value other than "0" / "1" keeps the default, as in ao_tpu); ao_tpu's
    side with its backend read as "tpu", the port's on a cuda device. A
    CPU device takes the gathered path whatever the switches."""
    for name, value in (("AO_SLAB_W", slab_w), ("AO_GVA_SLAB", gva_slab),
                        ("AO_EXACT_KNN", exact)):
        if value is not None:
            monkeypatch.setenv(name, value)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    n_slab = 0
    for C in (32, 48, 96, 128, 192, 256, 384, 512):
        for N in (1000, 2047, 2048, 3512, 10035, 28672, 81920):
            for S in (8, 16):
                want = jm._slab_geometry(C, N, S)
                assert tm._slab_geometry(C, N, S, cuda) == want, (C, N, S)
                assert tm._slab_geometry(C, N, S, cpu) is None
                n_slab += want is not None
    assert (n_slab > 0) == (gva_slab != "0" and exact != "1")


@pytest.mark.parametrize("fused", [None, "0", "1", "true", "off"])
def test_fused_gate_matches_jax(monkeypatch, fused):
    """GroupedVectorAttention.fused_ok against ao_tpu's _fused_gva_ok under
    AO_GVA_FUSED (only "0" turns it off), for the PT-v2m2 attention in
    bf16 and f32 and the legacy (PT-v2m1) one, on the card's device."""
    if fused is not None:
        monkeypatch.setenv("AO_GVA_FUSED", fused)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for kw, dt, jdt in (({}, torch.bfloat16, jnp.bfloat16), ({}, None, None),
                        (dict(pe_multiplier=True), torch.bfloat16, jnp.bfloat16)):
        attn = tm.GroupedVectorAttention(16, 2, dtype=dt, **kw)
        want = jm._fused_gva_ok(kw.get("pe_multiplier", False), True, False,
                                0.0, jdt)
        assert attn.fused_ok(torch.device("cuda")) == want
        assert not attn.fused_ok(torch.device("cpu"))


def test_slab_window_beyond_k1_raises(monkeypatch):
    """An AO_SLAB_W whose window exceeds K1's shared memory raises a
    ValueError naming AO_SLAB_W and the largest value the stage takes,
    which itself fits and one block more does not; AO_SLAB_W=512's
    windows (1152 / 1024 / 1024 at tile_q 128 / 128 / 64) fit."""
    cuda = torch.device("cuda")
    monkeypatch.setenv("AO_SLAB_W", "512")
    windows = [(g["tile_q"], g["window"]) for g in (
        tm._slab_geometry(C, 81920, 16, cuda) for C in (48, 192, 384))]
    assert windows == [(128, 1152), (128, 1024), (64, 1024)]
    for C, TQ in ((48, 128), (192, 64), (384, 32)):
        monkeypatch.setenv("AO_SLAB_W", "100000")
        with pytest.raises(ValueError, match="AO_SLAB_W") as e:
            tm._slab_geometry(C, 81920, 16, cuda)
        largest = int(str(e.value).split("takes at most ")[1].split()[0])
        monkeypatch.setenv("AO_SLAB_W", str(largest))
        g = tm._slab_geometry(C, 81920, 16, cuda)
        assert knn_window_fits(16, g["tile_q"], g["window"])
        assert not knn_window_fits(16, g["tile_q"], g["window"] + 2 * TQ)
        monkeypatch.setenv("AO_SLAB_W", str(largest + 1))
        with pytest.raises(ValueError, match="AO_SLAB_W"):
            tm._slab_geometry(C, 81920, 16, cuda)


def _exact_case(n=1500, seed=3):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 3, (2, n, 3)).astype(np.float32)
    feat = np.concatenate([coord, rng.uniform(-1, 1, (2, n, 3))], -1).astype(
        np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n - 200:] = False
    return coord, feat, mask


def test_exact_knn_switch_matches_jax(monkeypatch):
    """AO_EXACT_KNN=1 on a tiny PT-v2m2 (f32) at N = 1500 > 1152 points a
    scene: every stage graph that _self_knn builds equals ao_tpu's index for
    index (the exact kNN, where without the switch the 3-probe window
    search runs), and the logits agree within 1e-4 of scale, with ao_tpu's
    weights carried by from_jax_variables (measured 1.2e-6 absolute at a
    scale of 2.3). The switch is set before ao_tpu traces, which reads it
    then; the data are arguments of ao_tpu's jitted apply (closed over,
    XLA constant-folds the kNN's sort, slowly and with other roundings of
    the pooled coordinates)."""
    monkeypatch.setenv("AO_EXACT_KNN", "1")
    cfg = _flagship_cfg(tiny=True)
    cfg["backbone"] = dict(cfg["backbone"], compute_dtype=None)
    coord, feat, mask = _exact_case()
    args = tuple(jnp.asarray(a) for a in (coord, feat, mask))
    jmodel = jax_build_model(dict(cfg))
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)
    jgraphs, tgraphs = [], []

    def record(fn, out):
        def wrapped(c, m, k):
            res = fn(c, m, k)
            out.append(res[0])
            return res
        return wrapped

    monkeypatch.setattr(jm, "_self_knn", record(jm._self_knn, jgraphs))
    monkeypatch.setattr(tm, "_self_knn", record(tm._self_knn, tgraphs))

    def apply(v, *a):
        jgraphs.clear()
        out = jmodel.apply(v, *a, True, True)
        return out, list(jgraphs)

    jout, jids = jax.jit(apply)(dict(params=var["params"],
                                     batch_stats=var["batch_stats"]), *args)
    tmodel = build_model(dict(cfg))
    tmodel.load_state_dict(convert.from_jax_variables(
        _np(var["params"]), _np(var["batch_stats"])), strict=True)
    with torch.no_grad():
        tout = tmodel.eval()(*(torch.from_numpy(a) for a in (coord, feat, mask)))
    assert len(tgraphs) == len(jids) == 3
    assert [t.shape[1] for t in tgraphs] == [1500, 750, 375]
    for t, j in zip(tgraphs, jids):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jout = np.asarray(jout, np.float32)
    err = np.abs(tout.numpy() - jout)[mask].max()
    assert err < 1e-4 * max(np.abs(jout).max(), 1.0)


# ------------------------------------------------------------ the data side


def _s3dis_root(tmp_path):
    root = tmp_path / "s3dis"
    for area, names in (("Area_1", ("a", "b")), ("Area_2", ("c",))):
        (root / area).mkdir(parents=True)
        for i, name in enumerate(names):
            room = chip_smoke.make_room(10 + i + len(area), (0.8, 0.6, 0.5), 0.08)
            np.savez(root / area / f"{name}.npz", **room)
    return str(root)


def test_concat_dataset_matches_jax(tmp_path):
    """ConcatDataset of two S3DIS areas (one with loop 2), itself looped
    twice: the (dataset, item) index map, the length, and every item
    (including the wrap past the map's end) equal ao_tpu's."""
    root = _s3dis_root(tmp_path)
    cfg = dict(type="ConcatDataset", loop=2, datasets=[
        dict(type="S3DISDataset", split="Area_1", data_root=root, loop=2,
             transform=[]),
        dict(type="S3DISDataset", split="Area_2", data_root=root,
             transform=[])])
    t, j = build_dataset(cfg), jax_build_dataset(cfg)
    assert t.data_list == j.data_list == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0)]
    assert len(t) == len(j) == 10
    for idx in range(len(t)):
        a, b = t[idx], j[idx]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{idx} {k}")
            else:
                assert a[k] == b[k]


def _grid_cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3))
    return dict(coord=rng.uniform(-1, 2, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1, keepdims=True)
                        ).astype(np.float32),
                segment=rng.integers(0, 13, n))


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("hash_type,project", [("ravel", False),
                                               ("ravel", True), ("fnv", True)])
def test_grid_sample_outputs_match_jax(monkeypatch, mode, hash_type, project):
    """GridSample with the ravel (or fnv) hash and every optional output
    (discrete_coord, min_coord, displacement, projected on the normals or
    not), in train mode with the same per-voxel draws (the port's from its
    generator, handed to ao_tpu's np.random.randint) and in test mode:
    every key of every output equal to ao_tpu's."""
    d = _grid_cloud()
    kw = dict(grid_size=0.1, hash_type=hash_type, mode=mode,
              keys=("coord", "color", "normal", "segment"),
              return_discrete_coord=True, return_min_coord=True,
              return_displacement=True, project_displacement=project)
    copy = lambda: {k: v.copy() for k, v in d.items()}  # noqa: E731
    t = tt.GridSample(generator=torch.Generator().manual_seed(4), **kw)(copy())
    if mode == "train":
        g = torch.Generator().manual_seed(4)
        monkeypatch.setattr(jt.np.random, "randint", lambda lo, hi, size: (
            torch.randint(lo, int(hi), (size,), generator=g).numpy()))
    j = jt.GridSample(**kw)(copy())
    parts_t, parts_j = (t, j) if mode == "test" else ([t], [j])
    assert len(parts_t) == len(parts_j) > 0
    for a, b in zip(parts_t, parts_j):
        assert sorted(a) == sorted(b)
        assert a["displacement"].shape[1] == (1 if project else 3)
        assert a["min_coord"].shape == (1, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ravel_hash_matches_jax():
    arr = np.random.default_rng(1).integers(-5, 40, (500, 3))
    np.testing.assert_array_equal(tt.GridSample.ravel_hash_vec(arr),
                                  jt.GridSample.ravel_hash_vec(arr))


def _ply_fields(n=37, seed=2):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(n, 3)).astype(np.float32),
             rng.integers(0, 256, (n, 3)).astype(np.uint8),
             rng.integers(-5, 5, n).astype(np.int32),
             rng.normal(size=n)],
            ["x", "y", "z", "red", "green", "blue", "label", "value"])


@pytest.mark.parametrize("faces", [False, True])
def test_ply_writer_bytes_and_round_trips(tmp_path, faces):
    """write_ply's binary file equals ao_tpu's byte for byte (with and
    without triangular faces); read_ply reads back the binary and the ascii
    file (every property, its type, the faces), and ao_tpu's reader reads
    the port's binary file alike."""
    fields, names = _ply_fields()
    tri = (np.random.default_rng(3).integers(0, 37, (11, 3)).astype(np.int32)
           if faces else None)
    tply.write_ply(str(tmp_path / "port"), fields, names, triangular_faces=tri)
    jply.write_ply(str(tmp_path / "jax"), fields, names, triangular_faces=tri)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    tply.write_ply(str(tmp_path / "ascii.ply"), fields, names,
                   triangular_faces=tri, binary=False)
    assert (tmp_path / "ascii.ply").read_bytes().startswith(
        b"ply\nformat ascii 1.0\n")
    cols = [c for f in fields for c in (f.T if f.ndim == 2 else [f])]
    for path in ("port.ply", "ascii.ply"):
        got = tply.read_ply(str(tmp_path / path), triangular_mesh=True)
        vertex, got_faces = got if faces else (got, None)
        for name, col in zip(names, cols):
            assert vertex[name].dtype == col.dtype
            np.testing.assert_array_equal(vertex[name], col, err_msg=name)
        if faces:
            np.testing.assert_array_equal(got_faces, tri)
    jgot = jply.read_ply(str(tmp_path / "port.ply"), triangular_mesh=faces)
    jvertex = jgot[0] if faces else jgot
    assert jvertex.dtype == vertex.dtype
    assert jvertex.tobytes() == tply.read_ply(str(tmp_path / "port.ply")).tobytes()


def test_visualization_dumps_match_jax(tmp_path):
    """save_point_cloud (uint8, unit-range and 0-255 float colours, none),
    save_label_cloud (ignored labels black) and save_bounding_boxes write
    ao_tpu's bytes."""
    rng = np.random.default_rng(5)
    coord = rng.normal(size=(20, 3))
    labels = rng.integers(-1, 25, 20)
    boxes = rng.uniform(0, 1, (2, 6))
    for name, color in (("u8", rng.integers(0, 256, (20, 3)).astype(np.uint8)),
                        ("unit", rng.uniform(0, 1, (20, 3))),
                        ("wide", rng.uniform(0, 300, (20, 3))), ("none", None)):
        for mod, out in ((tvis, "t"), (jvis, "j")):
            mod.save_point_cloud(coord, color, str(tmp_path / out / f"{name}.ply"))
    for mod, out in ((tvis, "t"), (jvis, "j")):
        mod.save_label_cloud(coord, labels, str(tmp_path / out / "labels.ply"))
        mod.save_bounding_boxes(boxes, str(tmp_path / out / "boxes.ply"))
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def _ball_case(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (2, 60, 3)).astype(np.float32)
    k = rng.uniform(0, 1, (2, 90, 3)).astype(np.float32)
    qm = rng.random((2, 60)) < 0.9
    km = rng.random((2, 90)) < 0.85
    return q, k, qm, km


@pytest.mark.parametrize("radii", [(0.0, 0.2), (0.05, 0.3), (0.0, 0.01)])
def test_ball_query_matches_jax(radii):
    """ball_query index for index against ao_tpu's (padded queries and
    keys; balls that hold fewer than nsample keys or none), its validity
    equal and its distances within 1e-6."""
    q, k, qm, km = _ball_case()
    ja = jax_ball_query(*(jnp.asarray(a) for a in (q, k)), 8, *radii,
                        jnp.asarray(qm), jnp.asarray(km))
    ta = ball_query(torch.from_numpy(q), torch.from_numpy(k), 8, *radii,
                    torch.from_numpy(qm), torch.from_numpy(km))
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    np.testing.assert_array_equal(ta[2].numpy(), np.asarray(ja[2]))
    assert np.abs(ta[1].numpy() - np.asarray(ja[1])).max() < 1e-6


def test_random_ball_query_invariants():
    """random_ball_query: every valid slot's key lies in the ball and among
    the candidate_factor * nsample nearest; the slots past the in-ball
    count repeat the first drawn key; a query with an in-ball key is valid
    in every slot and one without none; the same generator state gives the
    same draw, another seed another."""
    q, k, qm, km = (torch.from_numpy(a) for a in _ball_case(1))
    lo, hi, ns = 0.05, 0.25, 6

    def draw(seed):
        return random_ball_query(q, k, ns, lo, hi, qm, km,
                                 generator=torch.Generator().manual_seed(seed))

    idx, dist, valid = draw(0)
    cidx, cdist, cvalid = knn(q, k, 4 * ns, qm, km)
    in_ball = cvalid & (cdist >= lo) & (cdist < hi)
    count = in_ball.sum(-1)
    for b in range(2):
        for m in range(60):
            n = int(count[b, m])
            assert bool(valid[b, m].all()) == (n > 0) and not (
                n == 0 and valid[b, m].any())
            if n == 0:
                continue
            members = set(cidx[b, m][in_ball[b, m]].tolist())
            got = idx[b, m].tolist()
            assert set(got) <= members
            assert len(set(got)) == min(n, ns)
            if n < ns:
                assert got[n:] == [got[0]] * (ns - n)
            d = dist[b, m]
            assert bool(((d >= lo) & (d < hi)).all())
    again = draw(0)
    assert all(torch.equal(a, b) for a, b in zip((idx, dist, valid), again))
    assert not torch.equal(draw(1)[0], idx)


def test_shared_dict_and_clear_cache(tmp_path, monkeypatch):
    """shared_dict under AO_SHM_CACHE: the first caller fills an entry, a
    later one (with or without data) gets read-only memory maps of equal
    arrays, in the same directory (the SHA-1 slot) and files as ao_tpu's;
    an entry nobody filled raises KeyError; clear_cache removes them."""
    monkeypatch.setenv("AO_SHM_CACHE", str(tmp_path / "shm_t"))
    monkeypatch.setattr(jcache, "_SHM_ROOT", str(tmp_path / "shm_j"))
    data = dict(coord=np.arange(12, dtype=np.float32).reshape(4, 3),
                segment=np.array([1, 2, 3, 4]))
    t = tcache.shared_dict("ao-scene", data)
    j = jcache.shared_dict("ao-scene", data)
    assert sorted(t) == sorted(j) == ["coord", "segment"]
    for key in t:
        np.testing.assert_array_equal(t[key], j[key])
        assert isinstance(t[key], np.memmap) and not t[key].flags.writeable
    assert _tree(tmp_path / "shm_t") == _tree(tmp_path / "shm_j")
    again = tcache.shared_dict("ao-scene", dict(coord=np.zeros(1)))
    np.testing.assert_array_equal(again["coord"], data["coord"])
    with pytest.raises(KeyError):
        tcache.shared_dict("ao-missing")
    tcache.clear_cache()
    assert not (tmp_path / "shm_t").exists()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


class _Logger:
    def info(self, *a):
        pass

    warning = info


class _Trainer:
    def __init__(self, dataset=None, save_path=None):
        self.train_loader = type("L", (), {"dataset": dataset})()
        self.logger = _Logger()
        self.save_path = save_path
        self.device = torch.device("cpu")
        self.comm_info = {}


def test_data_cache_operator_matches_jax(tmp_path, monkeypatch):
    """DataCacheOperator over an S3DIS train set under a tmp AO_SHM_CACHE:
    every scene cached, every cached array equal to the scene as loaded,
    the same slots and files as ao_tpu's hook writes; with a size limit it
    stops where ao_tpu's does. ROADMAP section 3: the datasets never read
    the cache (a scene's items stay the disk's when its cache entry is
    overwritten), and over a ConcatDataset (whose data_list holds
    (dataset, item) pairs) the hook caches nothing, as ao_tpu's."""
    root = _s3dis_root(tmp_path)
    monkeypatch.setenv("AO_SHM_CACHE", str(tmp_path / "shm_t"))
    monkeypatch.setattr(jcache, "_SHM_ROOT", str(tmp_path / "shm_j"))
    ds_cfg = dict(type="S3DISDataset", split=("Area_1", "Area_2"),
                  data_root=root, transform=[], cache=True)
    ds = build_dataset(ds_cfg)
    hook = thooks.DataCacheOperator(data_root=root)
    hook.trainer = _Trainer(ds)
    hook.before_train()
    jhook = jhooks.DataCacheOperator(data_root=root)
    jhook.trainer = _Trainer(jax_build_dataset(ds_cfg))
    jhook.before_train()
    assert hook.cached == ds.data_list and len(ds.data_list) == 3
    assert _tree(tmp_path / "shm_t") == _tree(tmp_path / "shm_j")
    for path in ds.data_list:
        entry = tcache.shared_dict("ao-" + path)
        scene = load_scene(path)
        assert sorted(entry) == sorted(scene)
        for key in scene:
            np.testing.assert_array_equal(entry[key], scene[key])
    # the datasets read the disk, not the cache
    before = ds.get_data(0)
    slot = os.path.join(str(tmp_path / "shm_t"), sorted(os.listdir(tmp_path / "shm_t"))[0])
    for f in os.listdir(slot):
        arr = np.load(os.path.join(slot, f))
        np.save(os.path.join(slot, f), np.zeros_like(arr))
    after = ds.get_data(0)
    for key in before:
        if isinstance(before[key], np.ndarray):
            np.testing.assert_array_equal(before[key], after[key])
    tcache.clear_cache()
    one_scene = sum(v.nbytes for v in load_scene(ds.data_list[0]).values())
    limited = thooks.DataCacheOperator(mem_size_limit_gb=1.5 * one_scene / 1024**3)
    limited.trainer = _Trainer(ds)
    limited.before_train()
    assert limited.cached == ds.data_list[:1]
    tcache.clear_cache()
    concat = thooks.DataCacheOperator()
    concat.trainer = _Trainer(build_dataset(dict(type="ConcatDataset",
                                                 datasets=[ds_cfg])))
    concat.before_train()
    assert concat.cached == [] and not (tmp_path / "shm_t").exists()


def test_json_writer_matches_jax(tmp_path, monkeypatch):
    """EventStorage (smoothed and unsmoothed scalars over several
    iterations) with JSONWriter: the file equals ao_tpu's line for line
    (time fixed), and get_event_storage returns the open storage."""
    monkeypatch.setattr(tevents.time, "time", lambda: 1234.5)
    monkeypatch.setattr(jevents.time, "time", lambda: 1234.5)
    files = []
    for mod in (tevents, jevents):
        path = str(tmp_path / mod.__name__ / "metrics.json")
        writer = mod.JSONWriter(path, window_size=3)
        with mod.EventStorage(start_iter=5) as storage:
            assert mod.get_event_storage() is storage
            for i in range(6):
                storage.put_scalar("loss", 1.0 / (i + 1))
                storage.put_scalars(lr=0.01 * i, smoothing_hint=False)
                if i % 2:
                    storage.put_scalar("grad", float(i * i))
                writer.write(storage)
                storage.step()
        writer.close()
        with open(path) as f:
            files.append(f.read().splitlines())
    assert files[0] == files[1] and len(files[0]) == 6
    assert json.loads(files[0][-1])["iteration"] == 10


def _jax_schedule(monkeypatch, steps, **kw):
    """ao_tpu's RuntimeProfilerV2: the iterations its traces cover."""
    import jax.profiler as jp

    active, covered = [False], []
    monkeypatch.setattr(jp, "start_trace", lambda d: active.__setitem__(0, True))
    monkeypatch.setattr(jp, "stop_trace", lambda: active.__setitem__(0, False))
    hook = jhooks.RuntimeProfilerV2(**kw)
    hook.trainer = _Trainer(save_path="unused")
    for it in range(steps):
        hook.trainer.comm_info["iter"] = it
        hook.before_step()
        if active[0]:
            covered.append(it)
        hook.after_step()
    return covered


@pytest.mark.parametrize("kw", [dict(wait=1, warmup=1, active=2, repeat=2),
                                dict(wait=0, warmup=2, active=1, repeat=3)])
def test_runtime_profiler_v2_schedule(tmp_path, monkeypatch, kw):
    """RuntimeProfilerV2 on the CPU profiler over 12 steps: one trace file
    a cycle under save_path/profile_v2, each covering exactly the steps
    that ao_tpu's hook traces (its iterations in [wait + warmup, cycle) of
    each of the repeat cycles); with interrupt, the run exits after the
    last trace."""
    want = _jax_schedule(monkeypatch, 12, **kw)
    hook = thooks.RuntimeProfilerV2(**kw)
    hook.trainer = _Trainer(save_path=str(tmp_path))
    hook.before_train()
    for it in range(12):
        hook.trainer.comm_info["iter"] = it
        hook.before_step()
        with torch.profiler.record_function(f"train_step_{it}"):
            torch.ones(4).sum()
        hook.after_step()
    hook.after_train()
    assert len(hook.traces) == kw["repeat"]
    covered = []
    for path in hook.traces:
        assert os.path.dirname(path) == str(tmp_path / "profile_v2")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        covered += sorted({int(e["name"].rsplit("_", 1)[1]) for e in events
                           if e.get("name", "").startswith("train_step_")})
    assert covered == want
    stop = thooks.RuntimeProfilerV2(interrupt=True, **kw)
    stop.trainer = _Trainer(save_path=str(tmp_path / "stop"))
    stop.before_train()
    with pytest.raises(SystemExit):
        for it in range(12):
            stop.after_step()
    assert len(stop.traces) == kw["repeat"]


def test_path_checkpoint_and_misc_helpers_match_jax(tmp_path):
    """scandir (suffixes, recursion, hidden entries), mkdir_or_exist,
    symlink, check_file_exist, fopen; copy_best; make_divisible."""
    for rel in ("a.txt", "b.npz", "sub/c.txt", "sub/deep/d.npz", ".hidden.txt",
                "sub/.e.txt"):
        (tmp_path / "tree" / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / "tree" / rel).write_text(rel)
    for suffix in (None, ".txt", (".txt", ".npz")):
        for rec in (False, True):
            assert sorted(tpath.scandir(str(tmp_path / "tree"), suffix, rec)) == \
                sorted(jpath.scandir(str(tmp_path / "tree"), suffix, rec))
    tpath.mkdir_or_exist(str(tmp_path / "x" / "y"))
    tpath.symlink(str(tmp_path / "tree" / "a.txt"), str(tmp_path / "link"))
    tpath.symlink(str(tmp_path / "tree" / "b.npz"), str(tmp_path / "link"))
    assert os.readlink(tmp_path / "link").endswith("b.npz")
    with pytest.raises(FileNotFoundError):
        tpath.check_file_exist(str(tmp_path / "nope"))
    with tpath.fopen(str(tmp_path / "tree" / "a.txt")) as f:
        assert f.read() == "a.txt"
    with pytest.raises(ValueError):
        tpath.fopen(3)
    tckpt.copy_best(str(tmp_path / "tree" / "a.txt"), str(tmp_path / "best_t"))
    jckpt.copy_best(str(tmp_path / "tree" / "a.txt"), str(tmp_path / "best_j"))
    assert (tmp_path / "best_t").read_bytes() == (tmp_path / "best_j").read_bytes()
    for x, d in ((0, 8), (1, 8), (8, 8), (9, 8), (81919, 4096), (100, 7)):
        assert tmisc.make_divisible(x, d) == jmisc.make_divisible(x, d)
