"""Swin3D-v1m1 of ao_tpu_torch against ao_tpu on the CPU, with the same
numpy inputs and weights (random, from a numpy seed, in the shapes of
ao_tpu's variables, carried across by ``convert.py``): the window maps bit
for bit (on a float32 lattice whose points lie on window edges), the
per-cluster signal mean, WindowAttentionCRSE over the table lengths of
the configs, SwinBlockCRSE's attention over the occupied window rows
against ao_tpu's dense buffer (empty rows, rows beyond ``num_windows``,
slots beyond the capacity, padded points) and its gradients, the pair
terms' own gradients, a tiny Swin3D's logits and running statistics in
eval and train mode (its unpooling above the 2M-pair budget: the curve
search's plain path), and the converter. ao_tpu's side runs jitted, as
its train step does: XLA then multiplies by the reciprocal of a constant
divisor, which the port writes out. The inputs go to the jitted
function as arguments: data closed over would be constant-folded with
other arithmetic (on the lattice, other windows and bins)."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops.window_partition import pack_windows as jax_pack_windows
from ao_tpu.ops.window_partition import window_ids as jax_window_ids
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.swin3d import swin3d as T
from ao_tpu_torch.models.swin3d.convert import flax_to_torch_state_dict
from ao_tpu_torch.ops.window_partition import pack_windows, window_ids

J = importlib.import_module("ao_tpu.models.swin3d.swin3d")
interp_mod = importlib.import_module("ao_tpu_torch.ops.interpolation")
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
MODES = ("xyz", "rgb", "norm")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops a forward: one intra-op thread (restored after
    the module), so that the test workers' pools do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(rng, shape, n, step=0.02, off=0.37):
    """Points of a float32 lattice, i * float32(step) + off for integer i in
    [0, n): many lie on window edges, where floor(c / w) and floor(c * (1
    / w)) part."""
    i = rng.integers(0, n, shape).astype(np.float32)
    return (i * np.float32(step) + np.float32(off)).astype(np.float32)


def _scene(seed=0, B=2, dense=400, sparse=200):
    """(coord, mask) of B scenes of a dense 0.3 m lattice cluster (15-30
    points a 0.1 m window) and points spread over a 2.4 m lattice (most
    alone in their window); the last scene's final 150 rows padded."""
    rng = np.random.default_rng(seed)
    coord = np.concatenate([_lattice(rng, (B, dense, 3), 15),
                            _lattice(rng, (B, sparse, 3), 120)], axis=1)
    mask = np.ones(coord.shape[:2], bool)
    mask[-1, -150:] = False
    return coord, mask


def _random_variables(shapes, seed=1):
    """Numpy arrays in the shapes of a flax variables tree: Dense kernels
    normal / sqrt(fan-in), cRSE tables normal x 0.3, biases and the stem
    normal x 0.1, scales 1 + normal x 0.1, running means normal x 0.1,
    running variances uniform in [0.5, 1.5]: every parameter distinct."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        if name.endswith("_table"):
            return 0.3 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _init(module, *args):
    return _random_variables(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                            *args))


def _load(tmod, name, params):
    """Load the flax ``params`` of module ``name`` into the port's module."""
    sd = flax_to_torch_state_dict({name: params})
    tmod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                         strict=True)
    return tmod


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-12))


# ------------------------------------------------------------------ windows


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shifted"])
def test_window_ids_match_jax(shift):
    """Window ids of padded lattice scenes at the configs' window sizes (5
    x 0.02 and 7 x 0.04 m): equal to ao_tpu's jitted window_ids bit for
    bit, invalid points at the int32 maximum; the lattice puts points on
    edges, where a true division would part from both on some points."""
    rng = np.random.default_rng(0)
    coord = _lattice(rng, (2, 3000, 3), 250)
    mask = np.ones((2, 3000), bool)
    mask[1, 2500:] = False
    jit_ids = jax.jit(jax_window_ids, static_argnames=("window_size", "shift"))
    for w in (5 * 0.02, 7 * 0.04):
        j = np.asarray(jit_ids(jnp.asarray(coord), jnp.asarray(mask),
                               window_size=w, shift=shift))
        t = window_ids(torch.from_numpy(coord), torch.from_numpy(mask), w, shift)
        np.testing.assert_array_equal(t.numpy(), j)
        assert (t.numpy()[~mask] == 2**31 - 1).all()
    c = coord[0] - coord[0].min(0)
    true_div = np.floor(c / np.float32(0.1))
    assert (true_div != np.floor(c * (np.float32(1) / np.float32(0.1)))).any()


_PACKS = {
    # (num_windows, capacity): (rows left empty, windows beyond num_windows,
    # points beyond the capacity)
    "empty-rows-and-overflow": ((300, 8), (True, False, True)),
    "beyond-num-windows": ((60, 64), (False, True, False)),
    "all-three": ((150, 16), (True, True, True)),
}


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("case", list(_PACKS))
def test_pack_windows_matches_jax(case, shift):
    """point_idx, slot_valid, win_of_point and slot_of_point of ao_tpu's
    pack_windows bit for bit, on padded scenes whose dense cluster fills
    windows past the capacity (the stable order decides which points
    overflow) and whose spread points leave rows empty or fill more
    windows than ``num_windows``; the drop counts as the maps give them."""
    (num_windows, capacity), (empty, beyond, overflow) = _PACKS[case]
    coord, mask = _scene()
    wid = window_ids(torch.from_numpy(coord), torch.from_numpy(mask), 0.1, shift)
    j = jax_pack_windows(jnp.asarray(wid.numpy().astype(np.int32)),
                         num_windows, capacity)
    (pidx, valid, win, slot), (by_rows, by_cap) = pack_windows(
        wid, num_windows, capacity)
    for t, jv in zip((pidx, valid, win, slot), j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jv))
    dropped = int(((win < 0) & torch.from_numpy(mask)).sum())
    assert dropped == int(by_rows + by_cap) > 0
    occupied = int(valid[..., 0].sum())
    assert (occupied < 2 * num_windows, by_rows > 0, by_cap > 0) == (
        empty, beyond, overflow)


def test_segment_mean_matches_jax():
    """The masked per-cluster mean with its dropped bucket (padded points,
    empty clusters at 0) against ao_tpu's segment_sum form: within 1e-6 of
    scale (the sums run in another order)."""
    rng = np.random.default_rng(2)
    values = rng.uniform(-1, 1, (2, 500, 6)).astype(np.float32)
    cluster = rng.integers(0, 90, (2, 500))
    mask = rng.random((2, 500)) < 0.8
    j = J._segment_mean(jnp.asarray(values), jnp.asarray(cluster),
                        jnp.asarray(mask), 100)
    t = T._segment_mean(torch.from_numpy(values), torch.from_numpy(cluster),
                        torch.from_numpy(mask), 100)
    assert _rel(t, j) <= 1e-6
    assert (t[:, 90:] == 0).all()


# ---------------------------------------------------------------- attention


_ATTN = {
    # id: (window size, signal modes): table lengths L
    "xyz-rgb-norm-L40-32-32": (5, MODES),
    "xyz-L40": (5, ("xyz",)),
    "xyz-L56": (7, ("xyz",)),
    "rgb-L32": (7, ("rgb",)),
}


def _attention_inputs(modes, W=40, S=16, C=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(W, S, C)).astype(np.float32)
    parts = [rng.uniform(0, 6, (W, S, 3)) if m == "xyz"
             else rng.uniform(-1, 1, (W, S, 3)) for m in modes]
    sig = np.concatenate(parts, -1).astype(np.float32)
    valid = rng.random((W, S)) < 0.7
    valid[3] = False  # a row with no valid slot
    return x, sig, valid


@pytest.mark.parametrize("case", list(_ATTN))
def test_attention_matches_jax(case):
    """WindowAttentionCRSE (C=16, 2 heads, quant 4) on rows of 16 slots, one
    with no valid slot, at the table lengths the configs give (xyz: 2 x
    window x quant = 40 or 56; rgb / norm: 32): within 1e-5 of scale,
    invalid slots 0."""
    window, modes = _ATTN[case]
    x, sig, valid = _attention_inputs(modes)
    jm = J.WindowAttentionCRSE(16, 2, window, 4, modes)
    var = _init(jm, x, sig, valid)
    j = jax.jit(jm.apply)(var, x, sig, valid)
    tm = _load(T.WindowAttentionCRSE(16, 2, window, 4, modes), "attn",
               var["params"])
    t = tm(*(torch.from_numpy(a) for a in (x, sig, valid)))
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(valid)] == 0).all()


def test_attention_chunks_and_pair_terms():
    """The rows in several chunks give the one-chunk output; the pair terms'
    autograd Functions pass gradcheck in float64."""
    x, sig, valid = (torch.from_numpy(a) for a in _attention_inputs(MODES))
    tm = T.WindowAttentionCRSE(16, 2, 5, 4, MODES)
    whole = tm(x, sig, valid)
    old = T.ATTN_CHUNK_ELEMENTS
    T.ATTN_CHUNK_ELEMENTS = 7 * 2 * 16 * 16  # 7 rows a chunk
    try:
        torch.testing.assert_close(tm(x, sig, valid), whole, rtol=0, atol=0)
    finally:
        T.ATTN_CHUNK_ELEMENTS = old

    g = torch.Generator().manual_seed(0)
    R, H, S, D, L = 3, 2, 5, 3, 6
    bins = torch.randint(0, L, (R, S, S, 6), generator=g).to(torch.uint8)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           requires_grad=True)

    q, k, attn = rnd(R, H, S, D), rnd(R, H, S, D), rnd(R, H, S, S)
    tables = [rnd(3, L, H, D) for _ in range(4)]
    assert torch.autograd.gradcheck(
        lambda *a: T._PairBias.apply(bins, *a), (q, k, *tables))
    assert torch.autograd.gradcheck(
        lambda *a: T._PairValue.apply(bins, *a), (attn, *tables[:2]))


# ------------------------------------------------------------------- blocks


_BLOCKS = {
    # id: (shift, num_windows, capacity), as in _PACKS
    "empty-rows-overflow": ((False, 300, 8), (True, False, True)),
    "shifted-empty-rows-overflow": ((True, 300, 8), (True, False, True)),
    "all-three": ((False, 150, 16), (True, True, True)),
}


def _block_case(case):
    shift, num_windows, capacity = _BLOCKS[case][0]
    coord, mask = _scene(seed=4)
    rng = np.random.default_rng(5)
    feat = rng.normal(size=coord.shape[:2] + (16,)).astype(np.float32)
    sig_rest = rng.uniform(-1, 1, coord.shape[:2] + (6,)).astype(np.float32)
    jb = J.SwinBlockCRSE(16, 2, 5, 0.02, 4, shift, num_windows, capacity, MODES)
    tb = T.SwinBlockCRSE(16, 2, 5, 0.02, 4, shift, capacity, MODES)
    return jb, tb, (coord, feat, sig_rest, mask), num_windows


@pytest.mark.parametrize("case", list(_BLOCKS))
def test_block_matches_dense_jax(case):
    """SwinBlockCRSE (C=16, 2 heads, 0.1 m windows, xyz + rgb + norm) on
    padded lattice scenes: the port's attention over the occupied rows
    only equals ao_tpu's over its whole (num_windows, capacity) buffer,
    within 1e-5 of scale, with rows left empty, points past the capacity
    and windows past num_windows (each case's drops checked); padded rows
    0."""
    jb, tb, args, num_windows = _block_case(case)
    var = _init(jb, *args)
    j = jax.jit(jb.apply)(var, *args)
    _load(tb, "stage0_block0", var["params"])
    t = tb(*(torch.from_numpy(a) for a in args), num_windows)
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(args[-1])] == 0).all()
    rows, cap_rows, by_rows, by_cap = tb.window_stats
    assert cap_rows == 2 * num_windows
    assert (rows < cap_rows, int(by_rows) > 0, int(by_cap) > 0) == _BLOCKS[case][1]


@pytest.mark.parametrize("case", ["empty-rows-overflow", "all-three"])
def test_block_gradients_match_jax(case):
    """The block's parameter gradients of sum(out * r) (drop path 0) against
    jax.grad: every leaf's difference within 1e-3 of its L2 norm, the
    cRSE tables among them."""
    jb, tb, args, num_windows = _block_case(case)
    var = _init(jb, *args)
    r = np.random.default_rng(6).normal(size=args[1].shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, *a: (jb.apply({"params": p}, *a) * r).sum()))(
        var["params"], *args)
    name = "stage0_block0"
    jg = {k[len(name) + 1:]: v for k, v in flax_to_torch_state_dict(
        {name: _np(jg)}).items()}
    _load(tb, "stage0_block0", var["params"])
    out = tb(*(torch.from_numpy(a) for a in args), num_windows)
    (out * torch.from_numpy(r)).sum().backward()
    tg = {k: p.grad for k, p in tb.named_parameters()}
    assert set(tg) == set(jg) and sum("table" in k for k in tg) == 9
    for k, g in jg.items():
        assert float((tg[k] - g).norm()) <= 1e-3 * float(g.norm()), k


# ------------------------------------------------------------------- models


TINY = dict(type="Swin3D-v1m1", in_channels=9, num_classes=5,
            base_grid_size=0.1, channels=(8, 16), num_heads=(2, 2),
            depths=(1, 1), window_sizes=(3, 3), stage_cap_ratios=(0.6,),
            signal_modes=MODES, color_channels=(3, 6), normal_channels=(6, 9),
            window_capacity=32)
_RESULTS = {}


def _tiny_inputs():
    """2 scenes of 2048 points in a 4 x 4 x 2 m box, the last 400 rows of
    scene 1 padded; feat = (coord, colour, normal)."""
    rng = np.random.default_rng(8)
    coord = (rng.uniform(0, 1, (2, 2048, 3)) * np.array([4.0, 4.0, 2.0])
             ).astype(np.float32)
    feat = np.concatenate([coord, rng.uniform(-1, 1, (2, 2048, 6))], -1
                          ).astype(np.float32)
    mask = np.ones((2, 2048), bool)
    mask[1, -400:] = False
    return coord, feat, mask


def _results(train, monkeypatch):
    """(ao_tpu's logits and running statistics, the port's, the port's
    window statistics, curve-search calls) of the tiny model in train or
    eval mode, run once per mode in this module; ao_tpu's side jitted."""
    if train in _RESULTS:
        return _RESULTS[train]
    args = _tiny_inputs()
    jmodel = jax_build_model(dict(TINY))
    var = _init(jmodel, *args)
    out, mut = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, True, not train, mutable=["batch_stats"]))(var, *args)
    jax_side = (np.asarray(out), flax_to_torch_state_dict(
        var["params"], _np(mut["batch_stats"])))
    tmodel = build_model(dict(TINY, drop_path_rate=0.0))
    tmodel.load_state_dict(flax_to_torch_state_dict(var["params"],
                                                    var["batch_stats"]), strict=True)
    calls = []
    curve = interp_mod.knn_cross_spatial
    monkeypatch.setattr(interp_mod, "knn_cross_spatial",
                        lambda *a, **kw: calls.append(kw) or curve(*a, **kw))
    tmodel.train(train)
    with torch.no_grad():
        t = tmodel(*(torch.from_numpy(a) for a in args))
    _RESULTS[train] = (args[2], jax_side, (t.numpy(), tmodel.state_dict()),
                       tmodel.window_stats, calls)
    return _RESULTS[train]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_model_matches_jax(monkeypatch, train):
    """The tiny Swin3D (2 stages, C 8 / 16, 2 heads, 0.3 / 0.6 m windows,
    xyz + rgb + norm) on 2 x 2048 points in eval mode and in train mode
    (batch statistics, drop path 0): logits of the valid points within
    1e-4 of scale and, after the train forward, every running statistic
    within 1e-4 of its scale. Stage 0's windows outnumber its 512 rows a
    scene (the points beyond skip attention), and the unpooling's 1228 x
    2048 pairs cross the 2M-pair budget: the 2-probe curve search."""
    mask, (j, jstats), (t, tstats), stats, calls = _results(train, monkeypatch)
    assert _rel(t[mask], j[mask]) <= 1e-4
    if train:
        for k, v in jstats.items():
            if "running" in k:
                assert _rel(tstats[k], v) <= 1e-4, k
    assert [s[:2] for s in stats] == [(0, 0), (1, 0)]
    assert stats[0][2] == stats[0][3] == 1024 and int(stats[0][4]) > 0
    assert calls and calls[0]["probes"] == 2


def test_converter_round_trip():
    """ao_tpu's Swin3D variables (inside a DefaultSegmentor) load into the
    port's strictly, leaf for leaf: as many tensors as flax leaves (plus a
    num_batches_tracked a BatchNorm), each equal to its flax array (Dense
    kernels transposed), no two leaves alike."""
    args = [jnp.asarray(a) for a in _tiny_inputs()]
    seg = dict(type="DefaultSegmentor", backbone=dict(TINY))
    variables = _init(jax_build_model(seg), *args)
    sd = flax_to_torch_state_dict(variables["params"], variables["batch_stats"])
    model = build_model(seg)
    model.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(variables)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert n_bn == 2 and len(sd) == len(leaves) + n_bn
    assert len({np.asarray(v).tobytes() for v in leaves}) == len(leaves)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert np.array_equal(sd["backbone.stage0_block0.mlp.2.weight"].numpy(),
                          flat["['params']['backbone']['stage0_block0']['Dense_1']['kernel']"].T)
    assert np.array_equal(sd["backbone.seg_bn.norm.running_var"].numpy(),
                          flat["['batch_stats']['backbone']['PointBatchNorm_0']['var']"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
