"""The Stratified Transformer (ST-v1m1 / ST-v1m2) of ao_tpu_torch against
ao_tpu on the CPU, with the same numpy inputs and weights (random, from a
numpy seed, in the shapes of ao_tpu's variables, carried across by
``convert.py``): the KPConv embedding, the window attention with its
stratified coarse keys over the occupied window rows against ao_tpu's
dense buffer, the coarse rows' anchor, STBlock with points dropped beyond
the capacity, both models' logits and one train step's loss and
gradients, the converter; then the configs: the ST-v1m2 width, the
MultiStepLR schedule against ao_tpu's. ao_tpu's side runs jitted, with
the data as arguments, as its train step does: XLA then multiplies by the
reciprocal of a constant divisor, which the port writes out."""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops import grid_pool as jax_grid_pool
from ao_tpu.ops import grouping as jax_grouping
from ao_tpu.ops.window_partition import pack_windows as jax_pack_windows
from ao_tpu.ops.window_partition import window_ids as jax_window_ids
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.stratified_transformer import stratified as T
from ao_tpu_torch.models.stratified_transformer.convert import flax_to_torch_state_dict
from ao_tpu_torch.utils import Config
from ao_tpu_torch.utils.optimizer import build_optimizer
from ao_tpu_torch.utils.scheduler import build_scheduler

J = importlib.import_module("ao_tpu.models.stratified_transformer.stratified")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_np = functools.partial(jax.tree_util.tree_map, np.asarray)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops a forward: one intra-op thread (restored after the
    module), so that the test workers' pools do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_variables(shapes, seed=1):
    """Numpy arrays in the shapes of a flax variables tree: kernels normal /
    sqrt(first dim), position tables normal x 0.3, biases normal x 0.1,
    LayerNorm scales 1 + normal x 0.1: every parameter distinct."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        if name.endswith("_table"):
            return 0.3 * rng.normal(size=s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _init(module, *args, static=()):
    """Random variables of ``module`` for ``args`` (and the static
    arguments ``static`` after them)."""
    return _random_variables(jax.eval_shape(
        lambda key, *a: module.init(key, *a, *static), jax.random.PRNGKey(0),
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


def _scene(seed=0, B=2, N=1024, size=(2.0, 2.0, 1.0), pad=200):
    """(coord, mask) of B scenes of N uniform points in a box, the last
    scene's final ``pad`` rows padded."""
    rng = np.random.default_rng(seed)
    coord = (rng.uniform(0, 1, (B, N, 3)) * np.asarray(size)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[-1, -pad:] = False
    return coord, mask


def _close_leaves(tg, jg):
    """Every gradient leaf of the port within 1e-4 of the L2 norm of
    jax.grad's, or of 1e-2 of the largest leaf's norm where that is larger:
    the key projection's bias has a gradient of 0 in exact arithmetic (it
    moves every logit of a query alike), rounding noise in both."""
    floor = 1e-2 * max(float(g.norm()) for g in jg.values())
    assert set(tg) == set(jg)
    for k, g in jg.items():
        assert float((tg[k] - g).norm()) <= 1e-4 * max(float(g.norm()), floor), k


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------- embedding


def test_kpconv_embed_matches_jax():
    """KPConvEmbed (6 -> 16 channels, 15 kernel points, sigma 0.1, the exact
    16-NN) on two padded scenes of 1024 points in a 0.6 m box (several
    neighbours inside sigma of a kernel point): within 1e-5 of scale of
    ao_tpu's jitted module, padded rows 0; the kernel points bit for bit."""
    np.testing.assert_array_equal(T._kernel_points(15), J._kernel_points(15))
    coord, mask = _scene(seed=1, size=(0.6, 0.6, 0.6))
    feat = np.random.default_rng(2).normal(size=coord.shape[:2] + (6,)).astype(np.float32)
    jm = J.KPConvEmbed(16)
    var = _init(jm, coord, feat, mask)
    j = jax.jit(jm.apply)(var, coord, feat, mask)
    tm = _load(T.KPConvEmbed(6, 16), "kp_embed", var["params"])
    t = tm(*_t(coord, feat, mask))
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(mask)] == 0).all()
    assert float((np.asarray(j) != 0).mean()) > 0.5


@pytest.mark.parametrize("keys,length", [(9, 8), (5, 12)],
                         ids=["per-query-histograms", "per-row-histograms"])
def test_biased_attention_gradcheck(keys, length):
    """The attention that recomputes its softmax in the backward (shared by
    the Stratified Transformer and OctFormer) passes gradcheck in float64
    (masked keys among them), with the position table's gradient added
    into histograms per query (the table no longer than a query's keys, as
    the Stratified Transformer's 3 x 24 rows over 80 keys) and per row
    (OctFormer's 3 x 41 or 3 x 83 rows over 26 keys), in chunks of 1 or 2
    rows; its forward is autograd's of the same ops."""
    from ao_tpu_torch.models import utils

    g = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           requires_grad=True)

    R, H, Q, D = 5, 2, 4, 3
    q, k, v = rnd(R, H, Q, D), rnd(R, H, keys, D), rnd(R, H, keys, D)
    table = rnd(3 * length, H)
    bins = utils.table_bins(torch.randint(0, length, (R, Q, keys, 3), generator=g),
                            length)
    k_valid = torch.rand(R, keys, generator=g) < 0.7
    k_valid[:, 0] = True
    old = utils.TABLE_HIST_ELEMENTS
    utils.TABLE_HIST_ELEMENTS = 2 * H * 3 * length
    try:
        assert torch.autograd.gradcheck(lambda *a: utils.BiasedAttention.apply(
            *a[:3], bins, k_valid, a[3], 0.5), (q, k, v, table))
    finally:
        utils.TABLE_HIST_ELEMENTS = old
    bias = sum(table[bins[..., a].long()] for a in range(3)).permute(0, 3, 1, 2)
    logits = (q @ k.transpose(2, 3)) * 0.5 + bias
    want = torch.softmax(logits.masked_fill(~k_valid[:, None, None, :], -1e9), -1) @ v
    torch.testing.assert_close(
        utils.BiasedAttention.apply(q, k, v, bins, k_valid, table, 0.5), want)


def test_gelu_mlp_gradcheck():
    """The MLP that recomputes its GELU in the backward passes gradcheck in
    float64 and gives nn.Sequential's forward of its three children."""
    from ao_tpu_torch.models import utils

    mlp = utils.GeluMlp(4, 8).double()
    x = torch.randn(2, 5, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(mlp, (x,))
    torch.testing.assert_close(mlp(x), torch.nn.Sequential(*mlp)(x))


# ------------------------------------------------------------- attention


def _dense_packs(coord, h, mask, window, shift, num_windows, capacity=16,
                 coarse_capacity=8):
    """ao_tpu's dense window buffers of an STBlock, jitted: (q_feat, q_xyz,
    q_valid, k_feat, k_xyz, k_valid) over its (B, num_windows, capacity)
    rows, the coarse keys from the grid pool at window / 4."""

    @jax.jit
    def packs(coord, h, mask):
        B, N = mask.shape
        W, S = num_windows, capacity
        pidx, pvalid, _, _ = jax_pack_windows(
            jax_window_ids(coord, mask, window, shift), W, S)
        g = lambda x, i, v, s: jax_grouping(  # noqa: E731
            x, i.reshape(B, -1, 1), v.reshape(B, -1, 1)).reshape(B, W, s, -1)
        q_feat, q_xyz = g(h, pidx, pvalid, S), g(coord, pidx, pvalid, S)
        pc, pf, pm, _, _ = jax_grid_pool(coord, h, mask, window / 4,
                                         max_clusters=max(N // 4, 64))
        cidx, cvalid, _, _ = jax_pack_windows(
            jax_window_ids(pc, pm, window, shift), W, coarse_capacity)
        k_feat = jnp.concatenate([q_feat, g(pf, cidx, cvalid, coarse_capacity)], 2)
        k_xyz = jnp.concatenate([q_xyz, g(pc, cidx, cvalid, coarse_capacity)], 2)
        return q_feat, q_xyz, pvalid, k_feat, k_xyz, jnp.concatenate(
            [pvalid, cvalid], 2)

    return [np.asarray(a) for a in packs(coord, h, mask)]


@pytest.mark.parametrize("shift", [False, True], ids=["plain", "shifted"])
def test_window_attention_over_occupied_rows_matches_dense_jax(shift):
    """WindowAttention (C=16, 2 heads, quant 0.02 m) over ao_tpu's packed
    0.3 m windows of 16 slots with their 8 stratified coarse keys: the
    port's attention over the occupied rows only equals ao_tpu's over its
    whole (num_windows, 16) buffer within 1e-5 of scale; the rows beyond
    the occupied ones are ao_tpu's zeros; rows are left empty, some coarse
    key rows are empty, slots are padded."""
    coord, mask = _scene(seed=3)
    h = np.random.default_rng(4).normal(size=coord.shape[:2] + (16,)).astype(np.float32)
    qf, qx, qv, kf, kx, kv = _dense_packs(coord, h, mask, 0.3, shift, 300)
    jm = J.WindowAttention(16, 2, 0.02)
    var = _init(jm, qf, qx, qv, kf, kx, kv)
    j = np.asarray(jax.jit(jm.apply)(var, qf, qx, qv, kf, kx, kv))
    occupied = qv[..., 0]
    assert (~occupied).any() and (~kv[..., 16:].any(-1) & occupied).any()
    assert (j[~occupied] == 0).all()
    # the keys: the rows' own points, then the coarse ones
    np.testing.assert_array_equal(kf[..., :16, :], qf)
    tm = _load(T.WindowAttention(16, 2, 0.02), "attn", var["params"])
    args = _t(qf[occupied], qx[occupied], qv[occupied])
    coarse = _t(kf[occupied][:, 16:], kx[occupied][:, 16:], kv[occupied][:, 16:])
    t = tm(*args, coarse)
    assert _rel(t.detach(), j[occupied]) <= 1e-5
    # the rows in several chunks give the one-chunk output
    old = T.ATTN_CHUNK_ELEMENTS
    T.ATTN_CHUNK_ELEMENTS = 7 * 2 * 16 * 24
    try:
        t7 = tm(*args, coarse)
    finally:
        T.ATTN_CHUNK_ELEMENTS = old
    torch.testing.assert_close(t7, t, rtol=0, atol=0)


def test_coarse_rows_are_anchored_at_the_pooled_points():
    """The coarse pack's row r is the r-th occupied window of a grid anchored
    at the pooled points' own minimum, not the fine pack's window r: on 4096
    uniform points (0.4 m windows, coarse keys from a 0.1 m pool) some
    occupied rows hold coarse keys that lie outside the row's fine window,
    in ao_tpu and, through the same packs, in the port (ROADMAP.md section 3)."""
    from ao_tpu_torch.ops import grid_pool
    from ao_tpu_torch.ops.window_partition import pack_windows, window_ids

    coord, mask = _scene(seed=5, B=1, N=4096, size=(2.0, 2.0, 2.0), pad=1)
    h = np.random.default_rng(6).normal(size=(1, 4096, 8)).astype(np.float32)
    W = 4096 // 4

    def misplaced(wids, packs, pool):
        wid = wids(coord, mask, 0.4, False)
        (pidx, pvalid), (pc, pm), (cidx, cvalid) = packs(wid, pool)
        # each coarse key's window on the fine grid (anchored at the
        # points' minimum): the window of row r is that of its first point
        lo = coord[0][mask[0]].min(0)
        fine_win = np.floor((pc[0] - lo) / np.float32(0.4)).astype(int)
        row_win = np.floor((coord[0][pidx[0, :, 0]] - lo) / np.float32(0.4)).astype(int)
        bad = [(cvalid[0, r] & (fine_win[cidx[0, r]] != row_win[r]).any(-1)).any()
               for r in range(W) if pvalid[0, r, 0]]
        return int(np.sum(bad)), len(bad)

    def jax_packs(wid, _):
        pidx, pvalid, _, _ = jax_pack_windows(wid, W, 64)
        pc, _, pm, _, _ = jax_grid_pool(coord, h, mask, 0.1, max_clusters=W)
        cidx, cvalid, _, _ = jax_pack_windows(
            jax_window_ids(pc, pm, 0.4, False), W, 16)
        return ((np.asarray(pidx), np.asarray(pvalid)), (np.asarray(pc), pm),
                (np.asarray(cidx), np.asarray(cvalid)))

    def port_packs(wid, _):
        (pidx, pvalid, _, _), _ = pack_windows(wid, W, 64)
        pc, _, pm, _, _ = grid_pool(*_t(coord, h, mask), 0.1, W)
        (cidx, cvalid, _, _), _ = pack_windows(window_ids(pc, pm, 0.4), W, 16)
        return ((pidx.numpy(), pvalid.numpy()), (pc.numpy(), pm),
                (cidx.numpy(), cvalid.numpy()))

    j_bad, j_rows = misplaced(
        lambda c, m, w, s: jax.jit(jax_window_ids, static_argnums=(2, 3))(c, m, w, s),
        jax_packs, None)
    t_bad, t_rows = misplaced(
        lambda c, m, w, s: window_ids(*_t(c, m), w, s), port_packs, None)
    assert (t_bad, t_rows) == (j_bad, j_rows)
    assert 0 < j_bad < j_rows


# ---------------------------------------------------------------- blocks


_BLOCKS = {
    # id: (shift, num_windows, capacity): the fine pack drops points beyond
    # the capacity (and, with 40 rows, beyond num_windows)
    "capacity-drops": (False, 300, 8),
    "shifted-capacity-drops": (True, 300, 8),
    "rows-and-capacity-drops": (False, 40, 8),
}


def _block_case(case):
    shift, num_windows, capacity = _BLOCKS[case]
    coord, mask = _scene(seed=7)
    feat = np.random.default_rng(8).normal(size=coord.shape[:2] + (16,)).astype(np.float32)
    kw = dict(shift=shift, stratified_grid=0.3 / 4, window_capacity=capacity,
              coarse_capacity=8)
    jb = J.STBlock(16, 2, 0.3, 0.02, **kw)
    tb = T.STBlock(16, 2, 0.3, 0.02, **kw)
    return jb, tb, (coord, feat, mask), num_windows


@pytest.mark.parametrize("case", list(_BLOCKS))
def test_block_matches_jax(case):
    """STBlock (C=16, 2 heads, 0.3 m windows of 8 slots, 8 coarse slots, the
    exact GELU) on padded scenes of 1024 points: within 1e-5 of scale of
    ao_tpu's jitted block, points dropped beyond the capacity (and beyond
    num_windows) keeping their residual; padded rows 0; the window
    statistics as the packs give them."""
    jb, tb, args, num_windows = _block_case(case)
    var = _init(jb, *args, static=(num_windows,))
    j = jax.jit(lambda v, c, f, m: jb.apply(v, c, f, m, num_windows))(var, *args)
    _load(tb, "stage0_block0", var["params"])
    t = tb(*_t(*args), num_windows)
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(args[-1])] == 0).all()
    rows, cap_rows, by_rows, by_cap, c_rows, c_by_rows, c_by_cap = (
        int(x) for x in tb.window_stats)
    assert cap_rows == 2 * num_windows and 0 < rows <= cap_rows
    assert by_cap > 0 and (by_rows > 0) == (num_windows == 40)
    assert 0 < c_rows <= cap_rows


def test_block_gradients_match_jax():
    """The block's parameter gradients of sum(out * r) (drop path 0) against
    jax.grad, points dropped beyond the capacity: every leaf as
    :func:`_close_leaves` holds it, the position table among them."""
    jb, tb, args, num_windows = _block_case("shifted-capacity-drops")
    var = _init(jb, *args, static=(num_windows,))
    r = np.random.default_rng(9).normal(size=args[1].shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, *a: (jb.apply(
        {"params": p}, *a, num_windows) * r).sum()))(var["params"], *args)
    name = "stage0_block0"
    jg = {k[len(name) + 1:]: v for k, v in flax_to_torch_state_dict(
        {name: _np(jg)}).items()}
    _load(tb, name, var["params"])
    out = tb(*_t(*args), num_windows)
    (out * torch.from_numpy(r)).sum().backward()
    tg = {k: p.grad for k, p in tb.named_parameters()}
    assert set(tg) == set(jg) and "attn.rpe_table" in tg
    _close_leaves(tg, jg)


# ---------------------------------------------------------------- models


TINY = dict(in_channels=6, num_classes=5, channels=(8, 16), num_heads=(2, 2),
            depths=(2, 1), window_sizes=(0.3, 0.6), quant_sizes=(0.02, 0.04),
            grid_sizes=(0.12,), stage_cap_ratios=(0.5,), window_capacity=16)


def _tiny_inputs(seed=10):
    coord, mask = _scene(seed=seed)
    rng = np.random.default_rng(seed + 1)
    feat = rng.normal(size=coord.shape[:2] + (6,)).astype(np.float32)
    labels = np.where(mask, rng.integers(-1, 5, mask.shape), -1)
    return coord, feat, mask, labels


@pytest.mark.parametrize("kind", ["ST-v1m1", "ST-v1m2"])
def test_model_logits_match_jax(kind):
    """A tiny ST-v1m1 / ST-v1m2 (2 stages, C 8 / 16, 2 heads, 0.3 / 0.6 m
    windows, the shifted second block, stratified keys) on 2 x 1024 points
    in eval mode: logits within 1e-4 of scale of ao_tpu's jitted model; the
    window statistics of its three blocks; stage 1's 512 clusters overflow
    (the clusters beyond merge into the last, in both packages)."""
    coord, feat, mask, _ = _tiny_inputs()
    jmodel = jax_build_model(dict(TINY, type=kind))
    var = _init(jmodel, coord, feat, mask)
    j = jax.jit(lambda v, *a: jmodel.apply(v, *a, True))(var, coord, feat, mask)
    tmodel = build_model(dict(TINY, type=kind)).eval()
    tmodel.load_state_dict(flax_to_torch_state_dict(var["params"]), strict=True)
    with torch.no_grad():
        t = tmodel(*_t(coord, feat, mask))
    assert _rel(t[torch.from_numpy(mask)], np.asarray(j)[mask]) <= 1e-4
    assert [s[:2] for s in tmodel.window_stats] == [(0, 0), (0, 1), (1, 0)]
    assert int(tmodel.pool_overflow) > 0


def test_train_step_loss_and_gradients_match_jax():
    """One train step of the tiny ST-v1m2 (drop path 0): the cross-entropy
    over the labelled points (ignore -1) within 1e-5 of ao_tpu's, and every
    parameter's gradient, leaf by leaf, as :func:`_close_leaves` holds it
    (the KPConv kernel, the position tables, the decoder)."""
    coord, feat, mask, labels = _tiny_inputs(seed=12)
    jmodel = jax_build_model(dict(TINY, type="ST-v1m2"))
    var = _init(jmodel, coord, feat, mask)
    valid = labels >= 0

    def jloss(p, coord, feat, mask):
        logits = jmodel.apply({"params": p}, coord, feat, mask, True)
        lp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(lp, jnp.maximum(labels, 0)[..., None], -1)[..., 0]
        return jnp.sum(jnp.where(valid, nll, 0.0)) / valid.sum()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(var["params"], coord, feat, mask)
    jg = flax_to_torch_state_dict(_np(jg))
    tmodel = build_model(dict(TINY, type="ST-v1m2", drop_path_rate=0.0)).train()
    tmodel.load_state_dict(flax_to_torch_state_dict(var["params"]), strict=True)
    logits = tmodel(*_t(coord, feat, mask))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 5), torch.from_numpy(labels).reshape(-1), ignore_index=-1)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    tg = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(tg) == set(jg)
    _close_leaves(tg, jg)


def test_converter_round_trip():
    """ao_tpu's ST-v1m1 variables (inside a DefaultSegmentor) load into the
    port's strictly, leaf for leaf: as many tensors as flax leaves, each
    equal to its flax array (Dense kernels transposed), no two alike."""
    coord, feat, mask, _ = _tiny_inputs()
    seg = dict(type="DefaultSegmentor", backbone=dict(TINY, type="ST-v1m1"))
    variables = _init(jax_build_model(seg), coord, feat, mask)
    sd = flax_to_torch_state_dict(variables["params"])
    model = build_model(seg)
    model.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(sd) == len(leaves)
    assert len({np.asarray(v).tobytes() for v in leaves}) == len(leaves)
    p = variables["params"]["backbone"]
    pairs = {"backbone.stage0_block1.mlp.2.weight": p["stage0_block1"]["Dense_1"]["kernel"].T,
             "backbone.stage0_block1.norm2.weight": p["stage0_block1"]["LayerNorm_1"]["scale"],
             "backbone.seg_norm.bias": p["LayerNorm_1"]["bias"],
             "backbone.embed_norm.weight": p["LayerNorm_0"]["scale"],
             "backbone.kp_embed.kernel": p["kp_embed"]["kernel"],
             "backbone.stage1_block0.attn.rpe_table": p["stage1_block0"]["attn"]["rpe_table"]}
    for k, v in pairs.items():
        assert np.array_equal(sd[k].numpy(), v), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


# --------------------------------------------------------------- configs


ST_CONFIGS = ["scannet/semseg-st-v1m1-0-origin.py",
              "scannet/semseg-st-v1m2-0-refined.py",
              "scannet200/semseg-stv1m2-0-refined.py"]


@pytest.mark.parametrize("config", ST_CONFIGS)
def test_st_config_width(config):
    """The ST-v1m2 configs set in_channels=9 over the 6 features their
    Collect gives (colour, normal, from the origin config they inherit):
    the port raises a ValueError naming model.backbone.in_channels and both
    widths (the JAX package sizes the KPConv kernel from the features and
    never reads in_channels); the origin config's 6 take the 6 features, as
    does an ST-v1m2 config with model.backbone.in_channels=6."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", config))
    collect = next(t for t in cfg.data.train.transform if t["type"] == "Collect")
    assert tuple(collect["feat_keys"]) == ("color", "normal")
    small = dict(channels=(8, 16), num_heads=(2, 2), depths=(1, 1),
                 window_sizes=cfg.model.backbone.window_sizes[:2],
                 quant_sizes=cfg.model.backbone.quant_sizes[:2],
                 grid_sizes=cfg.model.backbone.grid_sizes[:1],
                 stage_cap_ratios=cfg.model.backbone.stage_cap_ratios[:1])
    bb = dict(cfg.model.backbone, **small)
    coord, mask = _scene(seed=13, N=256, size=(1.0, 1.0, 1.0), pad=10)
    feat = np.random.default_rng(14).normal(size=coord.shape[:2] + (6,)).astype(np.float32)
    with torch.no_grad():
        if "v1m2" in config:
            assert bb["in_channels"] == 9
            with pytest.raises(ValueError, match=r"6 channels.*model\.backbone\."
                               r"in_channels=9.*in_channels=6"):
                build_model(bb)(*_t(coord, feat, mask))
            bb["in_channels"] = 6
        assert bb["in_channels"] == 6
        out = build_model(bb)(*_t(coord, feat, mask))
    assert out.shape == (2, 256, cfg.model.backbone.num_classes)


def test_multistep_schedule_matches_jax():
    """The ST configs' AdamW with MultiStepLR (milestones 0.6 / 0.8 of the
    steps, gamma 0.1): the port's lr at each of 20 steps within 1e-6 of
    ao_tpu's schedule (optax evaluates in f32)."""
    from ao_tpu.utils.optimizer import lr_at_step

    cfg = Config.fromfile(os.path.join(ROOT, "configs", ST_CONFIGS[0]))
    model = torch.nn.Linear(2, 2)
    opt = build_optimizer(cfg.optimizer, model, cfg.get("param_dicts"))
    sched = build_scheduler(dict(cfg.scheduler), opt, 20)
    lrs = []
    for k in range(20):
        want = lr_at_step(dict(cfg.scheduler), cfg.optimizer.lr, 20, k)
        assert abs(opt.param_groups[0]["lr"] - want) <= 1e-6 * want, k
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert len(set(np.round(lrs, 12))) == 3
