"""OctFormer-v1m1 of ao_tpu_torch against ao_tpu on the CPU, with the same
numpy inputs and weights (random, from a numpy seed, in the shapes of
ao_tpu's variables, carried across by ``convert.py``): the dilation order,
the octree attention at dilation 1 and 2 on padded groups, the stable
Morton order with tied codes, the stage-shared CPE graph, the block, the
model's logits (in the input's order, where ao_tpu returns them in the
Morton order) and one train step's loss and gradients, the converter;
then the config: its "blocks" parameter group, empty in both packages,
and the MultiStepWithWarmupLR schedule against ao_tpu's. ao_tpu's side
runs jitted with the data as arguments, as its train step does."""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops import knn_query as jax_knn_query
from ao_tpu.ops.knn_spatial import morton_code as jax_morton_code
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.octformer import octformer as T
from ao_tpu_torch.models.octformer.convert import flax_to_torch_state_dict
from ao_tpu_torch.utils import Config
from ao_tpu_torch.utils.optimizer import build_optimizer
from ao_tpu_torch.utils.scheduler import build_scheduler

J = importlib.import_module("ao_tpu.models.octformer.octformer")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "scannet", "semseg-octformer-v1m1-0-base.py")
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
    """Numpy arrays in the shapes of a flax variables tree: Dense kernels
    normal / sqrt(fan-in), position tables normal x 0.3, the CPE kernels,
    biases normal x 0.1, LayerNorm scales 1 + normal x 0.1."""
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


def _init(module, *args):
    return _random_variables(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                            *args))


def _load(tmod, name, params):
    sd = flax_to_torch_state_dict({name: params})
    tmod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                         strict=True)
    return tmod


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-12))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _sorted_scene(seed=0, B=2, N=1000, C=16, pad=150):
    """(coord, feat, mask) of B scenes of N uniform points in a 2 x 2 x 1 m
    box, Morton-sorted as a stage gives them, the last scene's final
    ``pad`` rows padded."""
    rng = np.random.default_rng(seed)
    coord = (rng.uniform(0, 1, (B, N, 3)) * np.array([2.0, 2.0, 1.0])).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[-1, -pad:] = False
    feat = rng.normal(size=(B, N, C)).astype(np.float32)
    c, f, m, _ = T.sort_stage(*_t(coord, feat, mask))
    return c.numpy(), f.numpy(), m.numpy()


# ------------------------------------------------------------- attention


def test_dilate_order_matches_jax():
    """The dilation order and its inverse, bit for bit, at the configs'
    group sizes (26 x 1 and 26 x 4) and a dilation that does not divide N
    (the identity)."""
    for n, d in ((26 * 40, 1), (104 * 10, 4), (1000, 3)):
        order, inv = T._orders(n, d)
        np.testing.assert_array_equal(order, J._dilate_order(n, d))
        np.testing.assert_array_equal(order[inv], np.arange(n))


@pytest.mark.parametrize("dilation", [1, 2], ids=["dilation-1", "dilation-2"])
def test_octree_attention_matches_jax(dilation):
    """OctreeAttention (C=16, 2 heads, groups of 8) on 1000 sorted points a
    scene, padded to a multiple of 8 x dilation (1000 and 1008), 150 rows
    of the last scene invalid, the bias on 0.06 m cells (table of 3 x 13
    or 3 x 19 rows): within 1e-5 of scale of ao_tpu's jitted module,
    invalid rows 0."""
    coord, feat, mask = _sorted_scene(seed=1)
    xyz = np.floor(coord * np.float32(1 / np.float32(0.06))).astype(np.int32)
    jm = J.OctreeAttention(16, 2, 8, dilation)
    var = _init(jm, feat, mask, xyz)
    j = jax.jit(jm.apply)(var, feat, mask, xyz)
    tm = _load(T.OctreeAttention(16, 2, 8, dilation), "attn", var["params"])
    assert tm.rpe_table.shape == (3 * (2 * int(0.8 * 8 * dilation ** 0.5) + 1), 2)
    t = tm(*_t(feat, mask, xyz))
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(mask)] == 0).all()


def test_morton_order_with_tied_codes_matches_jax():
    """Points on a 0.25 m lattice (many share a point, so their 30-bit codes
    tie): the stage order, a stable sort of the codes, equals ao_tpu's
    jnp.argsort index for index; padded points sort last."""
    rng = np.random.default_rng(2)
    coord = (rng.integers(0, 8, (2, 2000, 3)) * np.float32(0.25)).astype(np.float32)
    mask = np.ones((2, 2000), bool)
    mask[1, -300:] = False
    feat = rng.normal(size=(2, 2000, 4)).astype(np.float32)
    codes = np.asarray(jax.jit(jax_morton_code)(coord, mask))
    j_order = np.asarray(jax.jit(lambda c: jnp.argsort(c, axis=1))(codes))
    *_, order = T.sort_stage(*_t(coord, feat, mask))
    np.testing.assert_array_equal(order.numpy(), j_order)
    assert len(np.unique(codes[0])) < 600  # about 3 points a code
    assert (order.numpy()[1, -300:] >= 1700).all()


def test_stage_shared_cpe_graph_equals_per_block_knn():
    """The stage's CPE graph (queried once and handed to its blocks) is
    ao_tpu's per-block knn_query(8) index for index, and a block given it
    gives what the block querying its own does."""
    coord, feat, mask = _sorted_scene(seed=3)
    idx, valid = T.cpe_graph(*_t(coord, mask))
    j_idx, _, j_valid = jax.jit(lambda c, m: jax_knn_query(8, c, m))(coord, mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    block = T.OctFormerBlock(16, 2, 8, dilation=2, rpe_grid=0.06)
    with torch.no_grad():
        torch.testing.assert_close(block(*_t(coord, feat, mask), (idx, valid)),
                                   block(*_t(coord, feat, mask)), rtol=0, atol=0)


@pytest.mark.parametrize("dilation", [1, 4], ids=["dilation-1", "dilation-4"])
def test_block_matches_jax(dilation):
    """OctFormerBlock (C=16, 2 heads, groups of 8, 0.06 m cells, the exact
    GELU): within 1e-5 of scale of ao_tpu's jitted block; invalid rows 0."""
    coord, feat, mask = _sorted_scene(seed=4)
    jb = J.OctFormerBlock(16, 2, 8, dilation, rpe_grid=0.06)
    var = _init(jb, coord, feat, mask)
    j = jax.jit(jb.apply)(var, coord, feat, mask)
    tb = _load(T.OctFormerBlock(16, 2, 8, dilation, rpe_grid=0.06),
               "stage0_block0", var["params"])
    t = tb(*_t(coord, feat, mask))
    assert _rel(t.detach(), j) <= 1e-5
    assert (t[~torch.from_numpy(mask)] == 0).all()


# ---------------------------------------------------------------- models


TINY = dict(type="OctFormer-v1m1", in_channels=6, num_classes=5,
            channels=(8, 16), num_heads=(2, 2), depths=(2, 2), patch_size=8,
            dilation=2, grid_sizes=(0.12,), stage_cap_ratios=(0.5,))


def _tiny_inputs(seed=10):
    rng = np.random.default_rng(seed)
    coord = (rng.uniform(0, 1, (2, 1024, 3)) * np.array([2.0, 2.0, 1.0])).astype(np.float32)
    mask = np.ones((2, 1024), bool)
    mask[1, -200:] = False
    feat = rng.normal(size=(2, 1024, 6)).astype(np.float32)
    labels = np.where(mask, rng.integers(-1, 5, mask.shape), -1)
    return coord, feat, mask, labels


def _morton_order(coord, mask):
    """ao_tpu's first-stage order: jnp.argsort of the Morton codes."""
    return np.asarray(jax.jit(lambda c, m: jnp.argsort(
        jax_morton_code(c, m), axis=1))(coord, mask))


def _unsort(x, order):
    """Rows of x (B, N, C) given in ``order`` put back in the input's."""
    out = np.empty_like(x)
    for b in range(len(x)):
        out[b, order[b]] = x[b]
    return out


def test_model_logits_match_jax_in_input_order():
    """A tiny OctFormer (2 stages, C 8 / 16, 2 heads, groups of 8, dilation 2
    on odd blocks) on 2 x 1024 points in eval mode: the port's logits, in
    the input's point order, within 1e-4 of scale of ao_tpu's jitted
    model's once these are put back from the first stage's Morton order,
    in which ao_tpu returns them (ROADMAP.md section 3)."""
    coord, feat, mask, _ = _tiny_inputs()
    jmodel = jax_build_model(dict(TINY))
    var = _init(jmodel, coord, feat, mask)
    j = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, True))(
        var, coord, feat, mask))
    tmodel = build_model(dict(TINY)).eval()
    tmodel.load_state_dict(flax_to_torch_state_dict(var["params"]), strict=True)
    with torch.no_grad():
        t = tmodel(*_t(coord, feat, mask)).numpy()
    order = _morton_order(coord, mask)
    assert _rel(t[mask], _unsort(j, order)[mask]) <= 1e-4
    assert _rel(t[mask], j[mask]) > 0.1  # ao_tpu's rows are the sorted points'
    assert int(tmodel.pool_overflow) > 0


def test_train_step_loss_and_gradients_match_jax():
    """One train step of the tiny OctFormer (drop path 0): the cross-entropy
    over the labelled points (ignore -1) within 1e-5 of ao_tpu's on its
    logits put back in the input's order, and every parameter's gradient,
    leaf by leaf, within 1e-4 of the L2 norm of jax.grad's, or of 1e-2 of
    the largest leaf's norm where that is larger (the key bias's gradient
    is 0 in exact arithmetic)."""
    coord, feat, mask, labels = _tiny_inputs(seed=12)
    jmodel = jax_build_model(dict(TINY))
    var = _init(jmodel, coord, feat, mask)
    order = _morton_order(coord, mask)
    # labels in the order of ao_tpu's logits
    sorted_labels = np.take_along_axis(labels, order, 1)
    valid = sorted_labels >= 0

    def jloss(p, coord, feat, mask):
        logits = jmodel.apply({"params": p}, coord, feat, mask, True)
        lp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(lp, jnp.maximum(sorted_labels, 0)[..., None], -1)[..., 0]
        return jnp.sum(jnp.where(valid, nll, 0.0)) / valid.sum()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(var["params"], coord, feat, mask)
    jg = flax_to_torch_state_dict(_np(jg))
    tmodel = build_model(dict(TINY, drop_path_rate=0.0)).train()
    tmodel.load_state_dict(flax_to_torch_state_dict(var["params"]), strict=True)
    logits = tmodel(*_t(coord, feat, mask))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 5), torch.from_numpy(labels).reshape(-1), ignore_index=-1)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    tg = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(tg) == set(jg) and "stage1_block1.attn.rpe_table" in tg
    floor = 1e-2 * max(float(g.norm()) for g in jg.values())
    for k, g in jg.items():
        assert float((tg[k] - g).norm()) <= 1e-4 * max(float(g.norm()), floor), k


def test_converter_round_trip():
    """ao_tpu's OctFormer variables (inside a DefaultSegmentor) load into
    the port's strictly, leaf for leaf: as many tensors as flax leaves,
    each equal to its flax array (Dense kernels transposed)."""
    coord, feat, mask, _ = _tiny_inputs()
    seg = dict(type="DefaultSegmentor", backbone=dict(TINY))
    variables = _init(jax_build_model(seg), coord, feat, mask)
    sd = flax_to_torch_state_dict(variables["params"])
    model = build_model(seg)
    model.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(sd) == len(leaves)
    assert len({np.asarray(v).tobytes() for v in leaves}) == len(leaves)
    p = variables["params"]["backbone"]
    pairs = {"backbone.stage1_block1.mlp.0.weight": p["stage1_block1"]["Dense_0"]["kernel"].T,
             "backbone.stage0_block0.norm1.bias": p["stage0_block0"]["LayerNorm_0"]["bias"],
             "backbone.stage0_block1.cpe_kernel": p["stage0_block1"]["cpe_kernel"],
             "backbone.seg_norm.weight": p["LayerNorm_0"]["scale"],
             "backbone.seg_out.weight": p["Dense_0"]["kernel"].T,
             "backbone.embed.weight": p["embed"]["kernel"].T}
    for k, v in pairs.items():
        assert np.array_equal(sd[k].numpy(), v), k
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ---------------------------------------------------------------- config


def test_blocks_keyword_groups_no_parameter():
    """The config's param_dicts = [dict(keyword="blocks", lr=0.00015)]: no
    flax path of ao_tpu's OctFormer and no name of the port's holds
    "blocks" (the blocks are ``stage{s}_block{d}``), so the port's second
    group is empty and every parameter trains at the config's lr 0.0015 in
    both (ao_tpu's Trainer drops top-level param_dicts as well): the tiny
    model's parameters after each of 5 AdamW steps of random gradients
    under the config's MultiStepWithWarmupLR within 1e-6 of ao_tpu's
    optax.multi_transform step (given the groups), and each step's lr the
    default group's."""
    from ao_tpu.utils.optimizer import _param_path_names
    from ao_tpu.utils.optimizer import build_optimizer as jax_build_optimizer

    cfg = Config.fromfile(CONFIG)
    assert cfg.param_dicts == [dict(keyword="blocks", lr=0.00015)]
    coord, feat, mask, _ = _tiny_inputs()
    shapes = jax.eval_shape(jax_build_model(dict(TINY)).init,
                            jax.random.PRNGKey(0), coord, feat, mask)["params"]
    assert not any("blocks" in n for n in _param_path_names(shapes))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    total = 40
    tx = jax_build_optimizer(dict(cfg.optimizer, param_dicts=cfg.param_dicts),
                             None, dict(cfg.scheduler), total)
    state = tx.init(params)
    update = jax.jit(tx.update)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    model = build_model(dict(TINY))
    model.load_state_dict(flax_to_torch_state_dict(params), strict=True)
    assert not any("blocks" in n for n, _ in model.named_parameters())
    opt = build_optimizer(cfg.optimizer, model, cfg.param_dicts)
    sched = build_scheduler(dict(cfg.scheduler), opt, total)
    assert [len(g["params"]) for g in opt.param_groups] == [
        len(list(model.parameters())), 0]
    for step in range(5):
        assert opt.param_groups[0]["lr"] > 0
        grads = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes)
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = flax_to_torch_state_dict(grads)
        for n, p in model.named_parameters():
            p.grad = tg[n]
        opt.step()
        sched.step()
        want = flax_to_torch_state_dict(_np(jp))
        for n, p in model.named_parameters():
            err = float((p.detach() - want[n]).abs().max())
            assert err <= 1e-6 * max(float(want[n].abs().max()), 1.0), (step, n)


def test_warmup_schedule_matches_jax():
    """The config's MultiStepWithWarmupLR (warmup over 5% of the steps from
    1e-5 of the lr, milestones 0.6 / 0.9, gamma 0.1): the port's lr at each
    of 100 steps within 1e-6 of the group's own lr of ao_tpu's (optax
    evaluates in f32, where the first step's 1 - (1 - 1e-5) cancels to
    1.0000134e-5), the warmup, both milestones and the empty group's own lr
    followed."""
    from ao_tpu.utils.optimizer import lr_at_step

    cfg = Config.fromfile(CONFIG)
    model = torch.nn.Linear(2, 2)
    opt = build_optimizer(cfg.optimizer, model, cfg.param_dicts)
    sched = build_scheduler(dict(cfg.scheduler), opt, 100)
    seen = []
    for k in range(100):
        want = lr_at_step(dict(cfg.scheduler), cfg.optimizer.lr, 100, k)
        got = opt.param_groups[0]["lr"]
        assert abs(got - want) <= 1e-6 * 0.0015, k
        want_g = lr_at_step(dict(cfg.scheduler), 0.00015, 100, k)
        assert abs(opt.param_groups[1]["lr"] - want_g) <= 1e-6 * 0.00015, k
        seen.append(got)
        opt.step()
        sched.step()
    assert seen[0] == pytest.approx(0.0015 * 1e-5) and max(seen) == pytest.approx(0.0015)
    assert seen[-1] == pytest.approx(0.0015 * 0.01)
