"""The SpUNet task heads of ao_tpu_torch against ao_tpu on the CPU: the
InstanceParser, ContrastiveViewsGenerator and RandomColorJitter
transforms with ao_tpu's draws fixed to the port's; tiny CAC-v1m1 (on
SpUNet and on PT-v2m2), PG-v1m1 and MSC-v1m1 / v1m2 with ao_tpu's
variables carried across by the converters (logits, running statistics,
losses, gradients); PointGroup's host proposals, the native clustering
and the AP evaluation equal to ao_tpu's; MSC's masks and matched pairs
bit for bit given JAX's own draws; and the chunked exact kNN against the
full stable sort."""

import functools
import importlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.datasets.transform as jt
import ao_tpu.ops.cluster as jcluster
from ao_tpu.engines import insseg_eval as jeval
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.models.context_aware_classifier.cac import (
    cac_distill_loss as jax_distill)
from ao_tpu.models.losses import build_criteria as jax_build_criteria
from ao_tpu.models.masked_scene_contrast import msc as jmsc
from ao_tpu.models.point_group import point_group as jpg
from ao_tpu.ops import knn as jax_knn
from ao_tpu_torch.datasets import transform as tt
from ao_tpu_torch.engines import insseg_eval as teval
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.context_aware_classifier import cac_distill_loss
from ao_tpu_torch.models.masked_scene_contrast import msc as tmsc
from ao_tpu_torch.models.point_group import point_group as tpg
from ao_tpu_torch.models.point_transformer_v2 import convert as ptv2_convert
from ao_tpu_torch.models.sparse_unet import convert
from ao_tpu_torch.ops import cluster as tcluster
from ao_tpu_torch.ops.knn import knn

# the module (the package's ``knn`` name is the function)
knn_mod = importlib.import_module("ao_tpu_torch.ops.knn")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_np = functools.partial(jax.tree_util.tree_map, np.asarray)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops: one intra-op thread (restored after), so
    that the test workers' thread pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_cluster_library(tmp_path_factory):
    """ao_tpu's clustering builds its library into native/ when it finds the
    source newer than the committed one; here it builds into a temporary
    directory instead, so that the tests leave native/ as it is."""
    saved = jcluster._LIB_PATH, jcluster._lib
    jcluster._LIB_PATH = str(tmp_path_factory.mktemp("native") / "libaocluster.so")
    jcluster._lib = None
    yield
    jcluster._LIB_PATH, jcluster._lib = saved


# ---------------------------------------------------------------- transforms


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3))
    coord = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    return dict(coord=coord, origin_coord=coord.copy(),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1,
                                                keepdims=True)).astype(np.float32),
                segment=rng.integers(-1, 20, n), instance=rng.integers(-1, 12, n))


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


def _jax_draws(monkeypatch, seed):
    """Make ao_tpu's transforms draw what the port's draw from a generator
    seeded with ``seed``, in the same order: random.random and
    np.random.uniform / rand / randn / randint / permutation as the port's
    torch.rand / randn / randint / randperm calls."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo=0.0, hi=1.0, size=None):
        n = 1 if size is None else size
        u = lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64).numpy()
        return u[0] if size is None else u

    def rand(*shape):
        return (uniform() if not shape else
                torch.rand(shape, generator=g, dtype=torch.float64).numpy())

    def randint(lo, hi=None, size=None):
        if hi is None:
            return int(torch.randint(0, lo, (1,), generator=g))
        return torch.randint(lo, hi, (size,), generator=g).numpy()

    monkeypatch.setattr(jt.random, "random", lambda: uniform())
    monkeypatch.setattr(jt.np.random, "uniform", uniform)
    monkeypatch.setattr(jt.np.random, "rand", rand)
    monkeypatch.setattr(jt.np.random, "randn", lambda *s: torch.randn(
        s, generator=g, dtype=torch.float64).numpy())
    monkeypatch.setattr(jt.np.random, "randint", randint)
    monkeypatch.setattr(jt.np.random, "permutation",
                        lambda n: torch.randperm(n, generator=g).numpy())


@pytest.mark.parametrize("ignore", [(-1, 0, 1), (-1,)])
def test_instance_parser_matches_jax(ignore):
    """InstanceParser with ScanNet's and S3DIS' ignored segments: the
    renumbered instances, the per-point centres and the boxes equal
    ao_tpu's (no draws)."""
    d = _cloud()
    t = tt.InstanceParser(segment_ignore_index=ignore)(_copy(d))
    j = jt.InstanceParser(segment_ignore_index=ignore)(_copy(d))
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    kept = ~np.isin(d["segment"], ignore)
    assert t["instance"][~kept].tolist() == [-1] * int((~kept).sum())
    assert t["bbox"].shape == (len(np.unique(d["instance"][kept])), 6)


@pytest.mark.parametrize("kw", [
    dict(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.02, p=0.8),
    dict(brightness=(0.5, 1.5), contrast=0.0, saturation=0.9, hue=0.5, p=1.0),
], ids=["msc-config", "wide"])
@pytest.mark.parametrize("seed", [3, 4])
def test_random_color_jitter_fixed_draws_match_jax(monkeypatch, kw, seed):
    """RandomColorJitter (the MSC configs' and a wide one with contrast
    off) with ao_tpu's draws fixed to the port's: the colours equal (the
    same float32 arithmetic in both) and changed."""
    d = _cloud(500, seed)
    t = tt.RandomColorJitter(generator=torch.Generator().manual_seed(seed), **kw)(
        _copy(d))
    _jax_draws(monkeypatch, seed)
    j = jt.RandomColorJitter(**kw)(_copy(d))
    np.testing.assert_array_equal(t["color"], j["color"])
    assert t["color"].dtype == np.float32
    assert not np.array_equal(t["color"], d["color"])


def test_contrastive_views_generator_fixed_draws_match_jax(monkeypatch):
    """ContrastiveViewsGenerator with the MSC config's view pipeline
    (rotations, flip, jitter, colour jitter, chromatic jitter, GridSample
    with discrete coords, SphereCrop at 0.6, CenterShift, NormalizeColor)
    with ao_tpu's draws fixed to the port's: every view array within 1e-6
    (measured 0) and the two views different."""
    from ao_tpu_torch.utils import Config

    cfg = Config.fromfile(os.path.join(ROOT, "configs", "scannet",
                                       "pretrain-msc-v1m1-0-spunet-base.py"))
    view = [dict(v) for v in cfg._view_aug]
    view[-4] = dict(view[-4], grid_size=0.05)  # GridSample: a smaller sample
    keys = ("coord", "color", "normal", "origin_coord")
    d = _cloud()
    t = tt.ContrastiveViewsGenerator(keys, view,
                                     generator=torch.Generator().manual_seed(7))(_copy(d))
    _jax_draws(monkeypatch, 7)
    j = jt.ContrastiveViewsGenerator(keys, view)(_copy(d))
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape, k
        assert np.abs(t[k].astype(np.float64) - j[k]).max() <= 1e-6, k
    assert t["view1_coord"].shape != t["view2_coord"].shape or not np.array_equal(
        t["view1_coord"], t["view2_coord"])
    assert t["view1_discrete_coord"].shape[0] == len(t["view1_origin_coord"])


# ---------------------------------------------------------------- models

_BB = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
           channels=(8, 8, 8, 8), layers=(1, 1, 1, 1), stage_cap_ratios=(0.5, 0.5))
_K = 5


def _inputs(seed=4, B=2, M=256, extent=7):
    """(coord, feat, mask, segment): integer sites in grid units with a
    jitter (the heads' backbones voxelise floor(coord - min) in both
    packages), scene 0's last 56 rows repeating its first 56, scene 1's
    last 56 padding, labels in -1..K-1."""
    rng = np.random.default_rng(seed)
    dc = rng.integers(0, extent, (B, M, 3))
    dc[0, M - 56:] = dc[0, :56]
    mask = np.ones((B, M), bool)
    mask[1, M - 56:] = False
    coord = (dc + rng.uniform(0.05, 0.95, dc.shape)).astype(np.float32)
    feat = rng.normal(size=(B, M, 6)).astype(np.float32)
    segment = rng.integers(-1, _K, (B, M)).astype(np.int32)
    return coord, feat, mask, segment


def _variables(module, init, seed):
    """Random variables of ``module`` in the shapes ``init`` gives: kernels
    of He scale, BatchNorm scales and running variances in [0.5, 1.5],
    the rest 0.1-scaled normals."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel" or leaf.endswith("_kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    var = jax.tree_util.tree_map_with_path(draw, shapes)
    return {k: var[k] for k in ("params", "batch_stats")}


def _rel(t, j, mask=None):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j, np.float32)
    if mask is not None:
        t, j = t[mask], j[mask]
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1.0))


def _check_stats(model, var, mut, tol=1e-5):
    sd = model.state_dict()
    ref = convert.from_jax_variables(_np(dict(params=var["params"],
                                              batch_stats=mut["batch_stats"])))
    stats = [k for k in ref if "running" in k]
    for k in stats:
        v = ref[k].numpy()
        assert np.abs(sd[k].numpy() - v).max() <= tol * max(np.abs(v).max(), 1.0), k
    return stats


_CAC = dict(num_classes=_K, backbone_out_channels=8, cos_temp=15.0,
            main_weight=1.0, pre_weight=0.7, pre_self_weight=0.4, kl_weight=1.3)
_CAC_CASES = {"conf-detach": dict(conf_thresh=0.3, detach_pre_logits=True),
              "plain": dict(conf_thresh=0.0, detach_pre_logits=False)}
_CRITERIA = {"ce": None,
             "ce-lovasz": [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
                           dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0,
                                ignore_index=-1)]}


@functools.lru_cache(maxsize=None)
def _jax_cac(case):
    module = jax_build_model(dict(type="CAC-v1m1", backbone=dict(_BB), **_CAC,
                                  **_CAC_CASES[case]))
    coord, feat, mask, seg = _inputs()
    init = functools.partial(module.init, coord=jnp.asarray(coord),
                             feat=jnp.asarray(feat), mask=jnp.asarray(mask),
                             target=jnp.asarray(seg))
    return module, _variables(module, lambda k: init(k), list(_CAC_CASES).index(case))


def _port_cac(case, var, criteria=None):
    model = build_model(dict(type="CAC-v1m1", backbone=dict(_BB), **_CAC,
                             **_CAC_CASES[case], criteria=criteria))
    model.load_state_dict(convert.from_jax_variables(_np(var)), strict=True)
    return model


@functools.partial(jax.jit, static_argnums=(0, 2))
def _jax_cac_apply(module, var, train, coord, feat, mask, seg):
    if train:
        return module.apply(var, coord, feat, mask, True, False, target=seg,
                            mutable=["batch_stats"])
    return module.apply(var, coord, feat, mask, True, True), None


def _jax_cac_loss(module, crit, var, params, coord, feat, mask, seg):
    """The reference's four terms composed from ao_tpu's outputs, its
    criteria and cac_distill_loss."""
    out, mut = module.apply(dict(var, params=params), coord, feat, mask, True,
                            False, target=seg, mutable=["batch_stats"])
    terms = dict(
        seg_loss=crit(out["seg_logits"], seg, mask) * module.main_weight,
        pre_loss=crit(out["cac_pred"], seg, mask) * module.pre_weight,
        pre_self_loss=crit(out["pre_logits"], seg, mask) * module.pre_self_weight,
        kl_loss=jax_distill(out["seg_logits"], jax.lax.stop_gradient(out["cac_pred"]),
                            seg, mask) * module.kl_weight)
    return sum(terms.values()), (terms, mut)


@pytest.mark.parametrize("case", list(_CAC_CASES))
def test_cac_matches_jax(case):
    """Tiny CAC-v1m1 on SpUNet with ao_tpu's variables carried across by
    from_jax_variables (strict; the head's seg_head / proj / apd_proj /
    feat_proj_layer names). Eval: seg_logits (refined) and pre_logits
    within 1e-4 of scale. Train (batch statistics, with segment):
    seg_logits, pre_logits and cac_pred within 1e-3 of scale (measured up
    to 4.3e-6 in either mode), and the running statistics of the backbone
    and of feat_proj_layer's BatchNorm (two updates a step, one per
    branch, in both packages) within 1e-5 (up to 1.7e-7)."""
    module, var = _jax_cac(case)
    coord, feat, mask, seg = _inputs()
    args = [jnp.asarray(a) for a in (coord, feat, mask, seg)]
    targs = [torch.from_numpy(a) for a in (coord, feat, mask, seg)]
    model = _port_cac(case, var)
    jout, _ = _jax_cac_apply(module, var, False, *args)
    with torch.no_grad():
        tout = model.eval()(*targs[:3])
    assert set(tout) == {"seg_logits", "pre_logits"}
    for k in tout:
        assert _rel(tout[k], jout[k], mask) < 1e-4, k
    jout, mut = _jax_cac_apply(module, var, True, *args)
    with torch.no_grad():
        tout = model.train()(*targs[:3], segment=targs[3])
    for k in ("seg_logits", "pre_logits", "cac_pred"):
        assert _rel(tout[k], jout[k], mask) < 1e-3, k
    stats = _check_stats(model, var, mut)
    assert "feat_proj_layer.1.norm.running_mean" in stats


@pytest.mark.parametrize("crit", list(_CRITERIA))
def test_cac_loss_matches_composed_jax(crit):
    """The port's CAC owns its loss: main_weight crit(refined) + pre_weight
    crit(cac_pred) + pre_self_weight crit(pre_logits) + kl_weight
    cac_distill_loss(refined, cac_pred detached), each term within 1e-4
    of scale (measured up to 9.2e-8) of the sum composed from ao_tpu's
    train-mode outputs, ao_tpu's criteria (CE by default, as the base
    configs name none; CE + Lovasz as the lovasz configs) and its
    cac_distill_loss; eval mode with segment reports crit(refined)."""
    module, var = _jax_cac("conf-detach")
    coord, feat, mask, seg = _inputs()
    args = [jnp.asarray(a) for a in (coord, feat, mask, seg)]
    targs = [torch.from_numpy(a) for a in (coord, feat, mask, seg)]
    jcrit = jax_build_criteria(_CRITERIA[crit] or [
        dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
    jloss, (jterms, _) = jax.jit(functools.partial(_jax_cac_loss, module, jcrit))(
        var, var["params"], *args)
    model = _port_cac("conf-detach", var, _CRITERIA[crit])
    with torch.no_grad():
        tout = model.train()(*targs[:3], segment=targs[3])
    for k, v in jterms.items():
        assert abs(float(tout[k]) - float(v)) <= 1e-4 * max(abs(float(v)), 1.0), k
    assert abs(float(tout["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))
    with torch.no_grad():
        ev = model.eval()(*targs[:3], segment=targs[3])
    assert float(ev["loss"]) == pytest.approx(
        float(model.criteria(ev["seg_logits"], targs[3].long(), targs[2])))


def test_cac_gradients_match_jax():
    """The gradients of the four-term loss of the tiny CAC (train mode)
    against jax.grad of the loss composed from ao_tpu's pieces, every
    parameter within 1e-3 of its own scale (measured up to 5.6e-6),
    mapped onto the port's names by from_jax_variables."""
    module, var = _jax_cac("conf-detach")
    coord, feat, mask, seg = _inputs()
    args = [jnp.asarray(a) for a in (coord, feat, mask, seg)]
    jcrit = jax_build_criteria([dict(type="CrossEntropyLoss", ignore_index=-1)])
    grads = jax.jit(jax.grad(functools.partial(_jax_cac_loss, module, jcrit),
                             argnums=1, has_aux=True))(var, var["params"], *args)[0]
    grads = convert.from_jax_variables(_np(grads))
    model = _port_cac("conf-detach", var)
    out = model.train()(*(torch.from_numpy(a) for a in (coord, feat, mask)),
                        segment=torch.from_numpy(seg))
    out["loss"].backward()
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        g = g.numpy()
        assert np.abs(named[k].grad.numpy() - g).max() <= 1e-3 * np.abs(g).max(), k


_PTV2 = dict(type="PT-v2m2", in_channels=6, num_classes=0, patch_embed_channels=16,
             patch_embed_groups=2, patch_embed_neighbours=8, enc_depths=(1, 1),
             enc_channels=(16, 32), enc_groups=(2, 4), enc_neighbours=(8, 8),
             dec_depths=(1, 1), dec_channels=(16, 16), dec_groups=(2, 2),
             dec_neighbours=(8, 8), grid_sizes=(0.15, 0.375),
             unpool_backend="map", stage_cap_ratios=(0.35, 0.35))


def test_cac_on_ptv2m2_matches_jax():
    """CAC-v1m1 on a narrow two-stage PT-v2m2 (the backbone of the
    semseg-cac-v1m1-2-ptv2-lovasz configs), weights carried across by
    point_transformer_v2.convert.from_jax_variables with the head mapped
    beside the backbone: eval seg_logits and pre_logits within 1e-4 of
    scale (measured up to 4.2e-7)."""
    rng = np.random.default_rng(8)
    coord = rng.uniform(0, 1.5, (2, 512, 3)).astype(np.float32)
    feat = rng.normal(size=(2, 512, 6)).astype(np.float32)
    mask = np.ones((2, 512), bool)
    mask[1, 400:] = False
    cfg = dict(type="CAC-v1m1", backbone=dict(_PTV2), **dict(_CAC, backbone_out_channels=16))
    module = jax_build_model(dict(cfg))
    args = [jnp.asarray(a) for a in (coord, feat, mask)]
    seg = jnp.asarray(np.random.default_rng(9).integers(-1, _K, (2, 512)), jnp.int32)
    var = jax.jit(lambda k, a, s: module.init(k, *a, target=s))(
        jax.random.PRNGKey(1), args, seg)
    var = _np(dict(params=var["params"], batch_stats=var["batch_stats"]))
    model = build_model(dict(cfg))
    model.load_state_dict(ptv2_convert.from_jax_variables(
        var["params"], var["batch_stats"]), strict=True)
    jout = jax.jit(lambda v, a: module.apply(v, *a, True, True))(var, args)
    with torch.no_grad():
        tout = model.eval()(*(torch.from_numpy(a) for a in (coord, feat, mask)))
    for k in ("seg_logits", "pre_logits"):
        assert _rel(tout[k], jout[k], mask) < 1e-4, k


# ---------------------------------------------------------------- PointGroup

_PG = dict(type="PG-v1m1", backbone=dict(_BB), backbone_out_channels=8,
           semantic_num_classes=_K)


def test_point_group_matches_jax():
    """Tiny PG-v1m1 with ao_tpu's variables (bias_head / seg_head names):
    eval seg_logits and bias_pred within 1e-4 of scale; train mode within
    1e-3 (measured up to 9.9e-7 in either mode), point_group_loss's terms
    on those outputs within 1e-4 of scale (up to 1.7e-7; ignored instances
    and padding excluded), the running statistics, the bias head's
    BatchNorm (eps 1e-3, momentum 0.01) among them, within 1e-5."""
    coord, feat, mask, seg = _inputs(5)
    rng = np.random.default_rng(9)
    instance = np.where(seg >= 1, rng.integers(-1, 6, seg.shape), -1).astype(np.int32)
    center = (coord + rng.normal(size=coord.shape)).astype(np.float32)
    module = jax_build_model(dict(_PG))
    args = [jnp.asarray(a) for a in (coord, feat, mask)]
    var = _variables(module, lambda k: module.init(k, *args), 11)
    model = build_model(dict(_PG))
    model.load_state_dict(convert.from_jax_variables(_np(var)), strict=True)
    targs = [torch.from_numpy(a) for a in (coord, feat, mask)]
    jout = jax.jit(lambda v, a: module.apply(v, *a, True, True))(var, args)
    with torch.no_grad():
        tout = model.eval()(*targs)
    for t, j in zip(tout, jout):
        assert _rel(t, j, mask) < 1e-4

    def jax_train(v, args, seg, instance, center):
        (s, b), mut = module.apply(v, *args, True, False, mutable=["batch_stats"])
        return (s, b), mut, jpg.point_group_loss(s, b, args[0], seg, instance,
                                                 center, args[2])

    (js, jb), mut, jl = jax.jit(jax_train)(var, args, *(jnp.asarray(a) for a in (
        seg, instance, center)))
    with torch.no_grad():
        ts, tb = model.train()(*targs)
        tl = tpg.point_group_loss(ts, tb, targs[0], torch.from_numpy(seg),
                                  torch.from_numpy(instance),
                                  torch.from_numpy(center), targs[2])
    assert _rel(ts, js, mask) < 1e-3 and _rel(tb, jb, mask) < 1e-3
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-4 * max(abs(float(jl[k])), 1.0), k
    assert "bias_head.1.norm.running_var" in _check_stats(model, var, mut)
    # the port's own loss on ao_tpu's outputs: the same function
    tl = tpg.point_group_loss(*(torch.from_numpy(np.asarray(a)) for a in (
        js, jb, coord, seg, instance, center, mask)))
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * max(abs(float(jl[k])), 1.0), k


def _proposal_scene(seed, n_inst=6, per=150):
    """Logits and offsets of a scene whose instances form clusters: each
    instance's points sit near its centre after the offsets, its class
    argmax-dominant; some points scattered (class 0, ignored), some
    instances small (dropped below cluster_propose_points)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 4, (n_inst, 3))
    sizes = rng.integers(60, per + 60, n_inst)
    coord, bias, cls = [], [], []
    for i, (c, n) in enumerate(zip(centers, sizes)):
        pts = c + rng.normal(0, 0.3, (n, 3))
        coord.append(pts)
        bias.append(c - pts + rng.normal(0, 0.004, (n, 3)))
        cls.append(np.full(n, 2 + i % 3))
    noise = rng.uniform(0, 4, (80, 3))
    coord = np.concatenate(coord + [noise]).astype(np.float32)
    bias = np.concatenate(bias + [rng.normal(0, 0.5, (80, 3))]).astype(np.float32)
    cls = np.concatenate(cls + [np.zeros(80, int)])
    logits = rng.normal(0, 1, (len(cls), 6)).astype(np.float32)
    logits[np.arange(len(cls)), cls] += 4.0
    return logits, bias, coord


@pytest.mark.parametrize("seed,kw", [
    (0, dict()), (1, dict(cluster_min_points=20, cluster_propose_points=50)),
    (2, dict(segment_ignore_index=(-1,), cluster_thresh=2.5)),
    (3, dict(segment_ignore_index=tuple(range(6)))),
], ids=["scannet", "small", "s3dis", "all-ignored"])
def test_propose_instances_matches_jax(seed, kw):
    """propose_instances on the same host logits, offsets and coords, with
    the port's clustering library (built into ao_tpu_torch/_build/) against
    ao_tpu's: masks, classes and scores equal; the scenes make proposals
    (but the one whose classes are all ignored)."""
    logits, bias, coord = _proposal_scene(seed)
    t = tpg.propose_instances(logits, bias, coord, **kw)
    j = jpg.propose_instances(logits, bias, coord, **kw)
    for k in ("pred_masks", "pred_classes", "pred_scores"):
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (len(t["pred_classes"]) == 0) == (seed == 3)


def test_bfs_cluster_matches_jax_and_builds_outside_native():
    """The port's bfs_cluster (its copy of native/cluster.cpp, compiled
    into ao_tpu_torch/_build/host-<hash>/) equals ao_tpu's on random
    labelled clouds with batch ids; the source is the same C++ as
    native/cluster.cpp below its header comment."""
    rng = np.random.default_rng(3)
    for n, radius, min_points in ((2000, 0.6, 5), (5000, 0.4, 20)):
        coord = rng.uniform(0, 4, (n, 3)).astype(np.float32)
        sem = rng.integers(-1, 4, n).astype(np.int32)
        batch = rng.integers(0, 2, n).astype(np.int32)
        t = tcluster.bfs_cluster(coord, sem, batch, radius, min_points)
        j = jcluster.bfs_cluster(coord, sem, batch, radius, min_points)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1] > 0
    assert tcluster.library_path().parent.parent == tcluster.BUILD_DIR
    with open(tcluster.SOURCE) as f:
        ours = f.read()
    with open(os.path.join(ROOT, "native", "cluster.cpp")) as f:
        theirs = f.read()
    assert ours[ours.index("#include"):] == theirs[theirs.index("#include"):]


def _engine_scenes(mod):
    """The scenes of tests/test_engine_extra.py, built by ``mod``'s
    associate_instances, and one of two scenes with several classes."""
    def scene(masks, classes, scores, segment, instance):
        pred = dict(pred_masks=np.asarray(masks, np.uint8),
                    pred_classes=np.asarray(classes),
                    pred_scores=np.asarray(scores, np.float32))
        gt, pr = mod.associate_instances(
            pred, np.asarray(segment), np.asarray(instance), 4,
            ("wall", "floor", "chair", "table"), segment_ignore_index=(-1, 0),
            min_region_size=10)
        return dict(gt=gt, pred=pr)

    out = []
    seg, inst = np.full(200, 2), np.zeros(200, np.int64)
    inst[100:] = 1
    m = np.zeros((2, 200), np.uint8)
    m[0, :100], m[1, 100:] = 1, 1
    out.append([scene(m, [2, 2], [0.9, 0.8], seg, inst)])
    out.append([scene(np.ones((1, 100)), [3], [0.9], np.full(100, 2),
                      np.zeros(100, np.int64))])
    m = np.zeros((1, 100), np.uint8)
    m[0, :60] = 1
    out.append([scene(m, [2], [0.9], np.full(100, 2), np.zeros(100, np.int64))])
    m = np.zeros((1, 200), np.uint8)
    m[0, :100] = 1
    out.append([scene(m, [2], [0.9], seg, inst)])
    seg = np.full(100, -1)
    seg[:20] = 2
    inst = np.full(100, -1, np.int64)
    inst[:20] = 0
    out.append([scene(np.ones((1, 100)), [2], [0.9], seg, inst)])
    rng = np.random.default_rng(5)
    many = []
    for _ in range(2):
        seg = rng.integers(-1, 4, 600)
        inst = rng.integers(0, 8, 600)
        masks = (rng.random((7, 600)) < 0.2).astype(np.uint8)
        masks[:3] |= (inst == 1).astype(np.uint8)[None]
        many.append(scene(masks, rng.integers(0, 4, 7), rng.random(7), seg, inst))
    out.append(many)
    return out


@pytest.mark.parametrize("i", range(6), ids=["perfect", "wrong-class", "iou-0.6",
                                             "missed", "void", "two-scenes"])
def test_insseg_evaluation_matches_jax(i):
    """associate_instances, evaluate_matches and ap_scores (the port's copy
    of ao_tpu/engines/insseg_eval.py) on the scenes tests/
    test_engine_extra.py builds and on two random scenes of several
    classes: the AP tables equal ao_tpu's (NaN where ao_tpu's are) and the
    scores equal."""
    names = ["floor", "chair", "table"]
    t_scenes, j_scenes = _engine_scenes(teval)[i], _engine_scenes(jeval)[i]
    assert t_scenes == j_scenes
    t = teval.evaluate_matches(t_scenes, names, min_region_size=10)
    j = jeval.evaluate_matches(j_scenes, names, min_region_size=10)
    np.testing.assert_array_equal(t, j)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # nanmean of NaN rows
        assert str(teval.ap_scores(t, names)) == str(jeval.ap_scores(j, names))


# ---------------------------------------------------------------- MSC


def _views(seed=6, B=2, N=256, n=200):
    """Two views per scene: origin coords on a 0.02 m lattice (two random
    subsets of one 12 x 12 x 4 block, the second jittered by up to 5 mm),
    view coords in grid units, features, colours, normals; the last
    N - n rows padding."""
    rng = np.random.default_rng(seed)
    sites = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(4),
                                 indexing="ij"), -1).reshape(-1, 3)
    out = {}
    for v in (1, 2):
        origin = np.zeros((B, N, 3), np.float32)
        for b in range(B):
            pick = sites[rng.choice(len(sites), n, replace=False)] * 0.02
            if v == 2:
                pick = pick + rng.uniform(-0.005, 0.005, pick.shape)
            origin[b, :n] = pick
        mask = np.zeros((B, N), bool)
        mask[:, :n] = True
        out[f"view{v}_origin_coord"] = origin
        out[f"view{v}_coord"] = (origin / 0.02 + 0.3 * v).astype(np.float32) * mask[..., None]
        out[f"view{v}_feat"] = rng.normal(size=(B, N, 6)).astype(np.float32)
        out[f"view{v}_mask"] = mask
        out[f"view{v}_color"] = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
        out[f"view{v}_normal"] = rng.normal(size=(B, N, 3)).astype(np.float32)
    return out


_ARGS = ("view1_origin_coord", "view1_coord", "view1_feat", "view1_mask",
         "view2_origin_coord", "view2_coord", "view2_feat", "view2_mask",
         "view1_color", "view1_normal", "view2_color", "view2_normal")
_MSC = dict(backbone=dict(_BB, channels=(8, 8), layers=(1, 1), stage_cap_ratios=(0.5,)),
            backbone_in_channels=6, backbone_out_channels=8,
            matching_max_pair=64, mask_rate=0.4, mask_grid_size=0.1)


def _capture_draws(monkeypatch):
    """Record every jax.random.randint / uniform result (tracers while a
    function traces), so that a jitted MSC apply can return its draws."""
    seen = []
    for name in ("randint", "uniform"):
        fn = getattr(jax.random, name)

        def wrapped(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            seen.append(out)
            return out

        monkeypatch.setattr(jax.random, name, wrapped)
    return seen


@pytest.mark.parametrize("kind", ["MSC-v1m1", "MSC-v1m2"])
def test_msc_matches_jax(monkeypatch, kind):
    """Tiny MSC-v1m1 and MSC-v1m2 (CSC) on SpUNet in train mode with
    ao_tpu's variables carried across (mask_token, colour and normal heads)
    and JAX's own draws of the step (the seed from make_rng("mask"), the
    pick and subset uniforms from one key) passed to the port's forward:
    the cross masks equal ao_tpu's patch tags' bit for bit, the matched
    rows, partners and validity equal the JAX package's matching (its kNN,
    argmax and lax.top_k) bit for bit, and the NCE, colour, normal and
    total losses and pos_sim within 1e-4 of scale (measured up to 1.7e-7),
    the running statistics within 1e-5."""
    v = _views()
    args = tuple(jnp.asarray(v[k]) for k in _ARGS)
    module = jax_build_model(dict(_MSC, type=kind))
    var = _variables(module, lambda k: module.init(
        {"params": k, "mask": k}, *args), 12)
    seen = _capture_draws(monkeypatch)

    @jax.jit
    def run(var, key, args):
        seen.clear()
        out, mut = module.apply(var, *args, False, False, rngs={"mask": key},
                                mutable=["batch_stats"])
        return out, mut, list(seen)

    jout, mut, draws = run(var, jax.random.PRNGKey(3), args)
    B, N = v["view1_mask"].shape
    seed = int(next(d for d in draws if d.shape == () and d.dtype == jnp.int32))
    r_pick = np.asarray(next(d for d in draws if d.shape == (B, N, 8)))
    r_row = np.asarray(next(d for d in draws if d.shape == (B, N)))
    model = build_model(dict(_MSC, type=kind))
    model.load_state_dict(convert.from_jax_variables(_np(var)), strict=True)
    tin = {k: torch.from_numpy(v[k]) for k in _ARGS}
    with torch.no_grad():
        tout = model.train()(**tin, draws=(seed, torch.from_numpy(r_pick),
                                           torch.from_numpy(r_row)))
    for k in ("nce_loss", "color_loss", "normal_loss", "loss", "pos_sim"):
        assert _rel(tout[k], jout[k]) < 1e-4, k
    _check_stats(model, var, mut)

    # the masks: ao_tpu's patch tags with the step's seed
    jseed = jnp.int32(seed)
    t1 = jmsc._patch_tag(args[0], args[3], 0.1, jseed)
    t2 = jmsc._patch_tag(args[4], args[7], 0.1, jseed)
    np.testing.assert_array_equal(tout["mask1"].numpy(), np.asarray((t1 < 0.4) & args[3]))
    np.testing.assert_array_equal(tout["mask2"].numpy(), np.asarray(
        (t2 >= 0.4) & (t2 < 0.8) & args[7]))
    assert 0 < int(tout["mask1"].sum()) < int(v["view1_mask"].sum())

    # the pairs: msc.py's matching, with the JAX package's kNN and top_k
    idx, dist, valid = jax_knn(args[0], args[4], 8, args[3], args[7])
    in_radius = valid & (dist < 0.03)
    pick = jnp.argmax(jnp.where(in_radius, r_pick, -1.0), axis=-1)
    picked = jnp.take_along_axis(idx, pick[..., None], axis=-1)[..., 0]
    row_valid = jnp.any(in_radius, axis=-1)
    _, rows = jax.lax.top_k(jnp.where(row_valid, r_row, -1.0), 64)
    rows_t, v2_t, valid_t = tmsc.match_pairs(
        *(tin[k] for k in ("view1_origin_coord", "view2_origin_coord",
                           "view1_mask", "view2_mask")),
        8, 0.03, 64, torch.from_numpy(r_pick), torch.from_numpy(r_row))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(v2_t.numpy(), np.asarray(
        jnp.take_along_axis(picked, rows, axis=1)))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(
        jnp.take_along_axis(row_valid, rows, axis=1)))
    assert int(tout["pairs"]) == int(valid_t.sum()) > 32


def test_patch_tag_wraps_as_jax():
    """The patch tags far from the origin, where the grid key's int32
    products wrap (d_y * 83492791 beyond 2^31 once d_y > 25, 2.6 m at
    0.1 m), and at seeds up to 2^31 - 2: bit for bit ao_tpu's _patch_tag."""
    rng = np.random.default_rng(2)
    coord = rng.uniform(0, 40, (2, 4096, 3)).astype(np.float32)
    mask = rng.random((2, 4096)) < 0.9
    for seed in (0, 12345, 2**31 - 2):
        j = jax.jit(jmsc._patch_tag, static_argnums=2)(
            jnp.asarray(coord), jnp.asarray(mask), 0.1, jnp.int32(seed))
        t = tmsc.patch_tag(torch.from_numpy(coord), torch.from_numpy(mask), 0.1, seed)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------- kNN


def _lattice(seed, B=2, M=300, N=500, extent=4):
    """Query and key points on a small integer lattice (exact scores, many
    ties) with masks."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, extent, (B, M, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, extent, (B, N, 3)).astype(np.float32)),
            torch.from_numpy(rng.random((B, M)) > 0.1),
            torch.from_numpy(rng.random((B, N)) > 0.1))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunked_knn_equals_full_stable_sort(monkeypatch, k):
    """The chunked path (CHUNK_ELEMENTS set to 4096 scores: 8 query rows a
    chunk) against the full stable sort on lattice points: the distances and
    validity equal; every id equal where its score is below the k-th
    (ties inside the k ordered by index, as the stable sort orders them),
    and at the k-th score an id of the same distance; on clouds without
    ties, every id equal. The JAX package's tiled kNN gives the full
    sort's ids."""
    q, kc, qm, km = _lattice(k)
    full = knn(q, kc, k, qm, km)
    monkeypatch.setattr(knn_mod, "CHUNK_ELEMENTS", 4096)
    chunk = knn(q, kc, k, qm, km)
    for a, b in zip(full[1:], chunk[1:]):
        assert torch.equal(a, b)
    kth = full[1][..., -1:]
    below = (full[1] < kth) & full[2]
    assert torch.equal(full[0][below], chunk[0][below])
    sel = torch.gather(kc[:, None].expand(-1, q.shape[1], -1, -1), 2,
                       chunk[0].long()[..., None].expand(-1, -1, -1, 3))
    assert torch.equal(torch.sqrt(((sel - q[:, :, None]) ** 2).sum(-1))[full[2]],
                       full[1][full[2]])
    j = jax_knn(*(jnp.asarray(x.numpy()) for x in (q, kc)), k,
                *(jnp.asarray(x.numpy()) for x in (qm, km)))
    np.testing.assert_array_equal(np.asarray(j[0]), full[0].numpy())
    rng = np.random.default_rng(k)
    q, kc = (torch.from_numpy(rng.uniform(0, 4, s).astype(np.float32))
             for s in ((2, 300, 3), (2, 500, 3)))
    chunk = knn(q, kc, k)
    monkeypatch.setattr(knn_mod, "CHUNK_ELEMENTS", 2**28)
    for a, b in zip(knn(q, kc, k), chunk):
        assert torch.equal(a, b)


def test_chunked_knn_tie_across_the_kth_place(monkeypatch):
    """Pinned: six keys tied at distance 1 from the query (and one nearer),
    k = 3. The full stable sort and the JAX package's tiled merge keep
    the lowest indices [7, 0, 1]; so does the chunked path, which takes a
    row tied across its k-th place again from its full stable sort
    (torch.topk alone keeps its own choice among the tied, on the CPU
    [7, 0, 4])."""
    kc = torch.tensor([[[1., 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
                        [0, 0, -1], [2, 0, 0], [0, 0, 0.5]]])
    q = torch.zeros(1, 2, 3)
    full = knn(q, kc, 3)
    monkeypatch.setattr(knn_mod, "CHUNK_ELEMENTS", 8)
    chunk = knn(q, kc, 3)
    assert full[0][0].tolist() == [[7, 0, 1]] * 2
    assert chunk[0][0].tolist() == [[7, 0, 1]] * 2
    assert torch.topk(((kc[0] - q[0, :1]) ** 2).sum(-1), 3, largest=False
                      )[1].tolist() == [7, 0, 4]
    assert torch.equal(full[1], chunk[1])
    j = jax_knn(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()), 3)
    assert np.asarray(j[0])[0].tolist() == [[7, 0, 1]] * 2
