"""The modules of ao_tpu_torch that the ScanNet PT-v2m2 config needs, against
ao_tpu's on the same inputs: the five lr schedules the port lacked (OneCycle
first), Mix3D collation, RandomDropout / RandomRotate /
RandomRotateTargetAngle / ElasticDistortion with the same draws, ScanNet's
limited-annotation sampled_index through dropout and grid sampling, the
ScanNet / ScanNet200 datasets with their lr_file / la_file modes, the
Lovasz loss, the GVA kernels' S = 8 calls widened to the S = 16 instances,
a narrow ScanNet-shaped backbone on the card's dispatch, and two configs
that now train on the port (two CPU steps each)."""

import functools
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.datasets.collate as jc
import ao_tpu.datasets.transform as jt
import ao_tpu.models.point_transformer_v2.ptv2m2 as jm
import chip_smoke
from ao_tpu.datasets.scannet import ScanNet200Dataset as JScanNet200
from ao_tpu.datasets.scannet import ScanNetDataset as JScanNet
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.models.losses.lovasz import LovaszLoss as JLovasz
from ao_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from ao_tpu_torch.datasets import collate as tc
from ao_tpu_torch.datasets import transform as tt
from ao_tpu_torch.datasets.scannet import ScanNet200Dataset, ScanNetDataset
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.losses.lovasz import LovaszLoss
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.ops import gva as tg
from ao_tpu_torch.tools.check_gva_bwd import random_graph
from ao_tpu_torch.utils.scheduler import build_scheduler, onecycle_lr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_np = functools.partial(jax.tree_util.tree_map, np.asarray)


# ---------------------------------------------------------------- schedules

_ONECYCLE = dict(type="OneCycleLR", max_lr=0.005, pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=1e4)


@pytest.mark.parametrize("cfg,base,total", [
    pytest.param(_ONECYCLE, 0.005, 300, id="OneCycle"),
    # T = 10: int(0.05 T) = 0, the warmup clamps to 1 step; a list max_lr
    pytest.param(dict(_ONECYCLE, max_lr=[0.002, 0.0002]), 0.002, 10,
                 id="OneCycle-warmup-clamp"),
    pytest.param(dict(_ONECYCLE, pct_start=0.9), 0.005, 2, id="OneCycle-T2"),
    pytest.param(_ONECYCLE, 0.005, 1, id="OneCycle-T1"),
    pytest.param(dict(type="MultiStepWithWarmupLR", milestones=[0.6, 0.8],
                      gamma=0.1, warmup_rate=0.05, warmup_scale=1e-6),
                 0.005, 200, id="MultiStepWithWarmup"),
    pytest.param(dict(type="PolyLR", power=0.9), 0.1, 200, id="Poly"),
    pytest.param(dict(type="ExpLR", gamma=0.9), 0.1, 200, id="Exp"),
    pytest.param(dict(type="CosineAnnealingLR", eta_min=1e-5), 0.05, 200,
                 id="CosineAnnealing"),
])
def test_schedule_matches_optax_at_every_step(cfg, base, total):
    """The port's LambdaLR against ao_tpu's optax schedule at every step
    (OneCycle also three past the last). The reference evaluates in float32, so its
    values carry float32 rounding of the peak lr: within 2^-22 (two float32
    units) of the schedule's peak at every step (measured 2.2e-8 to
    1.2e-7 of the peak); relative to the lr itself the float32 reference
    is off by up to 1.3e-2 near zero lr, where the port evaluates in
    float64. OneCycle at T <= 1 is constant max_lr."""
    sched = jax_build_scheduler(dict(cfg), base_lr=base, total_steps=total)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=base)
    tsched = build_scheduler(dict(cfg), opt, total)
    # OneCycle is defined past its last step as well (its final lr)
    steps = total + 3 if cfg["type"] == "OneCycleLR" else total
    ref = [float(sched(k)) for k in range(steps)]
    peak = max(ref)
    for k, r in enumerate(ref):
        lr = opt.param_groups[0]["lr"]
        assert abs(lr - r) <= 2 ** -22 * peak, (k, lr, r)
        opt.step()
        tsched.step()
    if cfg["type"] == "OneCycleLR" and total <= 1:
        assert ref == [ref[0]] * len(ref)


def test_onecycle_is_not_torchs_onecycle():
    """The port's OneCycle is ao_tpu's: no momentum cycling (Adam's betas
    stay as given) and the warmup boundary int(pct_start * T) clamped to
    [1, T - 1]: max_lr is reached at step 1 for T = 10 and pct 0.05."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([p], lr=0.005, betas=(0.9, 0.999))
    sched = build_scheduler(dict(_ONECYCLE), opt, 10)
    lrs = []
    for _ in range(10):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
        assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    assert lrs[1] == onecycle_lr(1, 10, 0.005, 0.05, 10.0, 1e4) == 0.005


# ---------------------------------------------------------------- Mix3D


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, m in enumerate((700, 500, 900, 300)[:n]):
        out.append(dict(coord=rng.uniform(0, 2, (m, 3)).astype(np.float32),
                        feat=rng.normal(size=(m, 9)).astype(np.float32),
                        segment=rng.integers(-1, 20, m),
                        scene_id=f"s{i}", name=f"n{i}"))
    return out


@pytest.mark.parametrize("mix", [True, False])
@pytest.mark.parametrize("n,max_points", [(4, None), (4, 1024), (3, None)])
def test_point_collate_fn_matches_jax(monkeypatch, mix, n, max_points):
    """Mix3D against ao_tpu's with the draw fixed: consecutive pairs merged
    along the point axis (the per-point PAD_KEYS; other keys keep the first
    sample's), only for a batch of even length, then padded and cut to
    max_points by collate_fn: equal arrays and extras."""
    monkeypatch.setattr(jc.np.random, "rand", lambda: 0.0 if mix else 0.99)
    j = jc.point_collate_fn(_samples(n, n), mix_prob=0.5, pad_multiple=256,
                            max_points=max_points)
    # the port's draw: any uniform number is below 1 and none below 0
    t = tc.point_collate_fn(_samples(n, n), mix_prob=1.0 if mix else 0.0,
                            pad_multiple=256, max_points=max_points,
                            generator=torch.Generator().manual_seed(0))
    assert set(t) == set(j)
    for k in j:
        if k == "extras":
            assert t[k] == j[k]
        else:
            np.testing.assert_array_equal(t[k].numpy(), j[k])
    merged = mix and n % 2 == 0
    assert t["mask"].shape[0] == (n // 2 if merged else n)


def test_point_collate_fn_draws_from_its_generator():
    """The mix draw is one uniform number from the given generator, taken
    only for an even batch at mix_prob > 0: the same seed gives the same
    merges, and an odd batch or mix_prob = 0 leaves the generator as it
    was."""
    seq = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        seq.append([tc.point_collate_fn(_samples(4, 1), 0.5, 256,
                                        generator=g)["mask"].shape[0]
                    for _ in range(8)])
    assert seq[0] == seq[1] and set(seq[0]) == {2, 4}
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    tc.point_collate_fn(_samples(3, 1), 0.5, 256, generator=g)
    tc.point_collate_fn(_samples(4, 1), 0.0, 256, generator=g)
    assert torch.equal(g.get_state(), state)


# ---------------------------------------------------------------- transforms


def _cloud(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3))
    return dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1,
                                                keepdims=True)).astype(np.float32),
                segment=rng.integers(-1, 20, n), instance=rng.integers(0, 9, n))


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


def _jax_draws(monkeypatch, seed):
    """Make ao_tpu's transforms draw what the port's draw from a generator
    seeded with ``seed``, in the same order: random.random and
    np.random.uniform / randn / choice / randint as the port's torch.rand /
    randn / randperm / randint calls."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo=0.0, hi=1.0, size=None):
        n = 1 if size is None else size
        u = lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64).numpy()
        return u[0] if size is None else u

    def choice(a, size=None, replace=True):
        if isinstance(a, (int, np.integer)):
            return torch.randperm(int(a), generator=g)[:size].numpy()
        return a[int(torch.randint(0, len(a), (1,), generator=g))]

    monkeypatch.setattr(jt.random, "random", lambda: uniform())
    monkeypatch.setattr(jt.np.random, "uniform", uniform)
    monkeypatch.setattr(jt.np.random, "randn", lambda *s: torch.randn(
        s, generator=g, dtype=torch.float64).numpy())
    monkeypatch.setattr(jt.np.random, "choice", choice)
    monkeypatch.setattr(jt.np.random, "randint", lambda lo, hi, n: torch.randint(
        lo, hi, (n,), generator=g).numpy())


@pytest.mark.parametrize("name,kw", [
    ("RandomDropout", dict(dropout_ratio=0.2, dropout_application_ratio=1.0)),
    ("RandomRotate", dict(angle=[-1, 1], axis="z", center=[0, 0, 0], p=1.0)),
    ("RandomRotate", dict(angle=[-1 / 64, 1 / 64], axis="x", p=1.0)),
    ("RandomRotateTargetAngle", dict(axis="y", p=1.0)),
    ("ElasticDistortion", dict(distortion_params=[[0.2, 0.4], [0.8, 1.6]])),
])
def test_train_transforms_fixed_draws_match_jax(monkeypatch, name, kw):
    """The ScanNet config's RandomDropout, RandomRotate (normals turned as
    well) and ElasticDistortion, and RandomRotateTargetAngle, with ao_tpu's
    draws fixed to the port's: every array within 1e-6 (measured 0: the
    same float64 arithmetic)."""
    d = _cloud()
    t = getattr(tt, name)(generator=torch.Generator().manual_seed(4), **kw)(_copy(d))
    _jax_draws(monkeypatch, 4)
    j = getattr(jt, name)(**kw)(_copy(d))
    assert set(t) == set(j)
    for k in d:
        assert t[k].shape == j[k].shape, k
        assert np.abs(t[k].astype(np.float64) - j[k]).max() <= 1e-6, k
    if name != "RandomDropout":
        assert not np.array_equal(t["coord"], d["coord"])
    if name.startswith("RandomRotate"):
        np.testing.assert_allclose(np.linalg.norm(t["normal"], axis=1), 1.0,
                                   atol=1e-5)


def test_sampled_index_rides_through_dropout_and_grid_sample(monkeypatch):
    """ScanNet's limited annotations: RandomDropout and GridSample (train
    mode) keep every labelled point and renumber sampled_index into the
    kept points, as ao_tpu's do with the same draws (equal arrays)."""
    d = _cloud(3000)
    d["sampled_index"] = np.random.default_rng(2).choice(3000, 40, replace=False)
    pipe = [("RandomDropout", dict(dropout_ratio=0.5,
                                   dropout_application_ratio=1.0)),
            ("GridSample", dict(grid_size=0.1, hash_type="fnv", mode="train",
                                keys=("coord", "color", "normal", "segment"),
                                return_discrete_coord=True))]
    g = torch.Generator().manual_seed(9)
    t = _copy(d)
    for name, kw in pipe:
        t = getattr(tt, name)(generator=g, **kw)(t)
    _jax_draws(monkeypatch, 9)
    j = _copy(d)
    for name, kw in pipe:
        j = getattr(jt, name)(**kw)(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    labelled = d["coord"][d["sampled_index"]]
    kept = t["coord"][t["sampled_index"]]
    assert len(kept) == 40 and {tuple(x) for x in kept} == {
        tuple(x) for x in labelled}


# ---------------------------------------------------------------- datasets


def _scannet_root(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "scannet"
    names = {"train": ["scene0000_00", "scene0001_00", "scene0002_00"],
             "val": ["scene0100_00"]}
    for split, scenes in names.items():
        (root / split).mkdir(parents=True)
        for name in scenes:
            n = int(rng.integers(200, 400))
            scene = dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                         color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                         normal=rng.normal(size=(n, 3)).astype(np.float32),
                         semantic_gt20=rng.integers(-1, 20, n),
                         semantic_gt200=rng.integers(-1, 200, n),
                         instance_gt=rng.integers(-1, 30, n))
            if name == "scene0002_00":
                scene["scene_id"] = name
            torch.save(scene, root / split / f"{name}.pth")
    (tmp_path / "lr.txt").write_text("scene0002_00\nscene0000_00\n")
    torch.save({"scene0000_00": np.array([3, 7, 50]),
                "scene0001_00": np.array([0, 1]),
                "scene0002_00": np.array([5])}, tmp_path / "la.pth")
    return root


@pytest.mark.parametrize("mode", ["plain", "lr_file", "la_file", "val"])
@pytest.mark.parametrize("cls,jcls", [(ScanNetDataset, JScanNet),
                                      (ScanNet200Dataset, JScanNet200)])
def test_scannet_datasets_match_jax(tmp_path, mode, cls, jcls):
    """ScanNet and ScanNet200 on tiny .pth scenes, against ao_tpu's: the
    scene list (every scene of the split, or the lr_file's in its order),
    and each scene's coord, color, normal, segment (semantic_gt20 /
    semantic_gt200; with la_file the unlabelled points ignored and
    sampled_index set), instance and scene_id: equal arrays."""
    root = _scannet_root(tmp_path)
    kw = dict(split="val" if mode == "val" else "train", data_root=str(root))
    if mode == "lr_file":
        kw["lr_file"] = str(tmp_path / "lr.txt")
    if mode == "la_file":
        kw["la_file"] = str(tmp_path / "la.pth")
    t, j = cls(**kw), jcls(**kw)
    assert t.data_list == j.data_list and len(t) == len(j) > 0
    for i in range(len(t)):
        a, b = t.get_data(i), j.get_data(i)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        if mode == "la_file":
            assert (a["segment"] != -1).sum() <= len(a["sampled_index"])


# ---------------------------------------------------------------- Lovasz


@pytest.mark.parametrize("with_mask", [True, False])
def test_lovasz_matches_jax(with_mask):
    """LovaszLoss (multiclass, present classes, ignore_index and padding
    excluded) against ao_tpu's: value and gradient with respect to the
    logits within 1e-5 (measured 1e-7 of scale)."""
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 300, 20)).astype(np.float32) * 2
    target = rng.integers(-1, 12, (2, 300))
    mask = rng.random((2, 300)) < 0.9 if with_mask else None
    jl = JLovasz(loss_weight=0.7, ignore_index=-1)

    def jloss(p):
        return jl(p, jnp.asarray(target),
                  None if mask is None else jnp.asarray(mask))

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tv = LovaszLoss(loss_weight=0.7, ignore_index=-1)(
        tp, torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask))
    (tgr,) = torch.autograd.grad(tv, tp)
    assert abs(float(tv) - float(jv)) <= 1e-5 * max(abs(float(jv)), 1.0)
    jg = np.asarray(jg)
    assert np.abs(tgr.numpy() - jg).max() <= 1e-5 * max(np.abs(jg).max(), 1e-6)


# ---------------------------------------------------------------- S = 8


@pytest.mark.parametrize("C", [48, 16])
def test_widened_slots_equal_the_s8_call(C):
    """The card runs an S = 8 stage on the S = 16 instances with slots 8-15
    invalid (``widen_slots``). On the plain versions, which compute what
    the kernels compute, in float32: every per-row output of the widened
    call equals the S = 8 call's to 0 ulp (K3's output; K6's dk / dv, dq
    and [valid | t] moments by source row and by query), and so do the
    edge counts; every term the widened slots add to an edge sum is
    exactly 0 (t, the positions, pe1, the softmax weights), so K4's, K5's
    and K6's sums over all edges differ only by the order torch reduces
    them in (within 1e-6 of scale; measured 2.5e-7)."""
    src, qrow, idx, valid, fp, dout = random_graph(C, 2, 300, C, "cpu", S=8)
    w_idx, w_valid = tg.widen_slots(idx, valid)
    assert w_idx.shape[-1] == 16 and not w_valid[..., 8:].any()
    assert torch.equal(w_idx[..., :8], idx)
    pos = (fp["A"], fp["cA"], fp["Wp2"], fp["bp2"], fp["W1f"], fp["b1f"])
    exact, summed = [], []
    exact.append((tg.gva_eval_plain(src, qrow, idx, valid, fp),
                  tg.gva_eval_plain(src, qrow, w_idx, w_valid, fp)))
    for f, extra in ((tg.gva_pos_plain, ()), (tg.gva_stats_plain, pos)):
        a, b = f(src, qrow, idx, valid, *extra), f(src, qrow, w_idx, w_valid, *extra)
        for x, y in zip(a, b):
            (exact if x.dim() == 0 else summed).append((x, y))  # counts exact
    a = tg.gva_bwd_plain(src, qrow, idx, valid, fp, dout)
    b = tg.gva_bwd_plain(src, qrow, w_idx, w_valid, fp, dout)
    exact += [(a[i], b[i]) for i in (0, 1, 3, 4)]
    summed.append((a[2], b[2]))
    for x, y in exact:
        assert x.dtype == torch.float32 and torch.equal(x, y)
    for x, y in summed:
        assert float((x - y).abs().max()) <= 1e-6 * float(x.abs().max())
    env = tg._recompute(src, qrow, w_idx, w_valid, *pos)
    sm = tg._softmax_slots(env["t"], fp["W2"], fp["b2"], w_valid)
    for name, x in (("t", env["t"]), ("pos", env["pos"]), ("pe1", env["pe1"]),
                    ("softmax", sm)):
        assert not x[:, :, 8:].any(), name


def test_gva_wrappers_take_s8_and_c512_on_the_card():
    """Off the CPU the wrappers now take C = 512 (G = 64) and any S <= 16,
    and still raise on S > 16 before any device work (meta tensors stand
    for the card's)."""
    assert 512 in tg.GVA_WIDTHS and tg._tile_queries(512) == 2
    meta = torch.device("meta")
    src = torch.empty((1, 32, 2 * 48 + 6), dtype=torch.bfloat16, device=meta)
    qrow = torch.empty((1, 32, 48 + 7), dtype=torch.bfloat16, device=meta)
    for S, ok in ((8, True), (17, False)):
        idx = torch.empty((1, 32, S), dtype=torch.int32, device=meta)
        valid = torch.empty((1, 32, S), dtype=torch.bool, device=meta)
        if ok:
            args = tg._check_rows("gva_eval", src, qrow, idx, valid)
            assert args[2].shape[-1] == args[3].shape[-1] == 16
        else:
            with pytest.raises(ValueError, match="contract"):
                tg._check_rows("gva_eval", src, qrow, idx, valid)


# ---------------------------------------------------------------- backbone

# the scaled-down slab tiling of tests/test_torch_model.py
_GEOM = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)
_BACKBONE = dict(
    type="PT-v2m2", in_channels=9, num_classes=20, patch_embed_depth=1,
    patch_embed_channels=16, patch_embed_groups=2, patch_embed_neighbours=8,
    enc_depths=(1, 1, 1, 1), enc_channels=(16, 32, 32, 64),
    enc_groups=(2, 4, 4, 8), enc_neighbours=(16, 16, 16, 16),
    dec_depths=(1, 1, 1, 1), dec_channels=(16, 16, 32, 32),
    dec_groups=(2, 2, 4, 4), dec_neighbours=(16, 16, 16, 16),
    grid_sizes=(0.06, 0.15, 0.375, 0.9375), unpool_backend="map",
    drop_path_rate=0.0)


def _card_dispatch(monkeypatch):
    """Both packages on the card's dispatch at a small size: the slab path
    (scaled tiling) for stages of 128 points or more, the gathered fused
    GVA below; the JAX kernels in interpret mode."""
    def slab(C, N, *_):
        return dict(_GEOM) if N >= 128 and C <= 384 else None

    monkeypatch.setattr(jm, "_slab_geometry", slab)
    monkeypatch.setattr(tm, "_slab_geometry", slab)
    monkeypatch.setattr(jm, "_fused_gva_ok", lambda *a: True)
    monkeypatch.setattr(tm.GroupedVectorAttention, "fused_ok",
                        lambda self, device: True)
    for mod, names in ((jm._gvas, ("gva_slab_core", "gva_slab_core_eval",
                                   "compute_pos_moments_slab")),
                       (jm._gvaf, ("gva_core", "gva_core_eval",
                                   "compute_pos_moments"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, functools.partial(
                lambda f, *a: f(*a, True), fn))


@pytest.fixture(scope="module")
def scannet_backbone():
    """The narrow ScanNet-shaped PT-v2m2 in both packages with ao_tpu's
    weights carried across, and a batch of two clouds (one padded)."""
    rng = np.random.default_rng(5)
    B, N = 2, 256
    coord = rng.uniform(0, 1.5, (B, N, 3)).astype(np.float32)
    normal = rng.normal(size=(B, N, 3)).astype(np.float32)
    feat = np.concatenate([coord, rng.uniform(-1, 1, (B, N, 3)), normal], -1)
    mask = np.ones((B, N), bool)
    mask[1, N - 50:] = False
    arrays = (coord, feat.astype(np.float32), mask)
    jmodel = jax_build_model(dict(_BACKBONE))
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                               *(jnp.asarray(a) for a in arrays))
    return jmodel, var, arrays


@pytest.mark.parametrize("train", [False, True])
def test_scannet_backbone_matches_jax_on_the_cards_dispatch(
        monkeypatch, scannet_backbone, train):
    """A narrow ScanNet-shaped PT-v2m2 (4 stages, in_channels = 9, an S = 8
    patch embed, map unpooling, ScanNet's grid sizes) with ao_tpu's weights
    carried across, on the card's dispatch in both packages (slab stages
    of 128 points or more, gathered fused stages below; the Pallas kernels
    in interpret mode, the port's plain versions). Eval: logits within
    2e-3 x scale (test_torch_model.py's band). Train (batch statistics):
    logits within 2e-2 x scale and the updated running statistics within
    2e-2 of theirs. The whole U-Net in train mode is far more sensitive
    than one BlockSequence (test_torch_train_model.py holds those to 2e-3):
    moving the input features by 1e-7 relative moves ao_tpu's own logits
    by 9.1e-3 x scale (measured), since q, k and v round to bf16 at every
    kernel's input and nine batch-statistic blocks amplify each flipped
    unit; the port measured 7.6e-3. Its gradients are held block by block
    there."""
    _card_dispatch(monkeypatch)
    jmodel, var, arrays = scannet_backbone
    tmodel = build_model(dict(_BACKBONE))
    tmodel.load_state_dict(convert.from_jax_variables(
        _np(var["params"]), _np(var["batch_stats"])), strict=True)
    args = tuple(jnp.asarray(a) for a in arrays)
    with torch.no_grad():
        tout = tmodel.train(train)(*(torch.from_numpy(a) for a in arrays))
    if not train:
        jout = jmodel.apply(var, *args, True, True)
        tol = 2e-3
    else:
        jout, mut = jax.jit(lambda v: jmodel.apply(
            v, *args, False, False, mutable=["batch_stats", "diagnostics"]))(var)
        tol = 2e-2
        sd = tmodel.state_dict()
        for k, v in convert.from_jax_variables(
                _np(var["params"]), _np(mut["batch_stats"])).items():
            if "running" in k:
                assert np.abs(sd[k].numpy() - v.numpy()).max() <= 2e-2 * max(
                    np.abs(v.numpy()).max(), 1.0), k
    jout = np.asarray(jout, np.float32)
    assert np.abs(tout.numpy() - jout).max() < tol * max(np.abs(jout).max(), 1.0)


# ---------------------------------------------------------------- configs

_NARROW = dict(patch_embed_channels=16, patch_embed_groups=2,
               enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
               dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
               enc_depths=(1, 1, 1, 1), patch_embed_depth=1)


@pytest.mark.parametrize("config", ["s3dis/semseg-pt-v2m2-1-one-cycle.py",
                                    "scannet/semseg-pt-v2m2-3-lovasz.py"])
def test_config_takes_two_cpu_steps(tmp_path, config):
    """The two configs that waited on this port's modules build and take
    two train steps through the train entry point on the CPU at narrow
    widths: S3DIS with OneCycle, ScanNet (Mix3D at 0.8, OneCycle, the
    cross-entropy + Lovasz criteria) on synthetic ScanNet rooms. Losses
    finite; each step's lr OneCycle's over the run's total steps."""
    from ao_tpu_torch.tools.train import main as train_main

    if config.startswith("s3dis"):
        rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2)]
        _, options = chip_smoke.train_setup(rooms, str(tmp_path), batch_size=2,
                                            max_steps=2, workers=0)
        backbone = {k: v[:3] if isinstance(v, tuple) else v
                    for k, v in _NARROW.items()}
        options += ["pad_multiple=512"]
    else:
        rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.05)
                 for s in (1, 2, 3, 4)]
        _, options = chip_smoke.scannet_setup(rooms, workdir=str(tmp_path),
                                              batch_size=2, max_steps=2,
                                              workers=0)
        backbone = _NARROW
        options += ["pad_multiple=512", "max_points=4096"]
    trainer = train_main(["--config-file", os.path.join(ROOT, "configs", config),
                          "--device", "cpu", "--options", *options] + [
        f"model.backbone.{k}={v!r}" for k, v in backbone.items()])
    hist = trainer.history
    assert len(hist) == 2
    s = trainer.cfg.scheduler
    for k, rec in enumerate(hist):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        lr = onecycle_lr(k, trainer.total_steps, s.max_lr, s.pct_start,
                         s.div_factor, s.final_div_factor)
        assert abs(rec["lr"] - lr) <= 1e-12 * lr
    if config.startswith("scannet"):
        names = [type(c).__name__ for c in trainer.criteria.criteria]
        assert names == ["CrossEntropyLoss", "LovaszLoss"]
