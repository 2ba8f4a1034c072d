"""The classification and part-segmentation modules of ao_tpu_torch against
ao_tpu's on the CPU: the ten transforms the port lacked and SphereCrop's
"all" mode with the same draws, the SmoothCE / BinaryFocal / Focal / Dice
losses, ModelNetDataset / ShapeNetPartDataset / ArkitScenesDataset item
for item on small files, DefaultClassifier over a tiny SpUNet cls_mode,
one classification train step and eval_batch of the Trainer, the
ClsEvaluator's metrics, ClsTester and PartSegTester results, and CPU
steps of the five PT-v1 / ModelNet configs at a tiny size."""

import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.datasets.transform as jt
import ao_tpu.models.losses.misc as jl
import chip_smoke
from ao_tpu_torch.datasets import transform as tt
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.losses import misc as tl
from ao_tpu_torch.models.point_transformer.convert import flax_to_torch_state_dict
from ao_tpu_torch.models.utils import Dropout
from ao_tpu_torch.utils import Config, DictAction

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS = os.path.join(ROOT, "configs", "modelnet40", "cls-ptv1-0-base.py")
CLS_SPUNET = os.path.join(ROOT, "configs", "modelnet40", "cls-spunet-v1m1-0-base.py")
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
# a SpUNet of 8-16 channels, one block a stage
_TINY_SPUNET = dict(base_channels=8, channels=(8, 8, 16, 16, 16, 8, 8, 8),
                    layers=(1,) * 8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread (restored after the module), so
    that the test workers' pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(options):
    return {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in options)}


# ---------------------------------------------------------------- transforms


def _cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3))
    return dict(coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1,
                                                keepdims=True)).astype(np.float32),
                segment=rng.integers(-1, 13, n), instance=rng.integers(0, 9, n))


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


def _jax_draws(monkeypatch, seed):
    """ao_tpu's transforms draw what the port's draw from a generator seeded
    with ``seed``, in the same order: np.random.uniform / rand / randn /
    multivariate_normal (standard) / permutation / randint as the port's
    torch.rand / randn / randperm / randint."""
    g = torch.Generator().manual_seed(seed)

    def u(n):
        return torch.rand(n, generator=g, dtype=torch.float64).numpy()

    def uniform(lo=0.0, hi=1.0, size=None):
        v = lo + (hi - lo) * u(1 if size is None else size)
        return v[0] if size is None else v

    monkeypatch.setattr(jt.np.random, "uniform", uniform)
    monkeypatch.setattr(jt.np.random, "rand", lambda *s: u(s) if s else u(1)[0])
    monkeypatch.setattr(jt.np.random, "randn", lambda *s: torch.randn(
        s, generator=g, dtype=torch.float64).numpy())
    monkeypatch.setattr(jt.np.random, "multivariate_normal", lambda m, c, n: (
        torch.randn((n, len(m)), generator=g, dtype=torch.float64).numpy()))
    monkeypatch.setattr(jt.np.random, "permutation", lambda n: torch.randperm(
        n, generator=g).numpy())
    monkeypatch.setattr(jt.np.random, "randint", lambda n: int(torch.randint(
        0, n, (1,), generator=g)))


_TRANSFORMS = [
    ("ToArray", {}), ("NormalizeCoord", {}), ("PositiveShift", {}),
    ("RandomShift", dict(shift=((-0.2, 0.2), (-0.1, 0.3), (0, 0)))),
    ("ClipGaussianJitter", dict(scalar=0.02, store_jitter=True)),
    ("RandomColorGrayScale", dict(p=1.0)),
    ("HueSaturationTranslation", dict(hue_max=0.5, saturation_max=0.2)),
    ("RandomColorDrop", dict(p=1.0, color_augment=0.5)),
    ("ShufflePoint", {}), ("CropBoundary", {}),
    ("SphereCrop", dict(point_max=1000, mode="center")),
    ("SphereCrop", dict(point_max=1000, mode="random")),
]


@pytest.mark.parametrize("name,kw", _TRANSFORMS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_TRANSFORMS)])
def test_transforms_match_jax(monkeypatch, name, kw):
    """Each of the ten transforms the port lacked (and SphereCrop's "center"
    and "random" modes, which ModelNet's config names) on the same cloud,
    ao_tpu's draws fixed to the port's: every array within 1e-6 (the same
    float64 arithmetic)."""
    d = _cloud()
    cls = getattr(tt, name)
    draws = "generator" in inspect.signature(cls).parameters
    t = (cls(generator=torch.Generator().manual_seed(4), **kw) if draws
         else cls(**kw))(_copy(d))
    _jax_draws(monkeypatch, 4)
    j = getattr(jt, name)(**kw)(_copy(d))
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape, k
        assert np.abs(t[k].astype(np.float64) - j[k]).max() <= 1e-6, k


def test_sphere_crop_all_matches_jax(monkeypatch):
    """SphereCrop "all" (overlapping crops until every point is covered,
    each with its ``index`` and ``weight``) with the same draws: the same
    crops, equal arrays; a cloud within point_max is one crop of zero
    weights."""
    d = _cloud(2500)
    g = torch.Generator().manual_seed(5)
    t = tt.SphereCrop(point_max=800, mode="all", generator=g)(_copy(d))
    _jax_draws(monkeypatch, 5)
    j = jt.SphereCrop(point_max=800, mode="all")(_copy(d))
    assert len(t) == len(j) > 3
    for a, b in zip(t, j):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    covered = np.unique(np.concatenate([c["index"] for c in t]))
    assert len(covered) == 2500
    (one,) = tt.SphereCrop(point_max=3000, mode="all")(_copy(d))
    assert (one["weight"] == 0).all() and len(one["coord"]) == 2500


# ---------------------------------------------------------------- losses

_LOSSES = [("SmoothCELoss", {}), ("SmoothCELoss", dict(smoothing_ratio=0.3)),
           ("FocalLoss", {}), ("FocalLoss", dict(reduction="sum", gamma=1.5)),
           ("DiceLoss", {}), ("DiceLoss", dict(exponent=1.0, smooth=0.5))]


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name,kw", _LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_LOSSES)])
def test_losses_match_jax(name, kw, with_mask):
    """The multi-class losses on (4, 50, 7) logits with ignored targets and
    padded points: within 1e-6 of ao_tpu's, relative (measured up to
    2.2e-7)."""
    rng = np.random.default_rng(3)
    pred = (rng.normal(size=(4, 50, 7)) * 3).astype(np.float32)
    tgt = rng.integers(-1, 7, (4, 50))
    mask = rng.random((4, 50)) > 0.2 if with_mask else None
    j = float(getattr(jl, name)(**kw)(jnp.asarray(pred), jnp.asarray(tgt),
                                      None if mask is None else jnp.asarray(mask)))
    t = float(getattr(tl, name)(**kw)(torch.from_numpy(pred), torch.from_numpy(tgt),
                                      None if mask is None else torch.from_numpy(mask)))
    assert abs(t - j) <= 1e-6 * max(abs(j), 1.0)


@pytest.mark.parametrize("kw", [{}, dict(logits=False), dict(reduce=False),
                                dict(gamma=0.5, alpha=0.25)])
def test_binary_focal_loss_matches_jax(kw):
    """BinaryFocalLoss of (200,) logits (or probabilities) against {0, 1}
    targets with a mask, reduced and not: within 1e-6 of scale."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=200) * 3).astype(np.float32)
    if kw.get("logits") is False:
        x = (1 / (1 + np.exp(-x))).astype(np.float32)
    y, mask = rng.integers(0, 2, 200), rng.random(200) > 0.2
    j = np.asarray(jl.BinaryFocalLoss(**kw)(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(mask)))
    t = tl.BinaryFocalLoss(**kw)(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(mask)).numpy()
    assert np.abs(t - j).max() <= 1e-6 * max(np.abs(j).max(), 1.0)


# ---------------------------------------------------------------- datasets


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-12))


def _names():
    return list(Config.fromfile(CLS).data.names)


def _same_items(t, j):
    assert set(t) == set(j)
    for k in j:
        a, b = t[k], j[k]
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert a.dtype == b.dtype, k
        else:
            assert a == b, k


@pytest.mark.parametrize("split", ["train", "test"])
def test_modelnet_dataset_matches_jax(tmp_path, split):
    """ModelNetDataset on shapes of three classes written as ModelNet40's
    comma-separated files (chip_smoke.modelnet_setup): the list, names and
    every item equal to ao_tpu's, raw and through the config's train (with
    the same draws) or test transforms."""
    from ao_tpu.datasets.modelnet import ModelNetDataset as JModelNet
    from ao_tpu_torch.datasets.modelnet import ModelNetDataset

    names = _names()
    root = chip_smoke.modelnet_setup(str(tmp_path), names[:3], per_class=(2, 1),
                                     n_points=1500)
    cfg = Config.fromfile(CLS).data[split if split == "train" else "test"]
    for transform in ([], [dict(t) for t in cfg.transform]):
        kw = dict(split=split, data_root=root, class_names=names,
                  transform=transform, test_mode=split == "test",
                  test_cfg=dict() if split == "test" else None)
        t, j = ModelNetDataset(**kw), JModelNet(**kw)
        assert len(t) == len(j) == (6 if split == "train" else 3)
        for i in range(len(t)):
            assert t.get_data_name(i) == j.get_data_name(i)
            g = torch.Generator().manual_seed(i)
            for tr in t.transform.transforms:
                if hasattr(tr, "generator"):
                    tr.generator = g
            a = t[i]
            with pytest.MonkeyPatch.context() as mp:
                _jax_draws(mp, i)
                b = j[i]
            _same_items(a, b)


def test_shapenetpart_dataset_matches_jax(tmp_path):
    """ShapeNetPartDataset on two shapes in ShapeNetPart's layout
    (chip_smoke.shapenetpart_setup): categories, list, names, raw items,
    and test-mode items (two scaled views of the fragments, the category
    carried beside the full-resolution labels) equal to ao_tpu's."""
    from ao_tpu.datasets.misc_datasets import ShapeNetPartDataset as JShapeNet
    from ao_tpu_torch.datasets.misc_datasets import ShapeNetPartDataset

    root = chip_smoke.shapenetpart_setup(str(tmp_path), shapes=((0, 300), (4, 400)))
    cfg = chip_smoke.partseg_config(root, str(tmp_path), "unused").data.test
    t = ShapeNetPartDataset(**{k: v for k, v in cfg.items() if k != "type"})
    j = JShapeNet(**{k: v for k, v in cfg.items() if k != "type"})
    assert t.categories == j.categories and t.token2category == j.token2category
    assert t.data_list == j.data_list and len(t) == 2
    for i in range(2):
        assert t.get_data_name(i) == j.get_data_name(i)
        _same_items(t.get_data(i), j.get_data(i))
        a, b = t[i], j[i]
        assert a["name"] == b["name"]
        np.testing.assert_array_equal(a["segment"], b["segment"])
        np.testing.assert_array_equal(a["category"], b["category"])
        assert len(a["fragment_list"]) == len(b["fragment_list"]) == 2
        for fa, fb in zip(a["fragment_list"], b["fragment_list"]):
            _same_items(fa, fb)


def test_arkitscenes_dataset_matches_jax(tmp_path):
    """ArkitScenesDataset on two scenes (one with normals): coord, color,
    normal where stored, and segment -1 everywhere, as ao_tpu's."""
    from ao_tpu.datasets.misc_datasets import ArkitScenesDataset as JArkit
    from ao_tpu_torch.datasets.misc_datasets import ArkitScenesDataset

    rng = np.random.default_rng(2)
    os.makedirs(tmp_path / "Training")
    for i in range(2):
        scene = dict(coord=rng.uniform(0, 4, (500, 3)), color=rng.uniform(0, 255, (500, 3)))
        if i:
            scene["normal"] = rng.normal(size=(500, 3))
        np.savez(tmp_path / "Training" / f"scene{i}.npz", **scene)
    kw = dict(split="Training", data_root=str(tmp_path), transform=[])
    t, j = ArkitScenesDataset(**kw), JArkit(**kw)
    assert len(t) == len(j) == 2
    for i in range(2):
        a, b = t.get_data(i), j.get_data(i)
        _same_items(a, b)
        assert (a["segment"] == -1).all() and ("normal" in a) == bool(i)


# ---------------------------------------------------------------- models


def test_default_classifier_over_spunet_matches_jax():
    """DefaultClassifier over a tiny SpUNet-v1m1 in cls_mode (its (B, 16)
    embedding, the first Linear taking backbone_embed_dim) with ao_tpu's
    weights carried across (the backbone by the sparse converter, the head
    by PT-v1's): logits within 1e-4 of scale in eval mode and in train mode
    with dropout off (measured up to 4e-7), B=4 shapes of 600 points."""
    from ao_tpu.models import build_model as jax_build_model
    from ao_tpu_torch.models.sparse_unet import convert as sparse_convert

    cfg = dict(type="DefaultClassifier", num_classes=40, backbone_embed_dim=16,
               backbone=dict(type="SpUNet-v1m1", in_channels=6, num_classes=0,
                             cls_mode=True, **_TINY_SPUNET))
    rng = np.random.default_rng(1)
    coord = (rng.normal(size=(4, 600, 3)) * 2).astype(np.float32)
    feat = rng.normal(size=(4, 600, 6)).astype(np.float32)
    mask = np.ones((4, 600), bool)
    mask[3, 450:] = False
    jin = [jnp.asarray(a) for a in (coord, feat, mask)]
    jmodel = jax_build_model(dict(cfg))
    variables = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jin))
    params, stats = variables["params"], variables["batch_stats"]
    sd = sparse_convert.from_jax_variables(
        dict(params={"backbone": params["backbone"]},
             batch_stats={"backbone": stats.get("backbone", {})}))
    sd.update(flax_to_torch_state_dict(
        {"backbone": {}, **{k: v for k, v in params.items() if k != "backbone"}},
        {"backbone": {}, **{k: v for k, v in stats.items() if k != "backbone"}}))
    model = build_model(dict(cfg))
    model.load_state_dict(sd, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    for train in (False, True):
        out, _ = jax.jit(lambda v: jmodel.apply(v, *jin, True, not train,
                                                mutable=["batch_stats"]))(variables)
        model.train(train)
        with torch.no_grad():
            t = model(*(torch.from_numpy(a) for a in (coord, feat, mask)))
        assert t.shape == (4, 40)
        assert np.abs(t.numpy() - np.asarray(out)).max() <= 1e-4 * np.abs(out).max()


def _modelnet(tmp_path, classes=4, per_class=(2, 1), n_points=1500):
    return chip_smoke.modelnet_setup(str(tmp_path), _names()[:classes],
                                     per_class=per_class, n_points=n_points)


# parameters whose gradient is rounding noise in both packages: the
# weight encodings' last biases (the softmax over the neighbours is shift
# invariant), the value projections' (the attention's convex combination
# feeds a BatchNorm) and the classifier Linears' before their BatchNorms
_ZERO_GRAD = ("linear_w.5.bias", "transformer.linear_v.bias", "cls_fc1.bias",
              "cls_fc2.bias")


def test_classification_step_and_eval_batch_match_jax(tmp_path, monkeypatch):
    """One train step of the ModelNet Cls26 config (B=8 x 1024) in the port's
    Trainer against ao_tpu's Trainer on its first batch, its initial
    variables carried across: ao_tpu's side is the body of its train step
    (ao_tpu/engines/train.py:333-345: the category as the target, logits
    of ndim 2 taking no mask) with the Trainer's own model, criteria and
    optax transform, on one device with dropout off (deterministic=True;
    the port's Dropout at rate 0): the step sharded over the 8-device CPU
    mesh deadlocks in XLA's CPU collectives (an all-gather against an
    all-reduce) once its dropout is gone. The loss within 1e-4 of scale;
    after SGD (nesterov, weight decay) at MultiStepLR's first lr every
    running statistic within 1e-4 of its scale and every parameter's update
    within 2e-2 of ao_tpu's in L2 (measured up to 1.04e-2, at the first
    layer's position encoding: train-mode PT-v1 gradients of both packages
    lie 1e-2 apart, tests/test_torch_ptv1.py), but those of
    :data:`_ZERO_GRAD`, below 1e-2 of the largest update in both; then
    eval_batch of a validation batch against the same eval body: the loss
    within 1e-4 and the per-class histograms equal."""
    import ao_tpu.engines.train as jtrain
    from ao_tpu.engines import default_config_parser as jax_parser
    from ao_tpu.utils.misc import intersection_and_union_jax
    from ao_tpu_torch.engines import Trainer, default_config_parser

    monkeypatch.setattr(jtrain, "TensorboardWriter", lambda *a, **k: None)
    root = _modelnet(tmp_path, classes=8, per_class=(1, 1))
    options = chip_smoke.cls_options(root, 8, 8, 1, str(tmp_path / "jax"), 3,
                                     workers=0)
    jtr = jtrain.Trainer(jax_parser(CLS, _options(options)))
    batch = next(iter(jtr.train_loader))
    assert batch["coord"].shape == (8, 1024, 3) and "segment" not in batch
    params, stats = _np(jtr.state.params), _np(jtr.state.batch_stats)
    opt_state = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)),
                                       jtr.state.opt_state)
    options[0] = f"save_path={tmp_path / 'port'}"
    ttr = Trainer(default_config_parser(CLS, _options(options)), device="cpu")
    ttr.model.load_state_dict(flax_to_torch_state_dict(params, stats), strict=True)
    for m in ttr.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0

    def jax_logits(p, b, train):
        return jtr.model.apply({"params": p, "batch_stats": stats}, *(
            jnp.asarray(np.asarray(b[k])) for k in ("coord", "feat", "mask")),
            True, not train, mutable=["batch_stats"])

    def loss_fn(p):
        logits, mut = jax_logits(p, batch, True)
        return jtr.criteria(logits, jnp.asarray(np.asarray(batch["category"])),
                            None), mut["batch_stats"]

    (j, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    updates, _ = jtr.tx.update(grads, opt_state, params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    tm, _ = ttr._step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
                       if k != "extras"})
    assert abs(float(tm["loss"]) - float(j)) <= 1e-4 * max(abs(float(j)), 1.0)
    after = flax_to_torch_state_dict(_np(new_params), _np(new_stats))
    before = flax_to_torch_state_dict(params, stats)
    port = ttr.model.state_dict()
    ups = {k: (after[k] - before[k], port[k] - before[k]) for k in after
           if "running" not in k and "num_batches" not in k}
    umax = max(float(u.abs().max()) for u, _ in ups.values())
    for k, (u, tu) in ups.items():
        if k.endswith(_ZERO_GRAD):
            assert max(float(u.abs().max()), float(tu.abs().max())) < 1e-2 * umax, k
        else:
            assert float((tu - u).norm()) <= 2e-2 * float(u.norm()), k
    for k in after:
        if "running" in k:
            assert _rel(port[k], after[k]) <= 1e-4, k
    vbatch = next(iter(jtr.val_loader))
    stats = _np(new_stats)
    logits, _ = jax.jit(lambda p: jax_logits(p, vbatch, False))(_np(new_params))
    target = jnp.asarray(np.asarray(vbatch["category"]))
    jl_ = float(jtr.criteria(logits, target, None))
    jh = intersection_and_union_jax(jnp.argmax(logits, -1), target, 40, -1)
    tl_, *th = ttr.eval_batch({k: torch.from_numpy(np.asarray(v))
                               for k, v in vbatch.items() if k != "extras"})
    assert abs(tl_ - jl_) <= 1e-4 * max(abs(jl_), 1.0)
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class _FakeTrainer:
    """What an evaluator hook reads of a trainer, with a fixed sequence of
    eval_batch results."""

    def __init__(self, results, K, tmp_path):
        import logging

        self.cfg = Config(dict(data=dict(num_classes=K, names=[str(i) for i in range(K)])))
        self.results = results
        self.val_loader = list(range(len(results)))
        self.epoch, self.writer, self.comm_info = 2, None, {}
        self.logger = logging.getLogger("cls-evaluator-test")
        self.best_metric_value = -1e9

    def eval_batch(self, i):
        return self.results[i]


def test_cls_evaluator_matches_jax(tmp_path):
    """The ClsEvaluator hook of both packages over the same three batches of
    (loss, intersection, union, target): mAcc / allAcc / the current
    metric equal."""
    from ao_tpu.engines.hooks.evaluator import ClsEvaluator as JCls
    from ao_tpu_torch.engines.hooks.evaluator import ClsEvaluator

    rng = np.random.default_rng(0)
    results = []
    for _ in range(3):
        target = rng.integers(0, 4, 5).astype(float)
        inter = np.minimum(target, rng.integers(0, 3, 5))
        results.append((float(rng.random()), inter, target + 1, target))
    out = []
    for cls in (ClsEvaluator, JCls):
        hook = cls()
        hook.trainer = _FakeTrainer(results, 5, tmp_path)
        hook.eval()
        out.append(hook.trainer.comm_info)
    t, j = out
    assert t["current_metric_name"] == j["current_metric_name"] == "allAcc"
    assert t["current_metric_value"] == pytest.approx(j["current_metric_value"], abs=1e-12)
    inter = sum(r[1] for r in results)
    target = sum(r[3] for r in results)
    assert t["val_result"]["mAcc"] == pytest.approx(np.mean(inter / (target + 1e-10)))


def _jax_tester(tester, cfg, name, coord, feat, mask, **kw):
    """ao_tpu's tester run on a model built from ``cfg`` with random
    variables (numpy draws in the shapes of its init); returns (its result,
    the port's state dict of them)."""
    from ao_tpu.models import build_model as jax_build_model

    jmodel = jax_build_model(dict(cfg.model))
    shapes = jax.eval_shape(functools.partial(jmodel.init, **kw), jax.random.PRNGKey(1),
                            *(jnp.asarray(a) for a in (coord, feat, mask)))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(lambda p, x: np.asarray(
        rng.normal(size=x.shape) / np.sqrt(x.shape[0]) if p[-1].key == "kernel"
        else rng.uniform(0.5, 1.5, x.shape) if p[-1].key in ("var", "scale")
        else 0.1 * rng.normal(size=x.shape), np.float32), shapes)

    class _T:
        pass

    t = _T()
    t.model, t.cfg, t.state = jmodel, cfg, _T()
    t.state.params, t.state.batch_stats = variables["params"], variables["batch_stats"]
    tester.trainer = t
    return tester(), flax_to_torch_state_dict(variables["params"],
                                              variables["batch_stats"])


def test_cls_tester_matches_jax(tmp_path):
    """ClsTester of both packages on the ModelNet Cls26 config's test split
    (four shapes), with the same random weights: allAcc and mAcc equal."""
    from ao_tpu.engines.test import TEST as JTEST
    from ao_tpu_torch.engines import TEST

    root = _modelnet(tmp_path, classes=4, per_class=(0, 1))
    cfg = Config.fromfile(CLS)
    cfg.merge_from_dict(dict(save_path=str(tmp_path / "exp"),
                             **{"data.test.data_root": root}))
    os.makedirs(cfg.save_path, exist_ok=True)
    z = np.zeros((1, 1024, 3), np.float32)
    jres, sd = _jax_tester(JTEST.build(dict(type="ClsTester", verbose=False)), cfg,
                           "cls", z, np.zeros((1, 1024, 6), np.float32),
                           np.ones((1, 1024), bool))
    torch.save(sd, tmp_path / "model.pt")
    cfg.merge_from_dict(dict(weight=str(tmp_path / "model.pt")))
    tres = TEST.build(dict(type="ClsTester", cfg=cfg, verbose=False, device="cpu"))()
    assert tres["allAcc"] == pytest.approx(jres["allAcc"], abs=1e-12)
    assert tres["mAcc"] == pytest.approx(jres["mAcc"], abs=1e-12)


def test_part_seg_tester_matches_jax(tmp_path):
    """PartSegTester of both packages (PartSeg26, two shapes of two
    categories, two scaled views each, the category conditioning the
    forward), with the same random weights: ins.mIoU and cat.mIoU equal
    (mirroring tests/test_engine_extra.py's PartSegTester case)."""
    from ao_tpu.engines.test import TEST as JTEST
    from ao_tpu_torch.engines import TEST

    root = chip_smoke.shapenetpart_setup(str(tmp_path), shapes=((0, 384), (1, 384)))
    cfg = chip_smoke.partseg_config(root, str(tmp_path / "exp"),
                                    str(tmp_path / "model.pt"),
                                    backbone="PointTransformer-PartSeg26",
                                    pad_multiple=128)
    os.makedirs(cfg.save_path, exist_ok=True)
    jres, sd = _jax_tester(JTEST.build(dict(type="PartSegTester", verbose=False)),
                           cfg, "partseg", np.zeros((1, 512, 3), np.float32),
                           np.zeros((1, 512, 6), np.float32), np.ones((1, 512), bool),
                           category=jnp.zeros((1,), jnp.int32))
    torch.save(sd, tmp_path / "model.pt")
    tres = TEST.build(dict(type="PartSegTester", cfg=cfg, verbose=False,
                           device="cpu"))()
    assert 0.0 <= tres["ins_mIoU"] <= 1.0
    assert tres["ins_mIoU"] == pytest.approx(jres["ins_mIoU"], abs=1e-9)
    assert tres["cat_mIoU"] == pytest.approx(jres["cat_mIoU"], abs=1e-9)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("config", ["s3dis/semseg-pt-v1-0-base.py",
                                    "scannet/semseg-pt-v1-0-base.py",
                                    "scannet200/semseg-pt-v1-0-base.py"])
def test_ptv1_semseg_config_trains_on_the_cpu(tmp_path, config):
    """The three PT-v1 semseg configs as written (Seg50) take two train
    steps through the train entry point on small synthetic rooms (2048
    points at most): losses and gradient norms finite, each step's lr the
    config's schedule (MultiStepLR for S3DIS, OneCycle for ScanNet)."""
    from ao_tpu_torch.tools.train import main as train_main
    from ao_tpu_torch.utils.scheduler import onecycle_lr

    path = os.path.join(ROOT, "configs", config)
    if config.startswith("s3dis"):
        rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2)]
        _, options = chip_smoke.train_setup(rooms, str(tmp_path), batch_size=2,
                                            max_steps=2, workers=0)
    else:
        rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.06)
                 for s in (1, 2)]
        if config.startswith("scannet200"):
            for r in rooms:
                r["semantic_gt200"] = np.where(r["semantic_gt20"] < 0, -1,
                                               r["semantic_gt20"] * 9)
        _, options = chip_smoke.scannet_setup(rooms, workdir=str(tmp_path),
                                              batch_size=2, max_steps=2, workers=0)
        if config.startswith("scannet200"):
            os.rename(tmp_path / "scannet", tmp_path / "scannet200")
            options = [o.replace("/scannet", "/scannet200") if "data_root" in o
                       else o for o in options]
    trainer = train_main(["--config-file", path, "--device", "cpu", "--options",
                          *options, "pad_multiple=512", "max_points=2048"])
    assert type(trainer.model.backbone).__name__ == "PointTransformerSeg"
    assert len(trainer.model.backbone.enc4_block4.__class__.__name__) > 0
    hist = trainer.history
    assert len(hist) == 2
    s = trainer.cfg.scheduler
    for k, rec in enumerate(hist):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        if s.type == "OneCycleLR":
            lr = onecycle_lr(k, trainer.total_steps, s.max_lr, s.pct_start,
                             s.div_factor, s.final_div_factor)
        else:
            lr = chip_smoke.multistep_of(trainer)(k)
        assert abs(rec["lr"] - lr) <= 1e-12 * lr


@pytest.mark.parametrize("config", [CLS, CLS_SPUNET], ids=["cls-ptv1", "cls-spunet"])
def test_modelnet_config_trains_evaluates_and_tests_on_the_cpu(tmp_path, config):
    """The two ModelNet40 configs on synthetic shapes of four classes: two
    train steps at B=2 through the train entry point (MultiStepLR's lr;
    SpUNet at a tiny width), whose cut epoch ends with the config's
    ClsEvaluator on the test split (finite mAcc and allAcc, allAcc the
    current metric), then the ClsTester through the test entry point on
    the saved model_last.pt."""
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.tools.train import main as train_main

    root = _modelnet(tmp_path)
    extra = [f"model.backbone.{k}={v!r}" for k, v in _TINY_SPUNET.items()] + [
        "model.backbone_embed_dim=16"] if config == CLS_SPUNET else []
    trainer = train_main(["--config-file", config, "--device", "cpu", "--options",
                          *chip_smoke.cls_options(root, 8, 2, 2, str(tmp_path / "exp"),
                                                  0, workers=0), *extra])
    assert len(trainer.history) == 2
    chip_smoke.check_lr(trainer, chip_smoke.multistep_of(trainer), config)
    val = trainer.comm_info["val_result"]
    assert val["batches"] == 4 and np.isfinite([val["mAcc"], val["allAcc"]]).all()
    assert trainer.comm_info["current_metric_name"] == "allAcc"
    res = test_main(["--config-file", config, "--device", "cpu", "--options",
                     f"weight={tmp_path / 'exp' / 'model' / 'model_last.pt'}",
                     f"save_path={tmp_path / 'test'}", f"data.test.data_root={root}",
                     *extra])
    assert 0.0 <= res["allAcc"] <= 1.0 and np.isfinite(res["mAcc"])


def test_cls_spunet_config_voxelises_at_one_coordinate_unit(tmp_path):
    """ROADMAP section 3: cls-spunet-v1m1-0-base.py inherits cls-ptv1's
    transforms, which have no GridSample, so no discrete_coord reaches
    SpUNet: it voxelises at one coordinate unit, floor(coord - min), in
    both packages (ao_tpu's fallback, the port's voxel_coords: equal
    sites). A shape normalised into the unit sphere, scaled by at most 1.5
    and cropped to its 1024 points nearest a random point, spans a few
    units: a handful of sites a shape, at most 27 for an uncropped one."""
    from ao_tpu_torch.datasets import build_dataset, collate_fn
    from ao_tpu_torch.models.sparse_unet.spunet import voxel_coords

    cfg = Config.fromfile(CLS_SPUNET)
    assert not any(t["type"] == "GridSample" for t in cfg.data.train.transform)
    root = _modelnet(tmp_path, classes=4, per_class=(2, 0), n_points=4000)
    ds = build_dataset(dict(cfg.data.train, data_root=root))
    batch = collate_fn([ds[i] for i in range(len(ds))], pad_multiple=1024)
    assert "discrete_coord" not in batch
    sites = chip_smoke.voxel_sites(batch)
    assert all(1 <= s <= 27 for s in sites)
    coord, mask = batch["coord"].numpy(), batch["mask"].numpy()
    lo = np.where(mask[..., None], coord, np.inf).min(1)
    jdc = np.where(mask[..., None], np.floor(coord - lo[:, None]), 0).astype(np.int32)
    np.testing.assert_array_equal(voxel_coords(batch["coord"], batch["mask"]).numpy(),
                                  jdc)


def test_jax_fps_takes_only_its_default_start_index():
    """ROADMAP section 3: ao_tpu's farthest_point_sampling is jitted with
    only ``m`` static, so a ``start_idx`` passed to it is traced and its
    np.full raises; only the default 0 runs (PT-v1 passes none). The port
    takes any start index (its plain version and csrc/fps.cu)."""
    from ao_tpu.ops.sampling import farthest_point_sampling as jax_fps
    from ao_tpu_torch.ops.sampling import farthest_point_sampling

    coord = np.random.default_rng(0).uniform(0, 1, (1, 64, 3)).astype(np.float32)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax_fps(jnp.asarray(coord), None, 8, 5)
    idx, valid = farthest_point_sampling(torch.from_numpy(coord), None, 8, 5)
    assert int(idx[0, 0]) == 5 and valid.all()
