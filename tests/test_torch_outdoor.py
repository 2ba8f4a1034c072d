"""The outdoor LiDAR modules of ao_tpu_torch and the benchmark submission
writers, against ao_tpu's on the same inputs: PointClip, the
SemanticKITTI and nuScenes datasets, the SemanticKITTI train chain with
fixed draws and its test fragments, SemSegTester.save_submission's files
for ScanNet, ScanNet200, SemanticKITTI and nuScenes, a narrow outdoor
PT-v2m2 (4 input channels, four stages, an S=8 patch embed, map
unpooling), and the SemanticKITTI, nuScenes and ScanNet200 PT-v2m2 configs
taking a CPU step through the train entry point (the submit configs also
testing with submit=True)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.datasets.transform as jt
import chip_smoke
from ao_tpu.datasets.nuscenes import NuScenesDataset as JNuScenes
from ao_tpu.datasets.semantic_kitti import SemanticKITTIDataset as JKitti
from ao_tpu.engines.test import SemSegTester as JTester
from ao_tpu.models import build_model as jax_build_model
from ao_tpu_torch.datasets import build_dataset
from ao_tpu_torch.datasets import transform as tt
from ao_tpu_torch.datasets.nuscenes import NuScenesDataset
from ao_tpu_torch.datasets.semantic_kitti import SemanticKITTIDataset
from ao_tpu_torch.engines.test import SemSegTester
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.utils import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = os.path.join(ROOT, "configs", "semantic_kitti", "semseg-pt-v2m2-0-base.py")
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
# a small ring: a few thousand points a sweep
_RING = dict(beams=16, steps=256)


def _scans(n, seed=0, **ring):
    return [chip_smoke.make_scan(seed + i, **(ring or _RING)) for i in range(n)]


def test_point_clip_matches_jax():
    """Coordinates clipped onto the range's faces: equal arrays."""
    rng = np.random.default_rng(0)
    d = dict(coord=rng.uniform(-80, 80, (500, 3)).astype(np.float32),
             strength=rng.random((500, 1)).astype(np.float32))
    box = (-51.2, -51.2, -4, 51.2, 51.2, 2.4)
    t = tt.PointClip(box)({k: v.copy() for k, v in d.items()})
    j = jt.PointClip(box)({k: v.copy() for k, v in d.items()})
    for k in d:
        np.testing.assert_array_equal(t[k], j[k])
    assert t["coord"].min() >= -51.2 and t["coord"][:, 2].max() <= 2.4


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Two train sequences (00, 01), the val sequence 08 and a test
    sequence 11 without labels (a denser sweep, whose voxels near the
    sensor hold several points); the raw labels carry instance ids in
    their upper 16 bits."""
    root = str(tmp_path_factory.mktemp("kitti"))
    scans = _scans(5) + _scans(1, seed=5, beams=32, steps=1024)
    assert any((s["label"] >> 16).any() for s in scans)
    chip_smoke.write_kitti(root, {0: scans[:2], 1: scans[2:3], 8: scans[3:5],
                                  11: scans[5:]})
    return root


@pytest.mark.parametrize("split", ["train", ["train", "val"], "test"])
def test_semantic_kitti_dataset_matches_jax(kitti_root, split):
    """The scan list of a split (or a list of splits), and each scan's
    coord, strength and segment (the learning map on the low 16 bits;
    zeros through the map where no label file exists) and its name
    ``<seq>_<frame>``: equal to ao_tpu's."""
    lmap = Config.fromfile(KITTI).learning_map
    t = SemanticKITTIDataset(split=split, data_root=kitti_root, learning_map=lmap)
    j = JKitti(split=split, data_root=kitti_root, learning_map=lmap)
    assert t.data_list == j.data_list and len(t) > 0
    for i in range(len(t)):
        a, b = t.get_data(i), j.get_data(i)
        assert set(a) == set(b) == {"coord", "strength", "segment"}
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert t.get_data_name(i) == j.get_data_name(i)
    if split == "test":
        assert (t.get_data(0)["segment"] == -1).all()
    else:
        assert len(np.unique(t.get_data(0)["segment"])) > 5


@pytest.fixture(scope="module")
def nuscenes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuscenes"))
    scans = _scans(5, seed=10, beams=8, steps=200)
    chip_smoke.write_nuscenes(root, {"train": scans[:2], "val": scans[2:4],
                                     "test": scans[4:]})
    return root


@pytest.mark.parametrize("split", ["train", ["train", "val"], "test"])
def test_nuscenes_dataset_matches_jax(nuscenes_root, split):
    """The info pickles' samples of a split (or a list), each sweep's
    coord, strength (intensity / 127.5 - 1) and segment (the lidarseg
    labels through the 32 -> 16 map; the ignore index without labels) and
    its name (the lidar token): equal to ao_tpu's."""
    t = NuScenesDataset(split=split, data_root=nuscenes_root)
    j = JNuScenes(split=split, data_root=nuscenes_root)
    assert t.data_list == j.data_list and len(t) > 0
    for i in range(len(t)):
        a, b = t.get_data(i), j.get_data(i)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert t.get_data_name(i) == j.get_data_name(i)


def test_nuscenes_config_builds_its_datasets(nuscenes_root):
    """The nuScenes config inherits SemanticKITTI's ``learning_map`` key and
    clears it (``learning_map=None``). The port's NuScenesDataset takes it;
    ao_tpu's has no such argument and refuses the config's datasets (a
    fault of the reference, which the configs cannot change)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "nuscenes",
                                       "semseg-pt-v2m2-0-base.py"))
    train = dict(cfg.data.train, data_root=nuscenes_root)
    assert train["learning_map"] is None
    ds = build_dataset(train)
    assert len(ds) == 2 and ds[0]["coord"].shape[1] == 3
    with pytest.raises(TypeError, match="learning_map"):
        JNuScenes(**{k: v for k, v in train.items() if k != "type"})
    with pytest.raises(ValueError):
        NuScenesDataset(data_root=nuscenes_root, learning_map={0: 0})


def _jax_draws(monkeypatch, seed):
    """Make ao_tpu's transforms draw what the port's draw from torch's
    default generator seeded with ``seed``, in the same order:
    random.random / np.random.rand / uniform / randn / randint as the
    port's torch.rand / randn / randint calls."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo=0.0, hi=1.0, size=None):
        n = 1 if size is None else size
        u = lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64).numpy()
        return u[0] if size is None else u

    def randint(lo, hi=None, size=None):
        if hi is None:  # randint(n): one draw in [0, n)
            return int(torch.randint(0, lo, (1,), generator=g))
        return torch.randint(lo, hi, (size,), generator=g).numpy()

    monkeypatch.setattr(jt.random, "random", lambda: uniform())
    monkeypatch.setattr(jt.np.random, "rand", lambda: uniform())
    monkeypatch.setattr(jt.np.random, "uniform", uniform)
    monkeypatch.setattr(jt.np.random, "randn", lambda *s: torch.randn(
        s, generator=g, dtype=torch.float64).numpy())
    monkeypatch.setattr(jt.np.random, "randint", randint)


@pytest.mark.parametrize("seed", [0, 3])
def test_kitti_train_chain_matches_jax(monkeypatch, kitti_root, seed):
    """The SemanticKITTI config's train pipeline (PointClip, RandomRotate
    about the sensor, RandomScale, RandomFlip, RandomJitter, GridSample at
    0.05 m with discrete coords, SphereCrop, ToTensor, Collect of coord /
    discrete_coord / segment and feat = coord | strength) on a scan, with
    ao_tpu's draws fixed to the port's: every collected array within 1e-6
    (measured 0). The crop is cut to 2000 points so that SphereCrop
    draws."""
    cfg = Config.fromfile(KITTI)
    chain = [dict(t) for t in cfg.data.train.transform]
    next(t for t in chain if t["type"] == "SphereCrop")["point_max"] = 2000
    lmap = cfg.learning_map
    t_ds = SemanticKITTIDataset("train", kitti_root, lmap, transform=chain)
    j_ds = JKitti("train", kitti_root, lmap, transform=chain)
    torch.manual_seed(seed)
    a = t_ds[1]
    _jax_draws(monkeypatch, seed)
    b = j_ds[1]
    assert set(a) == set(b)
    for k in b:
        assert np.asarray(a[k]).shape == np.asarray(b[k]).shape, k
        assert np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k])).max() <= 1e-6, k
    assert a["feat"].shape == (2000, 4)


def test_kitti_test_fragments_match_jax(kitti_root):
    """The config's test mode on a test scan: the full-resolution segment,
    the name, and every GridSample test fragment's coord, discrete_coord,
    index and feat: equal to ao_tpu's."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "semantic_kitti",
                                       "semseg-pt-v2m2-1-benchmark-submit.py"))
    test = {k: v for k, v in cfg.data.test.items() if k != "type"}
    test["data_root"] = kitti_root
    a, b = SemanticKITTIDataset(**test)[0], JKitti(**test)[0]
    assert a["name"] == b["name"] == "11_000000"
    np.testing.assert_array_equal(a["segment"], b["segment"])
    assert len(a["fragment_list"]) == len(b["fragment_list"]) > 1
    for fa, fb in zip(a["fragment_list"], b["fragment_list"]):
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                          err_msg=k)


_SUBMIT = {
    "ScanNetDataset": 20, "ScanNet200Dataset": 200,
    "SemanticKITTIDataset": 19, "NuScenesDataset": 16,
}


@pytest.mark.parametrize("dtype", sorted(_SUBMIT))
def test_save_submission_matches_jax(tmp_path, dtype):
    """For one scene's prediction the port writes the same files, byte for
    byte, as ao_tpu's SemSegTester.save_submission (ScanNet(200) raw class
    ids as text, SemanticKITTI uint32 through learning_map_inv, nuScenes
    uint8 of pred + 1), and nothing without ``submit``."""
    K = _SUBMIT[dtype]
    pred = np.random.default_rng(K).integers(0, K, 3000)
    name = "08_000042" if dtype == "SemanticKITTIDataset" else "scene0707_00"
    cfg = Config(dict(dataset_type=dtype, submit=True))
    if dtype == "SemanticKITTIDataset":
        cfg.learning_map_inv = Config.fromfile(KITTI).learning_map_inv
    files = {}
    for side, tester in (("port", SemSegTester), ("jax", JTester)):
        out = tmp_path / side
        tester.save_submission(cfg, str(out), name, pred, None)
        files[side] = {os.path.relpath(os.path.join(d, f), out):
                       open(os.path.join(d, f), "rb").read()
                       for d, _, fs in os.walk(out) for f in fs}
    assert files["port"] == files["jax"] and len(files["port"]) == 1
    cfg.submit = False
    SemSegTester.save_submission(cfg, str(tmp_path / "off"), name, pred, None)
    assert not (tmp_path / "off").exists()


_OUTDOOR = dict(
    type="PT-v2m2", in_channels=4, num_classes=19, patch_embed_channels=16,
    patch_embed_groups=2, patch_embed_neighbours=8, enc_depths=(1, 1, 1, 1),
    enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
    enc_neighbours=(16, 16, 16, 16), dec_depths=(1, 1, 1, 1),
    dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
    dec_neighbours=(16, 16, 16, 16), grid_sizes=(0.15, 0.375, 0.9375, 2.34375),
    unpool_backend="map", stage_cap_ratios=(0.35, 0.35, 0.35, 0.35))


@pytest.fixture(scope="module")
def outdoor_backbone():
    """The narrow outdoor PT-v2m2 of both packages with ao_tpu's weights
    carried across, and two small LiDAR sweeps (one padded)."""
    n = 2048
    sweeps = _scans(2, seed=20, beams=16, steps=160)
    coord = np.zeros((2, n, 3), np.float32)
    feat = np.zeros((2, n, 4), np.float32)
    mask = np.zeros((2, n), bool)
    for b, s in enumerate(sweeps):
        m = min(len(s["coord"]), n - 300 * b)
        coord[b, :m] = s["coord"][:m] / 4  # a 20 m street in a small cloud
        feat[b, :m] = np.concatenate([coord[b, :m], s["intensity"][:m, None]], 1)
        mask[b, :m] = True
    jmodel = jax_build_model(dict(_OUTDOOR))
    arrays = (coord, feat, mask)
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                               *(jnp.asarray(a) for a in arrays))
    var = dict(params=var["params"], batch_stats=var["batch_stats"])
    return jmodel, var, arrays


@pytest.mark.parametrize("train", [False, True])
def test_outdoor_backbone_matches_jax(outdoor_backbone, train):
    """A narrow PT-v2m2 shaped as the SemanticKITTI config (in_channels = 4,
    four stages, an S = 8 patch embed, map unpooling, its grid sizes) on
    two small LiDAR sweeps (one padded), with ao_tpu's weights carried
    across by from_jax_variables, in f32 on both packages' CPU path.
    Eval: logits within 1e-4 x scale (measured 6.4e-7). Train (batch
    statistics): logits within 1e-3 x scale (measured 6.1e-5: fifteen
    batch-statistic blocks amplify the frameworks' f32 differences, as in
    test_torch_train_step.py), the updated running statistics within 1e-4
    (measured 4.6e-6), and the clusters that overflowed the 0.35 stage
    capacities (merged into each stage's last, as ao_tpu does) equal."""
    jmodel, var, (coord, feat, mask) = outdoor_backbone
    args = tuple(jnp.asarray(a) for a in (coord, feat, mask))
    tmodel = build_model(dict(_OUTDOOR))
    tmodel.load_state_dict(convert.from_jax_variables(
        _np(var["params"]), _np(var["batch_stats"])), strict=True)
    with torch.no_grad():
        tout = tmodel.train(train)(*(torch.from_numpy(a) for a in (coord, feat, mask)))
    if train:
        jout, mut = jax.jit(lambda v: jmodel.apply(
            v, *args, False, False, mutable=["batch_stats", "diagnostics"]))(var)
        sd = tmodel.state_dict()
        for k, v in convert.from_jax_variables(
                _np(var["params"]), _np(mut["batch_stats"])).items():
            if "running" in k:
                assert np.abs(sd[k].numpy() - v.numpy()).max() <= 1e-4 * max(
                    np.abs(v.numpy()).max(), 1.0), k
        overflow = sum(int(np.sum(x)) for x in
                       jax.tree_util.tree_leaves(mut["diagnostics"]))
        assert int(tmodel.pool_overflow) == overflow > 0
    else:
        jout = jax.jit(lambda v: jmodel.apply(v, *args, True, True))(var)
    jout = np.asarray(jout, np.float32)
    err = np.abs(tout.numpy() - jout)[mask].max()
    assert err < (1e-3 if train else 1e-4) * max(np.abs(jout).max(), 1.0)


# ---------------------------------------------------------------- configs

_NARROW = dict(patch_embed_channels=16, patch_embed_groups=2,
               enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
               dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
               enc_depths=(1, 1, 1, 1))


def _narrow_options():
    return [f"model.backbone.{k}={v!r}" for k, v in _NARROW.items()] + [
        "pad_multiple=512", "max_points=4096"]


@pytest.mark.parametrize("config", [
    "semantic_kitti/semseg-pt-v2m2-0-base.py",
    "semantic_kitti/semseg-pt-v2m2-1-benchmark-submit.py",
    "nuscenes/semseg-pt-v2m2-0-base.py",
    "nuscenes/semseg-pt-v2m2-1-benchmark-submit.py",
])
def test_outdoor_config_trains_and_submits(tmp_path, config):
    """The four outdoor PT-v2m2 configs (f32 as written, OneCycle, the
    cross-entropy + Lovasz criteria, drop path 0.3) take one train step
    through the train entry point on the CPU at narrow widths on small
    synthetic sweeps (the submit configs train on train + val), with a
    finite loss at OneCycle's first lr. The submit configs then test their
    test split through the test entry point with ``submit=True``: one
    SemanticKITTI ``.label`` (uint32 raw ids of learning_map_inv) or
    nuScenes ``_lidarseg.bin`` (uint8 in 1..16) per scan, one value a
    point."""
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.tools.train import main as train_main
    from ao_tpu_torch.utils.scheduler import onecycle_lr

    path = os.path.join(ROOT, "configs", config)
    scans = _scans(3, seed=30)
    kitti = config.startswith("semantic_kitti")
    root = str(tmp_path / "data")
    if kitti:
        chip_smoke.write_kitti(root, {0: scans[:1], 8: scans[1:2], 11: scans[2:]})
    else:
        chip_smoke.write_nuscenes(root, {"train": scans[:1], "val": scans[1:2],
                                         "test": scans[2:]})
    options = [f"save_path={tmp_path / 'exp'}", f"data.train.data_root={root}",
               "batch_size=1", "max_steps=1", "num_worker=0", "evaluate=False",
               "enable_tensorboard=False"] + _narrow_options()
    trainer = train_main(["--config-file", path, "--device", "cpu",
                          "--options", *options])
    (rec,) = trainer.history
    s = trainer.cfg.scheduler
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    assert rec["lr"] == pytest.approx(onecycle_lr(
        0, trainer.total_steps, s.max_lr, s.pct_start, s.div_factor,
        s.final_div_factor), rel=1e-12)
    n_train = 2 if "submit" in config else 1
    assert len(trainer.train_loader.dataset) == n_train
    if "submit" not in config:
        return
    torch.save(trainer.model.state_dict(), tmp_path / "model.pt")
    test_main(["--config-file", path, "--device", "cpu", "--options",
               f"weight={tmp_path / 'model.pt'}", f"save_path={tmp_path / 'test'}",
               f"data.test.data_root={root}", "submit=True",
               *_narrow_options()])
    sub = tmp_path / "test" / "result" / "submit"
    n = len(scans[2]["coord"])
    if kitti:
        pred = np.fromfile(sub / "sequences" / "11" / "predictions" /
                           "000000.label", np.uint32)
        allowed = set(trainer.cfg.learning_map_inv.values())
    else:
        pred = np.fromfile(sub / "lidarseg" / "test" / "test0000_lidarseg.bin",
                           np.uint8)
        allowed = set(range(1, 17))
    assert len(pred) == n and set(np.unique(pred).tolist()) <= allowed


@pytest.mark.parametrize("config", ["semseg-pt-v2m2-0-base.py",
                                    "semseg-pt-v2m2-1-benchmark-submit.py",
                                    "semseg-pt-v2m2-2-lovasz.py"])
def test_scannet200_config_trains(tmp_path, config):
    """The ScanNet200 PT-v2m2 configs build (their class names served from
    the port's scannet_meta) and take one CPU train step at narrow widths
    on synthetic rooms labelled in ScanNet200's classes. The submit config
    then writes one ``.txt`` of raw ScanNet200 ids a test scene with
    ``submit=True``."""
    from ao_tpu_torch.datasets.scannet_meta import VALID_CLASS_IDS_200
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.tools.train import main as train_main

    path = os.path.join(ROOT, "configs", "scannet200", config)
    rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.06)
             for s in (1, 2, 3)]
    for r in rooms:  # ScanNet200 labels: the 20-class ids spread over 200
        r["semantic_gt200"] = np.where(r["semantic_gt20"] < 0, -1,
                                       r["semantic_gt20"] * 9)
    root = tmp_path / "scannet200"
    for split, scenes in (("train", rooms[:2]), ("val", rooms[2:]),
                          ("test", rooms[2:])):
        os.makedirs(root / split, exist_ok=True)
        for i, room in enumerate(scenes):
            torch.save(room, root / split / f"scene{i:04d}_00.pth")
    options = [f"save_path={tmp_path / 'exp'}", f"data.train.data_root={root}",
               "batch_size=2", "max_steps=1", "num_worker=0", "evaluate=False",
               "enable_tensorboard=False"] + _narrow_options()
    trainer = train_main(["--config-file", path, "--device", "cpu",
                          "--options", *options])
    assert trainer.cfg.data.num_classes == 200 == len(trainer.cfg.data.names)
    (rec,) = trainer.history
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    if "submit" not in config:
        return
    torch.save(trainer.model.state_dict(), tmp_path / "model.pt")
    test_main(["--config-file", path, "--device", "cpu", "--options",
               f"weight={tmp_path / 'model.pt'}", f"save_path={tmp_path / 'test'}",
               f"data.test.data_root={root}", "submit=True",
               "data.test.test_cfg.aug_transform=[[]]", *_narrow_options()])
    ids = np.loadtxt(tmp_path / "test" / "result" / "submit" / "scene0000_00.txt",
                     dtype=np.int64)
    assert len(ids) == len(rooms[2]["coord"])
    assert set(np.unique(ids).tolist()) <= set(VALID_CLASS_IDS_200)
