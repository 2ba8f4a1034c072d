"""ao_tpu_torch and chip_smoke.py stand alone: they import neither JAX nor
ao_tpu (nor flax or optax), build no extension through
torch.utils.cpp_extension, and the smoke script's slice phase, train
phase (the hook-driven trainer, with its evaluation of a validation room
and its checkpoints), AO phase (PP2S in oracle mode, a REAL run whose
epoch ends with a refinement round over oracle masks in a fork pool, and
the neural SAM's embeddings and decodes at SamConfig.tiny()) and ScanNet
phase (ScanNetDataset, its transforms, Mix3D, OneCycle, the tester's
10 views), outdoor phase (SemanticKITTIDataset, PointClip, a train step
with enable_checkpoint, the nuScenes test with the submission writer) and
PT-v2m1 phase run end to end (on the CPU, at a tiny size) with JAX and
ao_tpu made unimportable; and every PT-v2 config, every
sparse-convolution config and every CAC, PointGroup and MSC config
(building its model) loads through the port's Config without importing
ao_tpu (the ScanNet200 configs' own import of ao_tpu's class names is
served from the port's copy), the heads' entry points run, the port's
clustering library leaves native/ untouched, the PT-v1 and ModelNet40
configs load and build, with a classification step, its tester and the
part-segmentation tester run, and every config but the four of the
backbones not ported yet builds its model (the Swin3D ones their
datasets); each dataset preprocessor's main runs on a micro raw input and
a ConcatDataset of the preprocessed S3DIS areas loads."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
import importlib, pkgutil
import ao_tpu_torch
for m in pkgutil.walk_packages(ao_tpu_torch.__path__, "ao_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
res, votes, n_views = chip_smoke.run_slice(
    "cpu", 0, room_size=(1.0, 0.8, 0.5), views=1, pad_multiple=256)
chip_smoke.check_votes(votes, n_views)
rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2, 3)]
_, options = chip_smoke.train_setup(rooms[:2], batch_size=2, max_steps=1,
                                    workers=0, val_room=rooms[2])
backbone = dict(patch_embed_channels=16, patch_embed_groups=2,
                enc_channels=(16, 32, 64), enc_groups=(2, 4, 8),
                dec_channels=(16, 16, 32), dec_groups=(2, 2, 4),
                enc_depths=(1, 1, 1), patch_embed_depth=1)
trainer = chip_smoke.run_train("cpu", options + [
    f"model.backbone={backbone!r}", "pad_multiple=512"])
chip_smoke.check_train(trainer, 1)
chip_smoke.check_val(trainer)
ao_rooms = [chip_smoke.make_room(s, (1.2, 1.0, 0.8), 0.05) for s in (1, 2, 3)]
workdir, options, seconds, labels = chip_smoke.real_setup(
    ao_rooms[:2], ao_rooms[2], size=64, views=2, batch_size=2, max_steps=1,
    workers=0, device="cpu")
real, record = chip_smoke.run_real("cpu", options + [
    f"model.backbone={backbone!r}", "pad_multiple=512",
    "real.refine_workers=2"])
chip_smoke.check_real(real, record, workdir + "/sam_labels")
sam = chip_smoke.run_sam(workdir, record["baskets"][0], "cpu",
                         model_type="tiny", size=64)
assert sam["masks"] > 0 and len(sam["set_image_ms"]) == 2
sc_rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.05)
            for s in (1, 2, 3)]
workdir, options = chip_smoke.scannet_setup(
    sc_rooms[:2], sc_rooms[2], batch_size=2, max_steps=2, workers=0)
sc_backbone = dict(backbone, enc_channels=(16, 32, 64, 64),
                   enc_groups=(2, 4, 8, 8), dec_channels=(16, 16, 32, 64),
                   dec_groups=(2, 2, 4, 8), enc_depths=(1, 1, 1, 1))
sc_options = [f"model.backbone.{k}={v!r}" for k, v in sc_backbone.items()]
sc = chip_smoke.run_scannet_train("cpu", options + sc_options + [
    "pad_multiple=512", "max_points=4096"])
chip_smoke.check_scannet_train(sc, 2)
sc_res, sc_votes, sc_views = chip_smoke.run_scannet_test(
    "cpu", sc.model, workdir, sc_options + ["pad_multiple=512"])
chip_smoke.check_votes(sc_votes, sc_views, num_classes=20)
ring = dict(beams=16, steps=256)
scans = [chip_smoke.make_scan(s, **ring) for s in range(3)]
sweep = chip_smoke.make_scan(9, beams=8, steps=200)
workdir = chip_smoke.outdoor_setup(scans, sweep=sweep)
kitti = chip_smoke.run_train("cpu",
    chip_smoke.kitti_options(workdir, 3, 2, 1, workers=0) + sc_options + [
        "pad_multiple=512", "max_points=4096",
        "model.backbone.enable_checkpoint=True"], chip_smoke.KITTI_CONFIG)
chip_smoke.check_train(kitti, 1)
chip_smoke.run_submit_test(chip_smoke.NUSCENES_SUBMIT_CONFIG, "cpu", 0, workdir, [
    f"save_path={workdir}/nuscenes_test", f"data.test.data_root={workdir}/nuscenes",
    "pad_multiple=512"] + sc_options)
pred = chip_smoke.check_submission(
    f"{workdir}/nuscenes_test/result/submit/lidarseg/test/test0000_lidarseg.bin",
    len(sweep["coord"]), "uint8", set(range(1, 17)))
m1 = chip_smoke.run_train("cpu", chip_smoke.train_setup(
    rooms[:2], batch_size=2, max_steps=1, workers=0)[1] + [
    f"model.backbone.{k}={v!r}" for k, v in backbone.items()] + [
    "pad_multiple=512", "model.backbone.enable_checkpoint=True"],
    chip_smoke.PTV2M1_CONFIG)
chip_smoke.check_train(m1, 1)
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("ISOLATED", res["scenes"][0]["fragments"], trainer.history[0]["loss"],
      real.refine_history[0]["num_updated"], sam["prompts"],
      sc.history[-1]["loss"], sc_res["scenes"][0]["fragments"],
      kitti.history[0]["loss"], len(pred), m1.history[0]["loss"])
"""

_CONFIGS = r"""
import glob, sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
from ao_tpu_torch.utils import Config
from ao_tpu_torch.utils.config import CONFIG_IMPORTS
files = [f for f in sorted(glob.glob("configs/*/semseg-pt-v2m*.py"))]
names = []
for f in files:
    cfg = Config.fromfile(f)
    names.append(len(cfg.data.names))
assert all(sys.modules.get(n) is None for n in CONFIG_IMPORTS)
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("CONFIGS", len(files), names.count(200))
"""


def test_port_runs_without_jax_or_ao_tpu(tmp_path):
    # one intra-op thread: beside the other test workers a full thread pool
    # of many small ops oversubscribes the cores (the child takes about
    # 70 s on one thread alone, and timed out at 300 s with eight under
    # six busy workers)
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ISOLATED" in res.stdout


def test_every_ptv2_config_loads_without_ao_tpu():
    """Every configs/*/semseg-pt-v2m*.py (the PT-v2m1 and PT-v2m2 configs;
    the CAC ones are named semseg-cac-*) loads through the port's
    Config.fromfile in a process where jax and ao_tpu are unimportable,
    and no ao_tpu module is imported: the ScanNet200 configs' own
    ``from <ao_tpu's scannet_meta> import CLASS_LABELS_200`` is served
    from ao_tpu_torch/datasets/scannet_meta.py while the config runs, and
    the name is gone from sys.modules after."""
    res = subprocess.run(
        [sys.executable, "-c", _CONFIGS], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    n, n200 = map(int, res.stdout.split("CONFIGS")[1].split())
    assert n >= 20 and n200 == 4


_SPARSE_CONFIGS = r"""
import glob, sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
from ao_tpu_torch.models import build_model
from ao_tpu_torch.utils import Config
files = sorted(glob.glob("configs/*/semseg-spunet-*.py")
               + glob.glob("configs/*/semseg-minkunet34c-*.py")
               + glob.glob("configs/*/semseg-spvcnn-*.py"))
types = set()
for f in files:
    cfg = Config.fromfile(f)
    types.add(cfg.model.backbone.type)
    build_model(dict(cfg.model, backbone=dict(
        cfg.model.backbone, channels=(8,) * 8, layers=(1,) * 8)))
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("SPARSE", len(files), " ".join(sorted(types)))
"""


def test_every_sparse_config_loads_without_ao_tpu():
    """All 27 sparse-convolution semseg configs (configs/*/semseg-spunet-*,
    semseg-minkunet34c-* and semseg-spvcnn-*) load through the port's
    Config and build their model (at a narrow width) in a process where
    jax and ao_tpu are unimportable, importing no ao_tpu module."""
    res = subprocess.run(
        [sys.executable, "-c", _SPARSE_CONFIGS], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    n, *types = res.stdout.split("SPARSE")[1].split()
    assert int(n) == 27
    assert types == ["MinkUNet34C", "SPVCNN", "SpUNet-v1m1", "SpUNet-v1m2"]


_HEADS = r"""
import glob, subprocess, sys, tempfile
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
import numpy as np
import chip_smoke
from ao_tpu_torch.models import build_model
from ao_tpu_torch.ops.cluster import bfs_cluster
from ao_tpu_torch.utils import Config
narrow = {
    "SpUNet-v1m1": dict(channels=(8,) * 8, layers=(1,) * 8),
    "PT-v2m2": dict(patch_embed_channels=16, patch_embed_groups=2,
                    enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
                    dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
                    enc_depths=(1, 1, 1, 1)),
}
files = sorted(glob.glob("configs/*/semseg-cac-*.py")
               + glob.glob("configs/*/insseg-pointgroup-*.py")
               + glob.glob("configs/*/pretrain-msc-*.py"))
types = set()
for f in files:
    cfg = Config.fromfile(f)
    bb = cfg.model.backbone
    types.add(cfg.model.type)
    build_model(dict(cfg.model, backbone=dict(bb, **narrow[bb.type]),
                     backbone_out_channels=16 if bb.type == "PT-v2m2" else 8))
labels, n = bfs_cluster(np.random.default_rng(0).uniform(0, 3, (3000, 3)),
                        np.zeros(3000, np.int32), radius=0.5, min_points=5)
assert n > 0
tiny = ["model.backbone.base_channels=8",
        "model.backbone.channels=(8, 8, 16, 16, 16, 8, 8, 8)",
        "model.backbone.layers=(1, 1, 1, 1, 1, 1, 1, 1)",
        "model.backbone_out_channels=8", "pad_multiple=512", "max_points=4096"]
rooms = [chip_smoke.make_scannet_room(s, (1.2, 1.0, 0.8), 0.05) for s in (1, 2, 3)]
work, options = chip_smoke.scannet_setup(rooms[:2], rooms[2], batch_size=2,
                                         max_steps=1, workers=0)
cac = chip_smoke.run_train("cpu", options + tiny, chip_smoke.CAC_CONFIG)
pg = chip_smoke.run_train("cpu", options + tiny + [
    "evaluate=True", f"data.val.data_root={work}/scannet"], chip_smoke.PG_CONFIG,
    "train_insseg")
msc = chip_smoke.run_train("cpu", [f"save_path={tempfile.mkdtemp()}", "max_steps=1",
                                   "num_worker=0", "enable_tensorboard=False"],
                           "configs/synthetic/pretrain-msc-smoke.py", "train_pretrain")
assert np.isfinite([cac.history[0]["kl_loss"], pg.history[0]["bias_l1_loss"],
                    msc.history[0]["nce_loss"]]).all()
assert pg.comm_info["insseg_result"]["scenes"] == 1
from ao_tpu_torch.datasets import build_dataset
pair_root, _ = chip_smoke.pair_setup(tempfile.mkdtemp(), scenes=((21, (1.6, 1.4, 1.2)),),
                                     frames=3, spacing=0.06)
pc = Config.fromfile("configs/scannet/pretrain-msc-v1m1-1-spunet-pointcontrast.py")
pair = build_dataset(dict(pc.data.train, data_root=pair_root))
assert len(pair) > 0 and pair[0]["view1_feat"].shape[1] == 3
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("HEADS", len(files), " ".join(sorted(types)))
"""


def test_heads_configs_and_entry_points_without_ao_tpu():
    """With jax and ao_tpu unimportable: every configs/*/semseg-cac-*,
    insseg-pointgroup-* and pretrain-msc-* config (13, PointContrast's
    among them) loads through the port's Config and builds its model at a
    narrow width; the PointContrast config's ScanNetPairDataset builds on a
    tiny pair directory (one .sens scene through the port's preprocessor)
    and yields a pair; the port's bfs_cluster builds its
    library and clusters; a step of the CAC config through the train entry
    point, of the PointGroup config through train_insseg (its evaluator
    scoring the val room) and of the synthetic MSC config through
    train_pretrain run at tiny widths. After it, git sees no change under
    native/ (the port never builds into the JAX package's library)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _HEADS], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    n, *types = res.stdout.split("HEADS")[1].split()
    assert int(n) == 13
    assert types == ["CAC-v1m1", "MSC-v1m1", "MSC-v1m2", "PG-v1m1"]
    status = subprocess.run(["git", "status", "--porcelain", "native/"], cwd=ROOT,
                            capture_output=True, text=True, timeout=60)
    assert status.returncode == 0 and status.stdout == ""


_PTV1 = r"""
import sys, tempfile
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
import numpy as np
import chip_smoke
from ao_tpu_torch.models import build_model
from ao_tpu_torch.tools.test import main as test_main
from ao_tpu_torch.utils import Config
files = ["configs/s3dis/semseg-pt-v1-0-base.py", "configs/scannet/semseg-pt-v1-0-base.py",
         "configs/scannet200/semseg-pt-v1-0-base.py",
         "configs/modelnet40/cls-ptv1-0-base.py",
         "configs/modelnet40/cls-spunet-v1m1-0-base.py"]
types = []
for f in files:
    cfg = Config.fromfile(f)
    types.append(f"{cfg.model.type}/{cfg.model.backbone.type}")
    build_model(dict(cfg.model))
work = tempfile.mkdtemp()
names = list(Config.fromfile(files[3]).data.names)
root = chip_smoke.modelnet_setup(work, names[:4], n_points=1500)
cls = chip_smoke.run_train("cpu", chip_smoke.cls_options(
    root, 4, 2, 1, work + "/cls", 0, workers=0), files[3])
res = test_main(["--config-file", files[3], "--device", "cpu", "--options",
                 f"weight={work}/cls/model/model_last.pt",
                 f"save_path={work}/cls_test", f"data.test.data_root={root}"])
ps = chip_smoke.run_partseg("cpu", chip_smoke.shapenetpart_setup(
    work, shapes=((0, 400), (4, 500))), work, 0,
    backbone="PointTransformer-PartSeg26", pad_multiple=256)
assert np.isfinite([cls.history[0]["loss"], cls.comm_info["val_result"]["allAcc"],
                    res["allAcc"], ps["ins_mIoU"]]).all()
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("PTV1", " ".join(types))
"""


def test_ptv1_and_modelnet_configs_without_ao_tpu():
    """With jax and ao_tpu unimportable: the three PT-v1 semseg configs and
    the two ModelNet40 configs load through the port's Config and build
    their models as written; a ModelNet Cls26 step (its ClsEvaluator on
    the test split) and its ClsTester, and a PartSeg26 PartSegTester run on
    synthetic shapes through chip_smoke's helpers."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _PTV1], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.split("PTV1")[1].split() == [
        "DefaultSegmentor/PointTransformer-Seg50"] * 3 + [
        "DefaultSegmentor/PointTransformer-Cls26", "DefaultClassifier/SpUNet-v1m1"]


_ALL_CONFIGS = r"""
import glob, sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
import torch
from ao_tpu_torch.datasets import build_dataset
from ao_tpu_torch.models import build_model
from ao_tpu_torch.utils import Config
files = sorted(f for f in glob.glob("configs/*/*.py") if "/_base_/" not in f)
built, refused = [], []
for f in files:
    cfg = Config.fromfile(f)
    try:
        with torch.device("meta"):
            build_model(dict(cfg.model))
        built.append(f)
    except KeyError as e:
        assert "is not registered" in str(e), (f, e)
        refused.append(cfg.model.get("backbone", cfg.model).type)
for f in files:
    if not any(k in f for k in ("swin3d", "-st-", "stv1m2", "octformer")):
        continue
    cfg = Config.fromfile(f)
    for split in ("train", "val", "test"):
        build_dataset(dict(cfg.data[split], data_root="/nonexistent"))
    bb = cfg.model.backbone
    feat_keys = next(t for t in cfg.data.train.transform
                     if t["type"] == "Collect")["feat_keys"]
    print("NEW", f, bb.type, bb.in_channels, "+".join(feat_keys),
          bb.get("normal_channels"))
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("ALL", len(files), len(built), " ".join(sorted(refused)))
"""


def test_every_config_builds_without_ao_tpu():
    """With jax and ao_tpu unimportable, every config under configs/ (81,
    _base_ aside) loads through the port's Config and builds its model on
    the meta device: none is refused. The six Swin3D, three Stratified and
    one OctFormer configs also build their train, val and test datasets
    (transforms, the test views): Swin3D S3DIS with in_channels 9 and
    (coord, color, normal) features, Swin3D ScanNet and Structured3D with
    6 and (color, normal), normals at channels 3:6; ST-v1m1 with 6 and
    (color, normal), the two ST-v1m2 with 9 over the same 6 features (the
    port runs them with in_channels=6, ROADMAP.md section 3); OctFormer
    with 9 and (coord, color, normal)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _ALL_CONFIGS], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    n, n_built, *refused = res.stdout.split("ALL")[1].split()
    assert (int(n), int(n_built), refused) == (81, 81, [])
    new = [line.split()[1:] for line in res.stdout.splitlines()
           if line.startswith("NEW")]
    assert sorted(t for _, t, *_ in new) == ["OctFormer-v1m1", "ST-v1m1"] + [
        "ST-v1m2"] * 2 + ["Swin3D-v1m1"] * 6
    for f, kind, in_channels, feat_keys, *normal in new:
        if kind == "Swin3D-v1m1" and f.startswith("configs/s3dis"):
            assert (in_channels, feat_keys) == ("9", "coord+color+normal")
        elif kind == "Swin3D-v1m1":
            assert (in_channels, feat_keys, normal) == (
                "6", "color+normal", ["(3,", "6)"])
        elif kind == "OctFormer-v1m1":
            assert (in_channels, feat_keys) == ("9", "coord+color+normal")
        else:
            assert (in_channels, feat_keys) == (
                "6" if kind == "ST-v1m1" else "9", "color+normal")


_PREPROCESS = r"""
import os, sys
for name in ("jax", "ao_tpu", "flax", "optax"):
    sys.modules[name] = None
sys.path.insert(0, "tests")
import numpy as np
import chip_smoke
import preprocessing_inputs as inputs
from ao_tpu_torch.datasets import build_dataset
from ao_tpu_torch.datasets.preprocessing import (
    preprocess_arkitscenes, preprocess_nuscenes_info, preprocess_s3dis,
    preprocess_scannet, preprocess_structured3d)
from ao_tpu_torch.ops import ball_query, random_ball_query
from ao_tpu_torch.utils import cache, path, ply, visualization
from ao_tpu_torch.utils.events import JSONWriter, get_event_storage
from ao_tpu_torch.engines.hooks.misc import DataCacheOperator, RuntimeProfilerV2
tmp = sys.argv[1]
raw, out = os.path.join(tmp, "raw"), os.path.join(tmp, "out")
chip_smoke.write_raw_s3dis(os.path.join(raw, "s3dis"), {
    (1, "office_1"): chip_smoke.make_room(1, (0.8, 0.6, 0.5), 0.1),
    (2, "office_2"): chip_smoke.make_room(2, (0.8, 0.6, 0.5), 0.1)})
preprocess_s3dis.main(["--dataset-root", os.path.join(raw, "s3dis"),
                       "--output-root", os.path.join(out, "s3dis"),
                       "--num-workers", "2"])
scans, tsv = inputs.write_scannet_scene(os.path.join(raw, "scannet"))
preprocess_scannet.main(["--dataset-root", scans, "--output-root",
                         os.path.join(out, "scannet"), "--label-tsv", tsv,
                         "--num-workers", "1"])
preprocess_structured3d.main([
    "--dataset-root", inputs.write_structured3d_zip(os.path.join(raw, "s3d")),
    "--output-root", os.path.join(out, "s3d")])
preprocess_arkitscenes.main([
    "--dataset-root", inputs.write_arkitscenes_mesh(os.path.join(raw, "ark")),
    "--output-root", os.path.join(out, "ark")])
preprocess_nuscenes_info.main([
    "--dataset-root", inputs.write_nuscenes_db(os.path.join(raw, "nus")),
    "--output-root", os.path.join(out, "nus"), "--version", "v1.0-mini",
    "--max-sweeps", "3"])
ds = build_dataset(dict(type="ConcatDataset", datasets=[
    dict(type="S3DISDataset", split=a, data_root=os.path.join(out, "s3dis"),
         transform=[]) for a in ("Area_1", "Area_2")]))
found = sorted(os.path.relpath(os.path.join(d, n), out)
               for d, _, names in os.walk(out) for n in names)
assert len(ds) == 2 and ds[1]["coord"].shape[1] == 3
assert not any(k == "jax" or k.startswith(("jax.", "ao_tpu.", "flax", "optax"))
               for k, v in sys.modules.items() if v is not None)
print("PREPROCESSED", found)
"""


def test_preprocessors_run_without_jax_or_ao_tpu(tmp_path):
    """With jax and ao_tpu blocked: the new modules import, each
    preprocessor's main writes its files from a micro raw input
    (tests/preprocessing_inputs.py; S3DIS over two spawned workers), and a
    ConcatDataset of the preprocessed S3DIS areas loads."""
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _PREPROCESS, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert ("PREPROCESSED ['ark/Training/41069021.npz', "
            "'ark/Validation/42000001.npz', "
            "'nus/info/nuscenes_infos_3sweeps_train.pkl', "
            "'nus/info/nuscenes_infos_3sweeps_val.pkl', "
            "'s3d/train/scene_00001/room_42.npz', 's3dis/Area_1/office_1.npz', "
            "'s3dis/Area_2/office_2.npz', 'scannet/train/scene0000_00.npz']"
            ) in res.stdout


def test_port_sources_name_no_jax_no_ao_tpu_no_cpp_extension():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ao_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    bad = re.compile(r"cpp_extension|import jax|from jax|ao_tpu\.|import ao_tpu\b"
                     r"|import flax|from flax|import optax|from optax"
                     r"|torch/extension\.h|import triton")
    names = {os.path.relpath(f, ROOT) for f in files}
    for src in ("gva_pos.cu", "gva_stats.cu", "gva_bwd.cu", "gva_tile.cuh",
                "point_bn.cu"):
        assert f"ao_tpu_torch/csrc/{src}" in names
    for mod in ("engines/train.py", "tools/train.py", "models/losses/misc.py",
                "utils/optimizer.py", "utils/scheduler.py",
                "pp2s/projection.py", "pp2s/labels.py", "pp2s/pipeline.py",
                "models/sam/oracle.py", "models/sam/modeling.py",
                "models/sam/convert.py", "models/sam/predictor.py",
                "engines/label_eval.py", "engines/train_real.py",
                "utils/comm.py", "tools/pp2s.py", "tools/train_pp2s.py",
                "tools/train_real.py", "tools/evaluate_labels.py",
                "datasets/scannet.py", "datasets/collate.py",
                "datasets/transform.py", "models/losses/lovasz.py",
                "datasets/semantic_kitti.py", "datasets/nuscenes.py",
                "datasets/scannet_meta.py", "engines/test.py",
                "utils/config.py", "models/point_transformer_v2/ptv2m2.py",
                "models/point_transformer_v2/convert.py", "ops/grouping.py",
                "ops/sparse_conv.py", "models/sparse_unet/spunet.py",
                "models/sparse_unet/mink_spvcnn.py",
                "models/sparse_unet/convert.py", "datasets/misc_datasets.py",
                "engines/hooks/misc.py", "models/default.py",
                "models/context_aware_classifier/cac.py",
                "models/point_group/point_group.py",
                "models/masked_scene_contrast/msc.py", "ops/cluster.py",
                "csrc/host/cluster.cpp", "engines/insseg_eval.py",
                "engines/train_insseg.py", "engines/train_pretrain.py",
                "tools/train_insseg.py", "tools/train_pretrain.py",
                "datasets/synthetic.py", "ops/knn.py", "ops/sampling.py",
                "csrc/fps.cu", "models/point_transformer/ptv1.py",
                "models/point_transformer/convert.py", "datasets/modelnet.py",
                "engines/hooks/evaluator.py", "ops/window_partition.py",
                "models/swin3d/swin3d.py", "models/swin3d/convert.py",
                "models/stratified_transformer/stratified.py",
                "models/stratified_transformer/convert.py",
                "models/octformer/octformer.py", "models/octformer/convert.py",
                "engines/launch.py", "engines/defaults.py", "tools/test.py",
                "datasets/preprocessing/preprocess_scannet_pair.py",
                "models/utils.py", "ops/gva.py",
                "datasets/preprocessing/preprocess_s3dis.py",
                "datasets/preprocessing/preprocess_scannet.py",
                "datasets/preprocessing/preprocess_structured3d.py",
                "datasets/preprocessing/preprocess_arkitscenes.py",
                "datasets/preprocessing/preprocess_nuscenes_info.py",
                "datasets/preprocessing/_pool.py", "datasets/defaults.py",
                "ops/ball_query.py", "utils/cache.py", "utils/path.py",
                "utils/ply.py", "utils/visualization.py", "utils/events.py",
                "utils/checkpoint.py", "utils/misc.py",
                "models/losses/lovasz.py", "ops/point_bn.py"):
        assert f"ao_tpu_torch/{mod}" in names
    # the one place that names an ao_tpu module: the module name that the
    # config loader serves from the port's copy (a sys.modules key, never
    # imported; test_every_ptv2_config_loads_without_ao_tpu)
    from ao_tpu_torch.utils.config import CONFIG_IMPORTS

    served = [f'"{name}": "{port}",' for name, port in CONFIG_IMPORTS.items()]
    assert len(served) == 1
    hits = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if bad.search(line) and line.strip() not in served:
                    hits.append(f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_chip_smoke_refuses_to_run_without_a_card():
    """Off the card the script exits non-zero and prints no result."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
