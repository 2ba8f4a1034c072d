"""PointContrast's pair data on the port, on the CPU: the ScanNet pair
preprocessor (ao_tpu_torch/datasets/preprocessing/preprocess_scannet_pair.py)
file for file against ao_tpu's on the same ``.sens`` scenes,
ScanNetPairDataset item for item against ao_tpu's, and a train step of
configs/scannet/pretrain-msc-v1m1-1-spunet-pointcontrast.py at a tiny
width through the pretraining entry point."""

import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from ao_tpu.datasets.misc_datasets import ScanNetPairDataset as JaxPairDataset
from ao_tpu.datasets.preprocessing import preprocess_scannet_pair as jax_pre
from ao_tpu_torch.datasets import build_dataset
from ao_tpu_torch.datasets.misc_datasets import ScanNetPairDataset
from ao_tpu_torch.datasets.preprocessing import preprocess_scannet_pair as pre
from ao_tpu_torch.utils import Config

# two small rooms, three frames each (the JAX package's overlap walks its
# voxels through a Python set: keep the clouds small)
SCENES = ((21, (2.4, 2.0, 1.6)), (22, (2.6, 2.2, 1.8)))
FRAMES = 3
SPACING = 0.05
# the view transforms that draw nothing, so that both packages' items are
# comparable (the config's own transforms run in the step below)
PLAIN_VIEW = [dict(type="CenterShift", apply_z=True),
              dict(type="Copy", keys_dict={"coord": "origin_coord"}),
              dict(type="NormalizeColor")]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The scenes as .sens streams, then both preprocessors over them into
    one output root in turn: (raw root, output root, the JAX package's
    files, the port's files), each files a {relative path: bytes}."""
    root = tmp_path_factory.mktemp("pairs")
    raw, out = str(root / "raw"), str(root / "scannet_pair")
    chip_smoke.write_pair_scenes(raw, SCENES, FRAMES, SPACING)
    argv = ["--dataset-root", raw, "--output-root", out, "--frame-skip", "1"]

    def files():
        found = {}
        for path in glob.glob(os.path.join(out, "**", "*"), recursive=True):
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    found[os.path.relpath(path, out)] = f.read()
        return found

    jax_pre.main(argv)
    jax_files = files()
    for path in jax_files:
        os.remove(os.path.join(out, path))
    pre.main(argv)
    return raw, out, jax_files, files()


def test_preprocessor_files_equal_ao_tpu(pairs):
    """Every file of the port's run against ao_tpu's run on the same input
    and output root: the same names; each overlap.txt and overlap30.txt
    byte for byte (so the vectorised overlap ratios equal the JAX
    package's set walk's); each frame's .npz with the same arrays, dtypes
    and values (the zip container stamps its write time)."""
    _, _, jax_files, port_files = pairs
    assert set(port_files) == set(jax_files)
    npz = sorted(k for k in port_files if k.endswith(".npz"))
    assert len(npz) == len(SCENES) * FRAMES
    assert "overlap30.txt" in port_files
    lines = 0
    for name, data in port_files.items():
        if name.endswith(".txt"):
            assert data == jax_files[name], name
            lines += data.count(b"\n")
        else:
            import io

            a, b = np.load(io.BytesIO(data)), np.load(io.BytesIO(jax_files[name]))
            assert a.files == b.files, name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
    assert lines > 0


def test_overlap_ratio_equals_the_set_walk():
    """overlap_ratio on random clouds (clustered, touching, disjoint, one
    empty) equals ao_tpu's 27-neighbourhood set walk exactly."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.3, (400, 3))
    cases = [(a, a + 0.02), (a, rng.normal(0.4, 0.3, (300, 3))),
             (a, a + 5.0), (a, np.zeros((0, 3))),
             (rng.uniform(-1, 1, (500, 3)), rng.uniform(-0.5, 1.5, (600, 3)))]
    for c0, c1 in cases:
        for voxel in (0.05, 0.1):
            assert pre.overlap_ratio(c0, c1, voxel) == jax_pre.overlap_ratio(
                c0, c1, voxel)


def test_pair_dataset_matches_ao_tpu(pairs):
    """ScanNetPairDataset on the preprocessed pairs against ao_tpu's: the
    same pair list at overlap_threshold 0.3 (and at 0, every pair), and
    each item's keys, dtypes and values under per-view transforms that
    draw nothing (the view keys prefixed after each view's own transform);
    a view without ``coord`` collects with the config's Collect, which
    the JAX package's raises on."""
    _, out, _, _ = pairs
    kw = dict(data_root=out, split="train", view1_transform=PLAIN_VIEW,
              view2_transform=PLAIN_VIEW[:1], transform=[])
    for thr in (0.3, 0.0):
        ours = ScanNetPairDataset(overlap_threshold=thr, **kw)
        ref = JaxPairDataset(overlap_threshold=thr, **kw)
        assert ours.data_list == ref.data_list and len(ours) > 0
    for i in range(len(ours)):
        a, b = ours.get_data(i), ref.get_data(i)
        assert set(a) == set(b), i
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
    cfg = Config.fromfile(chip_smoke.POINTCONTRAST_CONFIG)
    ds = build_dataset(dict(cfg.data.train, data_root=out))
    item = ds[0]
    assert item["view1_feat"].shape[1] == 3 and "offset" not in item
    jax_ds = JaxPairDataset(**{k: v for k, v in cfg.to_dict()["data"]["train"].items()
                               if k != "type"} | dict(data_root=out))
    with pytest.raises(KeyError, match="coord"):
        jax_ds[0]


def test_pointcontrast_config_step(pairs, tmp_path):
    """Two steps of the PointContrast config (MSC-v1m1 without masks, no
    colour or normal reconstruction, nce_t 0.07, the config's view
    transforms) through ao_tpu_torch.tools.train_pretrain at a tiny
    SpUNet width on the preprocessed pairs: finite NCE losses, matched
    pairs every step, and the parameters moved."""
    _, out, _, _ = pairs
    torch.set_num_threads(1)
    trainer = chip_smoke.run_train("cpu", [
        f"save_path={tmp_path}", f"data.train.data_root={out}", "batch_size=2",
        "max_steps=2", "num_worker=0", "enable_tensorboard=False",
        "pad_multiple=512", "model.backbone.base_channels=8",
        "model.backbone.channels=(8, 8, 16, 16, 16, 8, 8, 8)",
        "model.backbone.layers=(1, 1, 1, 1, 1, 1, 1, 1)",
        "model.backbone_out_channels=8"], chip_smoke.POINTCONTRAST_CONFIG,
        "train_pretrain")
    hist = trainer.history
    assert len(hist) == 2
    for r in hist:
        assert np.isfinite(r["loss"]) and np.isfinite(r["nce_loss"]), r
        assert r["pairs"] > 0 and "color_loss" not in r
    changed, _ = chip_smoke.check_train(trainer, 2)
    assert changed > 0
