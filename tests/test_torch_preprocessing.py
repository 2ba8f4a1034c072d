"""The port's dataset preprocessors against ao_tpu's, file for file on the
micro raw inputs of tests/preprocessing_inputs.py: both packages'
converters write into two directories, which must hold the same file
names with equal arrays (and equal pickles for nuScenes' infos).
ao_tpu's S3DIS and ScanNet CLIs run their rooms in a forked process
pool, which a process with JAX's threads must not fork: their per-room
functions (``parse_room``, ``process_scene``) are called directly, the
port's through its ``main``."""

import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from ao_tpu.datasets.preprocessing import preprocess_arkitscenes as j_ark
from ao_tpu.datasets.preprocessing import preprocess_nuscenes_info as j_nus
from ao_tpu.datasets.preprocessing import preprocess_s3dis as j_s3dis
from ao_tpu.datasets.preprocessing import preprocess_scannet as j_scannet
from ao_tpu.datasets.preprocessing import preprocess_structured3d as j_s3d
from ao_tpu_torch.datasets.preprocessing import preprocess_arkitscenes as t_ark
from ao_tpu_torch.datasets.preprocessing import preprocess_nuscenes_info as t_nus
from ao_tpu_torch.datasets.preprocessing import preprocess_s3dis as t_s3dis
from ao_tpu_torch.datasets.preprocessing import preprocess_scannet as t_scannet
from ao_tpu_torch.datasets.preprocessing import preprocess_structured3d as t_s3d

import preprocessing_inputs as inputs

torch.set_num_threads(1)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _same_npz_trees(a, b):
    names = _files(a)
    assert names and names == _files(b), (names, _files(b))
    for name in names:
        with np.load(os.path.join(a, name)) as za, np.load(os.path.join(b, name)) as zb:
            assert sorted(za.files) == sorted(zb.files), name
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name}:{k}")
    return names


def test_s3dis_matches_jax(tmp_path):
    """Three raw rooms over two areas (make_room's classes and instances,
    one annotation file an instance): the same .npz a room with equal
    coord, color, semantic_gt and instance_gt; the port's main over two
    spawned workers."""
    raw = str(tmp_path / "raw")
    rooms = {(1, "office_1"): chip_smoke.make_room(1, (1.0, 0.8, 0.6), 0.08),
             (1, "hallway_2"): chip_smoke.make_room(2, (1.2, 0.8, 0.6), 0.08),
             (2, "office_3"): chip_smoke.make_room(3, (0.9, 0.9, 0.6), 0.08)}
    chip_smoke.write_raw_s3dis(raw, rooms)
    for area, name in rooms:
        j_s3dis.parse_room(os.path.join(raw, f"Area_{area}", name),
                           str(tmp_path / "jax"))
    t_s3dis.main(["--dataset-root", raw, "--output-root", str(tmp_path / "port"),
                  "--num-workers", "2"])
    names = _same_npz_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["Area_1/hallway_2.npz", "Area_1/office_1.npz",
                     "Area_2/office_3.npz"]
    with np.load(tmp_path / "port" / "Area_1" / "office_1.npz") as z:
        room = rooms[(1, "office_1")]
        assert len(z["coord"]) == len(room["coord"])
        assert set(np.unique(z["semantic_gt"])) == set(
            np.unique(room["semantic_gt"]))


def test_scannet_matches_jax(tmp_path):
    """One scan (ply, segments, aggregation, label tsv): the same .npz with
    equal coord, color, ScanNet-20 / ScanNet-200 labels and instances."""
    scans, tsv = inputs.write_scannet_scene(str(tmp_path / "raw"))
    scene = os.path.join(scans, "scene0000_00")
    j_scannet.process_scene(scene, str(tmp_path / "jax"),
                            j_scannet.read_label_mapping(tsv), "val")
    t_scannet.main(["--dataset-root", scans, "--output-root",
                    str(tmp_path / "port"), "--label-tsv", tsv, "--split",
                    "val", "--num-workers", "1"])
    assert _same_npz_trees(str(tmp_path / "jax"), str(tmp_path / "port")) == [
        "val/scene0000_00.npz"]
    with np.load(tmp_path / "port" / "val" / "scene0000_00.npz") as z:
        assert set(np.unique(z["semantic_gt20"])) >= {-1, 0}
        assert set(np.unique(z["instance_gt"])) == {-1, 0, 1, 2, 3}


@pytest.mark.parametrize("extra", [[], ["--no-pano"]])
def test_structured3d_matches_jax(tmp_path, extra):
    """The Structured3D zip (a perspective frame and a panorama), both
    views and the perspective one alone: the same room .npz with equal
    coord, color, normal and semantic_gt."""
    root = inputs.write_structured3d_zip(str(tmp_path / "raw"))
    for pkg, out in ((j_s3d, "jax"), (t_s3d, "port")):
        pkg.main(["--dataset-root", root, "--output-root",
                  str(tmp_path / out)] + extra)
    assert _same_npz_trees(str(tmp_path / "jax"), str(tmp_path / "port")) == [
        "train/scene_00001/room_42.npz"]


def test_arkitscenes_matches_jax(tmp_path):
    """Two meshes (a flat and a folded square): the same .npz a scene with
    equal coord, color and area-weighted vertex normals."""
    root = inputs.write_arkitscenes_mesh(str(tmp_path / "raw"))
    for pkg, out in ((j_ark, "jax"), (t_ark, "port")):
        pkg.main(["--dataset-root", root, "--output-root", str(tmp_path / out)])
    assert _same_npz_trees(str(tmp_path / "jax"), str(tmp_path / "port")) == [
        "Training/41069021.npz", "Validation/42000001.npz"]


def _same(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("sweeps", [2, 3])
def test_nuscenes_info_matches_jax(tmp_path, sweeps):
    """The micro database (v1.0-mini, a moving ego pose): the same info
    pickles, entry for entry, with equal sweep transforms."""
    root = inputs.write_nuscenes_db(str(tmp_path / "raw"))
    for pkg, out in ((j_nus, "jax"), (t_nus, "port")):
        pkg.main(["--dataset-root", root, "--output-root", str(tmp_path / out),
                  "--version", "v1.0-mini", "--max-sweeps", str(sweeps)])
    names = _files(str(tmp_path / "jax"))
    assert names == _files(str(tmp_path / "port")) == [
        f"info/nuscenes_infos_{sweeps}sweeps_{s}.pkl" for s in ("train", "val")]
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            b = pickle.load(f)
        _same(a, b, name)
    assert len(a) == 0 and len(b) == 0  # val: the mini split's other scenes
    with open(tmp_path / "port" / names[0], "rb") as f:
        train = pickle.load(f)
    assert len(train) == 2 and len(train[0]["sweeps"]) == sweeps - 1
