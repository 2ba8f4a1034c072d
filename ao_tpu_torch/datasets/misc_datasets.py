"""Structured3D, ArkitScenes, ScanNetPair and ShapeNetPart (port of
ao_tpu/datasets/misc_datasets.py; reference pointcept/datasets/
{structure3d, arkitscenes, scannet_pair, shapenet_part}.py)."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene
from .transform import Compose


@DATASETS.register_module()
class Structured3DDataset(DefaultDataset):
    """Rooms lie one directory deeper than DefaultDataset's scenes:
    ``<data_root>/<split>/<scene>/<room>.pth`` (or ``.npz``), named
    ``<scene>_<room>``."""

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            for ext in ("pth", "npz"):
                data_list += glob.glob(os.path.join(self.data_root, split,
                                                    f"*/*.{ext}"))
        return sorted(data_list)

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        scene = os.path.basename(os.path.dirname(path))
        room = os.path.splitext(os.path.basename(path))[0]
        return f"{scene}_{room}"


@DATASETS.register_module()
class ArkitScenesDataset(DefaultDataset):
    """ARKitScenes mesh scenes: coord, color (and normal where stored);
    no public labels, so every segment is -1."""

    def get_data(self, idx):
        data = load_scene(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        out = dict(coord=coord, color=np.asarray(data["color"], np.float32),
                   segment=-np.ones(coord.shape[0], np.int64))
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        return out


@DATASETS.register_module()
class ScanNetPairDataset(DefaultDataset):
    """Two-view contrastive pretraining pairs (PointContrast; reference
    scannet_pair.py): the frame-cloud pairs of every
    ``<data_root>/<scene>/pcd/overlap.txt`` (written by
    ``datasets/preprocessing/preprocess_scannet_pair.py``) whose overlap
    exceeds ``overlap_threshold``. An item loads both frames, runs each
    through its own view transform (``view1_transform`` /
    ``view2_transform``), prefixes its keys ``view1_`` / ``view2_`` and
    then runs the shared ``transform``."""

    def __init__(self, overlap_threshold=0.3, view1_transform=None,
                 view2_transform=None, **kwargs):
        self.overlap_threshold = overlap_threshold
        self.view1_transform = Compose(view1_transform or [])
        self.view2_transform = Compose(view2_transform or [])
        super().__init__(**kwargs)

    def get_data_list(self):
        data_list = []
        for overlap_path in glob.glob(
                os.path.join(self.data_root, "*", "pcd", "overlap.txt")):
            root = os.path.dirname(overlap_path)
            with open(overlap_path) as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) == 3 and float(parts[2]) > self.overlap_threshold:
                        data_list.append(tuple(
                            os.path.join(root, os.path.basename(p))
                            for p in parts[:2]))
        return data_list

    def get_data(self, idx):
        out = {}
        paths = self.data_list[idx % len(self.data_list)]
        for prefix, view_tf, path in zip(
                ("view1_", "view2_"),
                (self.view1_transform, self.view2_transform), paths):
            view = load_scene(path)
            vd = {"coord": np.asarray(view["coord"], np.float32)}
            for key in ("color", "normal"):
                if key in view:
                    vd[key] = np.asarray(view[key], np.float32)
            for key, value in view_tf(vd).items():
                out[prefix + key] = value
        return out

    def prepare_train_data(self, idx):
        return self.transform(self.get_data(idx))


@DATASETS.register_module()
class ShapeNetPartDataset(DefaultDataset):
    """ShapeNetPart part segmentation (reference shapenet_part.py:20-160):
    16 categories named in ``synsetoffset2category.txt`` (name and token a
    line), 50 part labels; the split's shapes listed in
    ``train_test_split/shuffled_<split>_file_list.json`` as
    ``shape_data/<token>/<name>``, each ``<data_root>/<token>/<name>.txt``
    of whitespace-separated (x, y, z, normal, part) rows."""

    category2part = {
        "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
        "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
        "Earphone": [16, 17, 18], "Guitar": [19, 20, 21], "Knife": [22, 23],
        "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
        "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
        "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
        "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
    }

    def __init__(self, **kwargs):
        data_root = kwargs.get(
            "data_root",
            "data/shapenetcore_partanno_segmentation_benchmark_v0_normal")
        self.categories = []
        self.token2category = {}
        with open(os.path.join(data_root, "synsetoffset2category.txt")) as f:
            for line in f:
                name, token = line.strip().split()
                self.token2category[token] = len(self.categories)
                self.categories.append(name)
        super().__init__(**kwargs)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for split in splits:
            split_file = os.path.join(self.data_root, "train_test_split",
                                      f"shuffled_{split}_file_list.json")
            with open(split_file) as f:
                data_list += [os.path.join(self.data_root, p[11:] + ".txt")
                              for p in json.load(f)]
        return data_list

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        data = np.loadtxt(path).astype(np.float32)
        token = os.path.basename(os.path.dirname(path))
        return dict(coord=data[:, :3], normal=data[:, 3:6],
                    segment=data[:, 6].astype(np.int64),
                    category=np.array([self.token2category[token]]))
