"""Structured3D, ArkitScenes and ShapeNetPart (port of
ao_tpu/datasets/misc_datasets.py; reference pointcept/datasets/
{structure3d, arkitscenes, shapenet_part}.py). ScanNetPairDataset is not
ported yet."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene


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
