"""Base dataset (port of ao_tpu/datasets/defaults.py).

Scenes are ``.npz`` or ``.pth`` files under ``<data_root>/<split>/``
holding ``coord/color/normal/semantic_gt/instance_gt`` arrays. Train
path: load -> transform. Test path: base transform -> per-TTA-view
GridSample fragmentation -> post transform of each fragment; the tester
votes the fragments back onto the whole scene.
"""

from __future__ import annotations

import glob
import os
from collections.abc import Sequence
from copy import deepcopy

import numpy as np
import torch

from ..utils.logger import get_root_logger
from .builder import DATASETS, build_dataset
from .transform import TRANSFORMS, Compose


def load_scene(path: str) -> dict:
    """Load a scene dict from .npz or .pth (a torch-saved dict)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in data.items()
    }


@DATASETS.register_module()
class DefaultDataset:
    def __init__(
        self,
        split="train",
        data_root="data/dataset",
        transform=None,
        test_mode=False,
        test_cfg=None,
        loop=1,
    ):
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform)
        self.loop = loop if not test_mode else 1
        self.test_mode = test_mode
        self.test_cfg = test_cfg if test_mode else None

        if test_mode:
            voxelize = self.test_cfg.get("voxelize")
            crop = self.test_cfg.get("crop")
            self.test_voxelize = (
                TRANSFORMS.build(dict(voxelize)) if voxelize is not None else None
            )
            self.test_crop = (
                TRANSFORMS.build(dict(crop)) if crop is not None else None
            )
            self.post_transform = Compose(self.test_cfg.get("post_transform"))
            self.aug_transform = [
                Compose(aug) for aug in self.test_cfg.get("aug_transform", [[]])
            ]

        self.data_list = self.get_data_list()
        get_root_logger().info(
            f"Totally {len(self.data_list)} x {self.loop} samples in "
            f"{split} set."
        )

    def get_data_list(self):
        if isinstance(self.split, str):
            splits = [self.split]
        elif isinstance(self.split, Sequence):
            splits = list(self.split)
        else:
            raise TypeError(f"split must be a str or a sequence: {self.split}")
        data_list = []
        for split in splits:
            data_list += glob.glob(os.path.join(self.data_root, split, "*.pth"))
            data_list += glob.glob(os.path.join(self.data_root, split, "*.npz"))
        return sorted(data_list)

    def get_data(self, idx):
        data = load_scene(self.data_list[idx % len(self.data_list)])
        coord = data["coord"]
        out = dict(coord=np.asarray(coord, np.float32))
        if "color" in data:
            out["color"] = np.asarray(data["color"], np.float32)
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        if "semantic_gt" in data:
            out["segment"] = np.asarray(data["semantic_gt"], np.int64).reshape(-1)
        else:
            out["segment"] = -np.ones(coord.shape[0], np.int64)
        if "instance_gt" in data:
            out["instance"] = np.asarray(data["instance_gt"], np.int64).reshape(-1)
        return out

    def get_data_name(self, idx):
        return os.path.splitext(
            os.path.basename(self.data_list[idx % len(self.data_list)])
        )[0]

    def prepare_train_data(self, idx):
        return self.transform(self.get_data(idx))

    def prepare_test_data(self, idx):
        """Whole-scene test sample: the full-resolution labels, the scene
        name and the fragments of every TTA view."""
        data_dict = self.get_data(idx)
        segment = data_dict.pop("segment")
        result_dict = dict(segment=segment, name=self.get_data_name(idx))
        if "category" in data_dict:  # part segmentation: the shape class
            result_dict["category"] = data_dict["category"]
        data_dict = self.transform(data_dict)

        fragment_list = []
        for aug in self.aug_transform:
            data = aug(deepcopy(data_dict))
            if self.test_voxelize is not None:
                data_part_list = self.test_voxelize(data)
            else:
                data["index"] = np.arange(data["coord"].shape[0])
                data_part_list = [data]
            for data_part in data_part_list:
                if self.test_crop is not None:
                    fragment_list += self.test_crop(data_part)
                else:
                    fragment_list.append(data_part)
        result_dict["fragment_list"] = [
            self.post_transform(frag) for frag in fragment_list
        ]
        return result_dict

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_data(idx)
        return self.prepare_train_data(idx)

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class ConcatDataset:
    """Several datasets as one (port of ao_tpu/datasets/defaults.py:154):
    ``data_list`` holds every (dataset, item) pair in order, each dataset
    at its own length (its ``loop`` included), and the whole repeats
    ``loop`` times."""

    def __init__(self, datasets, loop=1):
        self.datasets = [build_dataset(d) for d in datasets]
        self.loop = loop
        self.data_list = [(i, j) for i, ds in enumerate(self.datasets)
                          for j in range(len(ds))]
        get_root_logger().info(
            f"Totally {len(self.data_list)} x {self.loop} samples in the "
            f"concat set.")

    def __getitem__(self, idx):
        ds_idx, sample_idx = self.data_list[idx % len(self.data_list)]
        return self.datasets[ds_idx][sample_idx]

    def __len__(self):
        return len(self.data_list) * self.loop
