"""nuScenes lidarseg dataset (port of ao_tpu/datasets/nuscenes.py;
reference: pointcept/datasets/nuscenes.py:20-139).

Driven by the preprocessed info pickles
``<data_root>/info/nuscenes_infos_{sweeps}sweeps_{split}.pkl`` (lists of
dicts with ``lidar_path``, ``lidar_token`` and, outside the test split,
``gt_segment_path``, both paths relative to ``<data_root>/raw``). Sweeps
are (N, 5) float32 bins whose intensity (0..255) becomes ``strength`` in
[-1, 1]; the uint8 lidarseg labels (32 raw classes) map to the 16
benchmark classes through :meth:`NuScenesDataset.get_learning_map`. The
sample's name is its ``lidar_token``.

``learning_map`` takes only None: the nuScenes configs inherit the
SemanticKITTI config's ``learning_map`` key and clear it so (ao_tpu's
NuScenesDataset has no such argument and refuses the configs' datasets).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class NuScenesDataset(DefaultDataset):
    def __init__(
        self,
        split="train",
        data_root="data/nuscenes",
        sweeps=10,
        transform=None,
        test_mode=False,
        test_cfg=None,
        loop=1,
        ignore_index=-1,
        learning_map=None,
    ):
        if learning_map is not None:
            raise ValueError("NuScenesDataset maps the lidarseg classes itself; "
                             "learning_map must be None")
        self.sweeps = sweeps
        self.ignore_index = ignore_index
        self.learning_map = self.get_learning_map(ignore_index)
        super().__init__(split=split, data_root=data_root, transform=transform,
                         test_mode=test_mode, test_cfg=test_cfg, loop=loop)

    def get_info_path(self, split):
        if split not in ("train", "val", "test"):
            raise ValueError(f"nuScenes split {split!r}")
        return os.path.join(self.data_root, "info",
                            f"nuscenes_infos_{self.sweeps}sweeps_{split}.pkl")

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for s in splits:
            with open(self.get_info_path(s), "rb") as f:
                data_list.extend(pickle.load(f))
        return data_list

    def get_data(self, idx):
        data = self.data_list[idx % len(self.data_list)]
        lidar_path = os.path.join(self.data_root, "raw", data["lidar_path"])
        points = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)
        coord = points[:, :3]
        strength = points[:, 3].reshape(-1, 1) / 127.5 - 1  # -> [-1, 1]
        if "gt_segment_path" in data:
            gt_path = os.path.join(self.data_root, "raw", data["gt_segment_path"])
            raw = np.fromfile(str(gt_path), dtype=np.uint8).reshape(-1)
            lut = np.full(max(self.learning_map) + 1, self.ignore_index, np.int64)
            for k, v in self.learning_map.items():
                lut[k] = v
            segment = lut[raw]
        else:
            segment = np.full(points.shape[0], self.ignore_index, np.int64)
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]["lidar_token"]

    @staticmethod
    def get_learning_map(ignore_index):
        """The 32 raw lidarseg classes -> the 16 benchmark classes."""
        return {
            0: ignore_index, 1: ignore_index, 2: 6, 3: 6, 4: 6,
            5: ignore_index, 6: 6, 7: ignore_index, 8: ignore_index, 9: 0,
            10: ignore_index, 11: ignore_index, 12: 7, 13: ignore_index,
            14: 1, 15: 2, 16: 2, 17: 3, 18: 4, 19: ignore_index,
            20: ignore_index, 21: 5, 22: 8, 23: 9, 24: 10, 25: 11, 26: 12,
            27: 13, 28: 14, 29: ignore_index, 30: 15, 31: ignore_index,
        }
