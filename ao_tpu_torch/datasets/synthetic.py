"""Synthetic scene dataset for data-free smoke runs (port of
ao_tpu/datasets/synthetic.py; the reference has none).

Deterministic room-like scenes (points on a floor and a wall plane and
uniform in the box, eight Gaussian blobs, uniform colours and labels, no
instances) made from the
seed, the split's name and the scene index, so that the train path runs
without data on disk. As in the JAX package the split enters through
Python's ``hash``, which varies with PYTHONHASHSEED between processes.
"""

from __future__ import annotations

import numpy as np

from .builder import DATASETS
from .transform import Compose
from .defaults import DefaultDataset


@DATASETS.register_module()
class SyntheticDataset(DefaultDataset):
    def __init__(
        self,
        split="train",
        num_scenes=8,
        num_points=4096,
        num_classes=13,
        extent=(8.0, 8.0, 3.0),
        transform=None,
        test_mode=False,
        test_cfg=None,
        loop=1,
        seed=0,
        **_unused,
    ):
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.num_classes = num_classes
        self.extent = np.asarray(extent, np.float32)
        self.seed = seed
        super().__init__(
            split=split,
            data_root="<synthetic>",
            transform=transform,
            test_mode=test_mode,
            test_cfg=test_cfg,
            loop=loop,
        )

    def get_data_list(self):
        return [f"{self.split}_scene{i:04d}" for i in range(self.num_scenes)]

    def get_data(self, idx):
        i = idx % len(self.data_list)
        rng = np.random.default_rng(self.seed * 100003 + hash(self.split) % 1000 + i)
        n = self.num_points
        # a few planar "walls/floor" plus blobs, roughly room-like
        n_plane = n // 2
        plane = rng.uniform(0, 1, size=(n_plane, 3)).astype(np.float32) * self.extent
        plane[: n_plane // 3, 2] = 0.0
        plane[n_plane // 3 : 2 * n_plane // 3, 0] = 0.0
        n_blob = n - n_plane
        centers = rng.uniform(0.5, 0.9, size=(8, 3)).astype(np.float32) * self.extent
        blob = (
            centers[rng.integers(0, 8, n_blob)]
            + rng.normal(0, 0.3, size=(n_blob, 3)).astype(np.float32)
        )
        coord = np.concatenate([plane, blob]).astype(np.float32)
        color = rng.uniform(0, 255, size=(n, 3)).astype(np.float32)
        segment = rng.integers(0, self.num_classes, size=n).astype(np.int64)
        return dict(
            name=self.get_data_name(i),
            coord=coord,
            color=color,
            segment=segment,
            instance=-np.ones(n, np.int64),
        )

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]
