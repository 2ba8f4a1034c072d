"""ModelNet40 classification (port of ao_tpu/datasets/modelnet.py;
reference: pointcept/datasets/modelnet.py:20-104).

``<data_root>/modelnet40_<split>.txt`` lists the shapes, one name a line
(``<shape>_<number>``); each is ``<data_root>/<shape>/<name>.txt``, one
point a line, comma-separated x, y, z and the normal. The category is the
shape's index in ``class_names``. Test samples take the plain transform
(the tester forwards each once).
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset


@DATASETS.register_module()
class ModelNetDataset(DefaultDataset):
    def __init__(
        self,
        split="train",
        data_root="data/modelnet40_normal_resampled",
        class_names=None,
        transform=None,
        test_mode=False,
        test_cfg=None,
        cache_data=False,
        loop=1,
    ):
        names = list(class_names or [])
        self.class_names = dict(zip(names, range(len(names))))
        self.cache_data = cache_data
        self._cache = {}
        super().__init__(split=split, data_root=data_root, transform=transform,
                         test_mode=test_mode, test_cfg=test_cfg, loop=loop)

    def get_data_list(self):
        if not isinstance(self.split, str):
            raise TypeError(f"ModelNetDataset: split must be a str: {self.split}")
        split_path = os.path.join(self.data_root, f"modelnet40_{self.split}.txt")
        return list(np.loadtxt(split_path, dtype=str))

    def get_data(self, idx):
        data_idx = idx % len(self.data_list)
        if data_idx in self._cache:
            coord, normal, category = self._cache[data_idx]
        else:
            name = self.data_list[data_idx]
            shape = "_".join(name.split("_")[0:-1])
            data = np.loadtxt(os.path.join(self.data_root, shape, name + ".txt"),
                              delimiter=",").astype(np.float32)
            coord, normal = data[:, 0:3], data[:, 3:6]
            category = np.array([self.class_names[shape]])
            if self.cache_data:
                self._cache[data_idx] = (coord, normal, category)
        return dict(coord=coord.copy(), normal=normal.copy(), category=category)

    def get_data_name(self, idx):
        return self.data_list[idx % len(self.data_list)]

    def prepare_test_data(self, idx):
        return self.transform(self.get_data(idx))
