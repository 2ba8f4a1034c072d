"""SemanticKITTI outdoor LiDAR dataset (port of
ao_tpu/datasets/semantic_kitti.py; reference:
pointcept/datasets/semantic_kitti.py:18-198).

Reads the raw scans ``<data_root>/dataset/sequences/<seq>/velodyne/*.bin``
(x, y, z, intensity as float32) and their ``labels/*.label`` files (uint32:
the semantic id in the low 16 bits, the instance id in the high 16),
remapped through ``learning_map``. A scan without a label file (the test
split) gets class 0, which the config's map sends to its ignore index.
Sequence splits follow the benchmark protocol; ``split`` is one split name
or a list of them.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset

SPLIT2SEQ = dict(
    train=[0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    val=[8],
    test=[11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
)


@DATASETS.register_module()
class SemanticKITTIDataset(DefaultDataset):
    def __init__(
        self,
        split="train",
        data_root="data/semantic_kitti",
        learning_map=None,
        transform=None,
        test_mode=False,
        test_cfg=None,
        loop=1,
    ):
        self.learning_map = learning_map
        super().__init__(split=split, data_root=data_root, transform=transform,
                         test_mode=test_mode, test_cfg=test_cfg, loop=loop)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else list(self.split)
        data_list = []
        for seq in (seq for s in splits for seq in SPLIT2SEQ[s]):
            vel = os.path.join(self.data_root, "dataset", "sequences",
                               str(seq).zfill(2), "velodyne")
            if os.path.isdir(vel):
                data_list += [os.path.join(vel, f) for f in sorted(os.listdir(vel))]
        return data_list

    def get_data(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        coord = scan[:, :3]
        strength = scan[:, -1].reshape(-1, 1)
        label_file = path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.exists(label_file):
            raw = np.fromfile(label_file, dtype=np.uint32).reshape(-1)
            segment = (raw & 0xFFFF).astype(np.int64)  # low 16 bits: semantics
        else:
            segment = np.zeros(coord.shape[0], np.int64)
        if self.learning_map is not None:
            # raw ids the map lacks give -1; ids past its largest key are
            # clipped onto it, as in ao_tpu
            lut = np.full(max(self.learning_map.keys()) + 1, -1, np.int64)
            for k, v in self.learning_map.items():
                lut[k] = v
            segment = lut[np.clip(segment, 0, len(lut) - 1)]
        return dict(coord=coord, strength=strength, segment=segment)

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(path)))
        frame = os.path.splitext(os.path.basename(path))[0]
        return f"{seq}_{frame}"
