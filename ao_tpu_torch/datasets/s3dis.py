"""S3DIS dataset with AO's weak-label modes (port of
ao_tpu/datasets/s3dis.py; reference: pointcept/datasets/s3dis.py:23-245).

Standard mode reads the preprocessed per-room dicts. Weak modes
(``weak=True`` with ``mode`` 'pp2s' or 'real') replace ``segment`` with the
on-disk pseudo-labels ``<weak_path>/<area>/<room>.npy`` and set
``instance`` to each point's original row, so that sampled points map back
to full-scene rows for REAL's logit basket. The labels are read again on
every ``__getitem__``, so labels that REAL's refinement rewrites take
effect in the next epoch. ``cache`` is accepted for the configs' sake and,
as in the JAX package, unused.
"""

from __future__ import annotations

import os

import numpy as np

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene


@DATASETS.register_module()
class S3DISDataset(DefaultDataset):
    def __init__(
        self,
        split=("Area_1", "Area_2", "Area_3", "Area_4", "Area_6"),
        data_root="data/s3dis",
        transform=None,
        test_mode=False,
        test_cfg=None,
        cache=False,
        loop=1,
        weak=False,
        weak_path=None,
        mode="pp2s",
    ):
        self.weak = weak
        self.weak_path = weak_path
        self.mode = mode
        super().__init__(
            split=split,
            data_root=data_root,
            transform=transform,
            test_mode=test_mode,
            test_cfg=test_cfg,
            loop=loop,
        )

    def get_data(self, idx):
        data_path = self.data_list[idx % len(self.data_list)]
        data = load_scene(data_path)
        coord = np.asarray(data["coord"], np.float32)
        n = coord.shape[0]
        out = dict(
            name=self.get_data_name(idx),
            coord=coord,
            color=np.asarray(data["color"], np.float32),
            segment=(
                np.asarray(data["semantic_gt"], np.int64).reshape(-1)
                if "semantic_gt" in data else -np.ones(n, np.int64)
            ),
            instance=(
                np.asarray(data["instance_gt"], np.int64).reshape(-1)
                if "instance_gt" in data else -np.ones(n, np.int64)
            ),
            scene_id=data_path,
        )
        if self.weak and self.mode in ("pp2s", "real"):
            area = os.path.basename(os.path.dirname(data_path))
            room = os.path.splitext(os.path.basename(data_path))[0]
            label_path = os.path.join(self.weak_path, area, room + ".npy")
            out["segment"] = np.load(label_path).reshape(-1).astype(np.int64)
            out["instance"] = np.arange(n, dtype=np.int64)
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        return out
