"""S3DIS dataset (port of ao_tpu/datasets/s3dis.py, standard mode).

Reads the preprocessed per-room dicts. AO's weak-label modes (on-disk
pseudo-labels for PP2S and REAL) belong to the training slice.
"""

from __future__ import annotations

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
        loop=1,
    ):
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
        if "normal" in data:
            out["normal"] = np.asarray(data["normal"], np.float32)
        return out
