"""ScanNet / ScanNet200 datasets with the limited-reconstruction and
limited-annotation modes (port of ao_tpu/datasets/scannet.py; reference:
pointcept/datasets/scannet.py:30-204).

Scenes are the preprocessed ``<data_root>/<split>/<scene>.pth`` dicts
(``coord``, ``color``, ``normal``, ``semantic_gt20`` / ``semantic_gt200``,
``instance_gt``). ``lr_file`` lists the train scenes to use (limited
reconstructions); ``la_file`` maps a scene name to its labelled point
indices (limited annotations): every other point's label becomes
``ignore_index``, and the indices ride along as ``sampled_index``, which
RandomDropout and GridSample keep in the sample.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .builder import DATASETS
from .defaults import DefaultDataset, load_scene


@DATASETS.register_module()
class ScanNetDataset(DefaultDataset):
    segment_key = "semantic_gt20"

    def __init__(
        self,
        split="train",
        data_root="data/scannet",
        transform=None,
        lr_file=None,
        la_file=None,
        ignore_index=-1,
        test_mode=False,
        test_cfg=None,
        cache=False,
        loop=1,
    ):
        self.lr_file = lr_file
        self.ignore_index = ignore_index
        super().__init__(split=split, data_root=data_root, transform=transform,
                         test_mode=test_mode, test_cfg=test_cfg, loop=loop)
        self.la = (torch.load(la_file, map_location="cpu", weights_only=False)
                   if la_file else None)

    def get_data_list(self):
        if self.lr_file:
            return [os.path.join(self.data_root, "train", name + ".pth")
                    for name in np.loadtxt(self.lr_file, dtype=str)]
        return super().get_data_list()

    def get_data(self, idx):
        data = load_scene(self.data_list[idx % len(self.data_list)])
        coord = np.asarray(data["coord"], np.float32)
        n = coord.shape[0]
        segment = (np.asarray(data[self.segment_key], np.int64).reshape(-1)
                   if self.segment_key in data else -np.ones(n, np.int64))
        instance = (np.asarray(data["instance_gt"], np.int64).reshape(-1)
                    if "instance_gt" in data else -np.ones(n, np.int64))
        data_dict = dict(
            coord=coord,
            color=np.asarray(data["color"], np.float32),
            normal=np.asarray(data["normal"], np.float32),
            segment=segment,
            instance=instance,
            scene_id=data.get("scene_id", self.get_data_name(idx)),
        )
        if self.la is not None:
            sampled_index = np.asarray(self.la[self.get_data_name(idx)])
            unlabelled = np.ones_like(segment, bool)
            unlabelled[sampled_index] = False
            segment[unlabelled] = self.ignore_index
            data_dict["sampled_index"] = sampled_index
        return data_dict


@DATASETS.register_module()
class ScanNet200Dataset(ScanNetDataset):
    segment_key = "semantic_gt200"
