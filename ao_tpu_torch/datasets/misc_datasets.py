"""Structured3D (port of the Structured3DDataset of
ao_tpu/datasets/misc_datasets.py; reference pointcept/datasets/
structure3d.py). The file's other datasets are not ported yet."""

from __future__ import annotations

import glob
import os

from .builder import DATASETS
from .defaults import DefaultDataset


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
