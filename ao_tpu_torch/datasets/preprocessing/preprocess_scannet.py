"""ScanNet v2 raw -> scene files (port of
ao_tpu/datasets/preprocessing/preprocess_scannet.py; reference:
pointcept/datasets/preprocessing/scannet/preprocess_scannet.py).

Reads each scan's ``<scene>_vh_clean_2.ply`` (utils/ply.py), its
``.aggregation.json`` / ``_vh_clean_2.0.010000.segs.json`` instance
annotation pair where both exist, and the ``scannetv2-labels.combined.tsv``
raw-label map; writes {coord, color, semantic_gt20, semantic_gt200,
instance_gt} (-1 where unannotated; the class tables of
datasets/scannet_meta.py) as ``<output-root>/<split>/<scene>.npz``. A
scene whose file exists is skipped.

Usage:
    python -m ao_tpu_torch.datasets.preprocessing.preprocess_scannet \
        --dataset-root <scans/> --output-root out \
        --label-tsv scannetv2-labels.combined.tsv [--split train]
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np

from ...utils.ply import read_ply
from ..scannet_meta import VALID_CLASS_IDS_20, VALID_CLASS_IDS_200
from ._pool import pool_map


def read_label_mapping(tsv_path: str, label_from="raw_category",
                       label_to="id"):
    with open(tsv_path) as f:
        return {row[label_from]: int(row[label_to])
                for row in csv.DictReader(f, delimiter="\t")}


def process_scene(scene_dir: str, out_dir: str, label_map: dict,
                  split: str = "train"):
    scene = os.path.basename(scene_dir.rstrip("/"))
    out_path = os.path.join(out_dir, split, f"{scene}.npz")
    if os.path.isfile(out_path):
        return out_path
    vertices = read_ply(os.path.join(scene_dir, f"{scene}_vh_clean_2.ply"))
    coord = np.stack([vertices["x"], vertices["y"], vertices["z"]],
                     axis=1).astype(np.float32)
    color = np.stack([vertices["red"], vertices["green"], vertices["blue"]],
                     axis=1).astype(np.float32)
    n = coord.shape[0]
    semantic20 = -np.ones(n, np.int64)
    semantic200 = -np.ones(n, np.int64)
    instance = -np.ones(n, np.int64)
    agg_path = os.path.join(scene_dir, f"{scene}.aggregation.json")
    segs_path = os.path.join(scene_dir, f"{scene}_vh_clean_2.0.010000.segs.json")
    if os.path.isfile(agg_path) and os.path.isfile(segs_path):
        with open(segs_path) as f:
            seg_indices = np.asarray(json.load(f)["segIndices"], np.int64)
        with open(agg_path) as f:
            groups = json.load(f)["segGroups"]
        id20 = {cid: i for i, cid in enumerate(VALID_CLASS_IDS_20)}
        id200 = {cid: i for i, cid in enumerate(VALID_CLASS_IDS_200)}
        for inst_id, group in enumerate(groups):
            raw = label_map.get(group["label"], 0)
            members = np.isin(seg_indices, group["segments"])
            if raw in id20:
                semantic20[members] = id20[raw]
            if raw in id200:
                semantic200[members] = id200[raw]
            instance[members] = inst_id
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, coord=coord, color=color,
                        semantic_gt20=semantic20, semantic_gt200=semantic200,
                        instance_gt=instance)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-root", required=True, help="scans/ root")
    p.add_argument("--output-root", required=True)
    p.add_argument("--label-tsv", required=True,
                   help="scannetv2-labels.combined.tsv")
    p.add_argument("--split", default="train")
    p.add_argument("--num-workers", type=int, default=8)
    args = p.parse_args(argv)
    label_map = read_label_mapping(args.label_tsv)
    scenes = sorted(glob.glob(os.path.join(args.dataset_root, "scene*")))
    for out in pool_map(process_scene, scenes, args.num_workers,
                        args.output_root, label_map, args.split):
        print(out)


if __name__ == "__main__":
    main()
