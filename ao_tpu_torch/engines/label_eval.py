"""Pseudo-label quality evaluation (a copy of ao_tpu/engines/label_eval.py;
reference: pointcept/engines/my_evaluate.py:17-64).

Scores on-disk ``.npy`` pseudo-label dirs against GT scenes:
per-class IoU / precision / recall, used by the REAL loop to track
``sam_label/*`` curves per epoch. Note: the reference hardcodes
``area_paths`` to Area_1 only (my_evaluate.py:16), so its curves measure
Area_1 label quality; here the areas are an argument (default = the train
areas) with the reference behaviour available via ``areas=("Area_1",)``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from ..datasets.defaults import load_scene
from ..utils.misc import intersection_and_union

TRAIN_AREAS = ("Area_1", "Area_2", "Area_3", "Area_4", "Area_6")


def get_miou(
    pred_root: str,
    data_root: str = "data/s3dis",
    num_classes: int = 13,
    ignore_index: int = -1,
    areas: Sequence[str] = TRAIN_AREAS,
) -> Dict[str, float]:
    """mIoU/mPrecision/mRecall of <pred_root>/<area>/<room>.npy labels vs GT."""
    inter_sum = np.zeros(num_classes)
    union_sum = np.zeros(num_classes)
    target_sum = np.zeros(num_classes)
    output_sum = np.zeros(num_classes)
    n_scenes = 0
    for area in areas:
        for scene_path in sorted(glob.glob(os.path.join(data_root, area, "*.pth"))) \
                + sorted(glob.glob(os.path.join(data_root, area, "*.npz"))):
            room = os.path.splitext(os.path.basename(scene_path))[0]
            label_path = os.path.join(pred_root, area, room + ".npy")
            if not os.path.isfile(label_path):
                continue
            gt = np.asarray(
                load_scene(scene_path)["semantic_gt"], np.int64
            ).reshape(-1)
            pred = np.load(label_path).reshape(-1).astype(np.int64)
            inter, union, target, output = intersection_and_union(
                pred, gt, num_classes, ignore_index, get_output=True
            )
            inter_sum += inter
            union_sum += union
            target_sum += target
            output_sum += output
            n_scenes += 1
    iou = inter_sum / (union_sum + 1e-10)
    precision = inter_sum / (output_sum + 1e-10)
    recall = inter_sum / (target_sum + 1e-10)
    return dict(
        mIoU=float(np.mean(iou)),
        mPrecision=float(np.mean(precision)),
        mRecall=float(np.mean(recall)),
        num_scenes=n_scenes,
    )


def get_miou_from_arrays(
    preds: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    num_classes: int,
    ignore_index: int = -1,
) -> Dict[str, float]:
    """Same metrics over in-memory {scene: labels} dicts (REAL in-loop)."""
    inter_sum = np.zeros(num_classes)
    union_sum = np.zeros(num_classes)
    target_sum = np.zeros(num_classes)
    output_sum = np.zeros(num_classes)
    for name, pred in preds.items():
        gt = gts[name]
        inter, union, target, output = intersection_and_union(
            pred, gt, num_classes, ignore_index, get_output=True
        )
        inter_sum += inter
        union_sum += union
        target_sum += target
        output_sum += output
    return dict(
        mIoU=float(np.mean(inter_sum / (union_sum + 1e-10))),
        mPrecision=float(np.mean(inter_sum / (output_sum + 1e-10))),
        mRecall=float(np.mean(inter_sum / (target_sum + 1e-10))),
    )
