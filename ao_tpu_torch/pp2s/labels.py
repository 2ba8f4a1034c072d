"""PP2S stages 3-5: weak labels, baskets, and SAM pseudo-labels (a copy of
ao_tpu/pp2s/labels.py, numpy only).

Reference semantics:
* weak labels (my_choose_weak_label_final.py:74-88): exactly one labelled
  point per GT instance — the middle (len//2) of its *viewable* points if
  any bridge sees the instance, else the middle of all its points.
* basket (my_make_basket_final.py:39-47): per-train-scene (N, C) float
  array filled with -100, the REAL loop's logit accumulator.
* SAM labels (my_run_sam_final.py:73-122): for every weak point visible in
  a frame, prompt SAM at its pixel; paint the point's GT class onto all
  bridge-visible points inside the returned mask; majority-vote per point;
  points voted by more than one class are dropped (-1); weak points are
  forced to their GT class. Prompts here are *batched per frame* through
  the predictor instead of the reference's one-prompt-per-call loop.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Optional

import numpy as np


def choose_weak_labels(
    instance: np.ndarray,  # (N,) GT instance ids
    viewable: np.ndarray,  # (N,) 0/1 union of bridge visibility
    points_per_instance: int = 1,
) -> np.ndarray:
    """(N,) 0/1 mask of weak-labelled points.

    ``points_per_instance=1`` is the release "0.004" setting (the
    viewable-midpoint of each instance, reference
    my_choose_weak_label_final.py:74-88); larger values give the denser
    "0.02" setting (k evenly spaced quantile points per instance,
    reference my_choose_weak_label_0.02.py:72-97).
    """
    n = instance.shape[0]
    weak = np.zeros(n, np.int64)
    viewable = viewable.astype(bool)
    all_idx = np.arange(n)
    k = points_per_instance

    def pick(members):
        if members.size == 0:
            return
        if k == 1:
            weak[members[len(members) // 2]] = 1
        else:
            step = max(members.size // (k + 1), 1)
            sel = members[
                np.minimum((np.arange(k) + 1) * step, members.size - 1)
            ]
            weak[sel] = 1

    viewable_instances = set(np.unique(instance[viewable]).tolist())
    for iid in viewable_instances:
        pick(all_idx[viewable & (instance == iid)])
    for iid in np.unique(instance):
        if iid not in viewable_instances:
            pick(np.where(instance == iid)[0])
    return weak


def make_basket(
    scene_sizes: Dict[str, int], num_classes: int = 13
) -> Dict[str, np.ndarray]:
    """{scene: (N, C) -100 float32} logit basket."""
    return {
        name: np.full((n, num_classes), -100.0, np.float32)
        for name, n in scene_sizes.items()
    }


def save_basket(basket: Dict[str, np.ndarray], path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(basket, f)


def load_basket(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)


class MaskVote:
    """Per-point class-vote accumulator with the reference's conflict-drop
    rule (my_run_sam_final.py:101-114): a point's label is the plurality
    class of its votes, but any point voted by >1 distinct class is -1."""

    def __init__(self, n_points: int, num_classes: int):
        self.votes = np.zeros((n_points, num_classes), np.int32)
        self.num_classes = num_classes

    def add(self, point_idx: np.ndarray, label: int):
        np.add.at(self.votes, (point_idx, label), 1)

    def result(self) -> np.ndarray:
        total = self.votes.sum(1)
        n_classes_voted = (self.votes > 0).sum(1)
        out = np.where(total > 0, self.votes.argmax(1), -1)
        out = np.where(n_classes_voted > 1, -1, out)
        return out.astype(np.int32)


def run_sam_labels_for_scene(
    predictor,  # models.sam.SamPredictor or OracleSamPredictor
    coord: np.ndarray,  # (N, 3)
    segment_gt: np.ndarray,  # (N,) GT labels (weak supervision source)
    weak_mask: np.ndarray,  # (N,) 0/1 weak point mask
    bridges: Dict[str, np.ndarray],  # frame -> (N, 3) [u, v, visible]
    embeddings: Dict[str, np.ndarray],  # frame -> cached SAM features
    frame_size,  # (H, W) of the RGB frames
    num_classes: int = 13,
    max_prompts_per_frame: int = 64,
) -> np.ndarray:
    """Dense (N,) SAM pseudo-labels for one scene."""
    n = coord.shape[0]
    weak_idx = np.where((weak_mask == 1) & (segment_gt != -1))[0]
    vote = MaskVote(n, num_classes)

    for frame, bridge in bridges.items():
        if frame not in embeddings:
            continue
        visible = bridge[:, 2] == 1
        vis_idx = np.where(visible)[0]
        if vis_idx.size == 0:
            continue
        prompts = weak_idx[visible[weak_idx]]
        if prompts.size == 0:
            continue
        predictor.set_features(embeddings[frame], frame_size)
        # batch prompts through the decoder (chunked to bound memory)
        for s in range(0, prompts.size, max_prompts_per_frame):
            chunk = prompts[s : s + max_prompts_per_frame]
            pts = bridge[chunk, :2].astype(np.float32)[:, None, :]  # (P,1,2)
            lbls = np.ones((chunk.size, 1), np.int32)
            masks, scores, _ = predictor.predict(pts, lbls, multimask_output=True)
            # reference uses mask 0 of the multimask output (mask_num = 0)
            mask0 = masks[:, 0]  # (P, H, W)
            u = bridge[vis_idx, 0].astype(np.int64) - 1
            v = bridge[vis_idx, 1].astype(np.int64) - 1
            for pi, point in enumerate(chunk):
                inside = mask0[pi, v, u]
                cls = int(segment_gt[point])
                vote.add(vis_idx[inside], cls)

    labels = vote.result()
    # weak points are always their GT class (my_run_sam_final.py:117-122)
    labels[weak_idx] = segment_gt[weak_idx].astype(np.int32)
    return labels
