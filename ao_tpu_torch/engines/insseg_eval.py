"""Instance segmentation AP evaluation, ScanNet benchmark protocol (a copy
of ao_tpu/engines/insseg_eval.py, numpy only; reference:
pointcept/engines/hooks/evaluator.py:204-581).

Per class and IoU-overlap threshold, confidence-ranked predicted masks are
matched greedily to ground-truth instances; duplicate matches and
unmatched predictions count as false positives (less the predictions that
mostly cover void or ignored regions), and a step-interpolated
precision-recall curve is integrated. Reports AP (mean over
0.50:0.95:0.05), AP@50 and AP@25.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


def associate_instances(
    pred: Dict[str, np.ndarray],
    segment: np.ndarray,
    instance: np.ndarray,
    num_classes: int,
    class_names: Sequence[str],
    segment_ignore_index=(-1,),
    instance_ignore_index=-1,
    min_region_size: int = 100,
):
    """Build per-class GT/pred instance records with mutual intersections
    for one scene."""
    segment = np.asarray(segment).reshape(-1)
    instance = np.asarray(instance).reshape(-1)
    void_mask = np.isin(segment, segment_ignore_index)
    valid_names = [
        class_names[i] for i in range(num_classes)
        if i not in segment_ignore_index
    ]

    gt_instances = {name: [] for name in valid_names}
    ids, first, counts = np.unique(
        instance, return_index=True, return_counts=True
    )
    seg_of = segment[first]
    for i in range(len(ids)):
        if ids[i] == instance_ignore_index:
            continue
        if seg_of[i] in segment_ignore_index or seg_of[i] >= num_classes:
            continue
        gt_instances[class_names[seg_of[i]]].append(
            dict(
                instance_id=int(ids[i]),
                segment_id=int(seg_of[i]),
                vert_count=int(counts[i]),
                matched_pred=[],
            )
        )

    pred_instances = {name: [] for name in valid_names}
    uid = 0
    for i in range(len(pred["pred_classes"])):
        cls = int(pred["pred_classes"][i])
        if cls in segment_ignore_index or cls >= num_classes:
            continue
        mask = np.not_equal(pred["pred_masks"][i], 0)
        vert_count = int(np.count_nonzero(mask))
        if vert_count < min_region_size:
            continue
        p = dict(
            uid=uid,
            segment_id=cls,
            confidence=float(pred["pred_scores"][i]),
            vert_count=vert_count,
            void_intersection=int(np.count_nonzero(void_mask & mask)),
            matched_gt=[],
        )
        uid += 1
        name = class_names[cls]
        # intersections with same-class GT instances
        for gt in gt_instances[name]:
            inter = int(
                np.count_nonzero(mask & (instance == gt["instance_id"]))
            )
            if inter > 0:
                gt_copy = dict(gt, intersection=inter)
                pred_copy = dict(
                    {k: v for k, v in p.items() if k != "matched_gt"},
                    intersection=inter,
                )
                gt["matched_pred"].append(pred_copy)
                p["matched_gt"].append(gt_copy)
        pred_instances[name].append(p)
    return gt_instances, pred_instances


def _pr_curve_ap(y_true, y_score, hard_false_negatives) -> float:
    """Step-interpolated AP from binary match labels + confidences (the
    ScanNet benchmark integration: ascending unique score thresholds, each
    counting the examples at or above it)."""
    y_true = np.asarray(y_true, float)
    y_score = np.asarray(y_score, float)
    order = np.argsort(y_score)  # ascending
    y_true = y_true[order]
    y_score = y_score[order]
    cumsum = np.cumsum(y_true)
    num_examples = len(y_score)
    num_true = cumsum[-1] if num_examples else 0
    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n = len(unique_idx) + 1
    precision = np.zeros(n)
    recall = np.zeros(n)
    for i, idx in enumerate(unique_idx):
        below = cumsum[idx - 1] if idx > 0 else 0
        tp = num_true - below
        fp = num_examples - idx - tp
        fn = below + hard_false_negatives
        precision[i] = tp / max(tp + fp, 1e-12)
        recall[i] = tp / max(tp + fn, 1e-12)
    precision[-1] = 1.0
    recall[-1] = 0.0
    recall_pad = np.concatenate([[recall[0]], recall, [0.0]])
    widths = np.convolve(recall_pad, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, widths))


def evaluate_matches(
    scenes: List[dict],
    class_names: Sequence[str],
    overlaps: np.ndarray = OVERLAPS,
    min_region_size: int = 100,
) -> np.ndarray:
    """(num_classes, num_overlaps) AP table; NaN where a class has neither
    GT nor predictions."""
    ap = np.full((len(class_names), len(overlaps)), np.nan)
    for li, name in enumerate(class_names):
        for oi, th in enumerate(overlaps):
            y_true, y_score = [], []
            hard_fn = 0
            has_gt = has_pred = False
            visited = set()
            for scene in scenes:
                gts = [
                    g for g in scene["gt"][name]
                    if g["vert_count"] >= min_region_size
                ]
                preds = scene["pred"][name]
                has_gt |= len(gts) > 0
                has_pred |= len(preds) > 0
                scene_tag = id(scene)
                matched = [False] * len(gts)
                scores = [0.0] * len(gts)
                for gi, gt in enumerate(gts):
                    found = False
                    for p in gt["matched_pred"]:
                        key = (scene_tag, p["uid"])
                        if key in visited:
                            continue
                        overlap = p["intersection"] / (
                            gt["vert_count"] + p["vert_count"]
                            - p["intersection"]
                        )
                        if overlap > th:
                            if matched[gi]:
                                # duplicate match: worse-scored one is a FP
                                mx = max(scores[gi], p["confidence"])
                                mn = min(scores[gi], p["confidence"])
                                scores[gi] = mx
                                y_true.append(0)
                                y_score.append(mn)
                            else:
                                matched[gi] = True
                                found = True
                                scores[gi] = p["confidence"]
                                visited.add(key)
                    if not found:
                        hard_fn += 1
                for gi in range(len(gts)):
                    if matched[gi]:
                        y_true.append(1)
                        y_score.append(scores[gi])
                for p in preds:
                    found_gt = False
                    for g in p["matched_gt"]:
                        overlap = g["intersection"] / (
                            g["vert_count"] + p["vert_count"]
                            - g["intersection"]
                        )
                        if overlap > th and g["vert_count"] >= min_region_size:
                            found_gt = True
                            break
                    if not found_gt:
                        # ignore predictions mostly covering void / tiny GT
                        num_ignore = p["void_intersection"]
                        for g in p["matched_gt"]:
                            if g["vert_count"] < min_region_size:
                                num_ignore += g["intersection"]
                        if num_ignore / p["vert_count"] <= th:
                            y_true.append(0)
                            y_score.append(p["confidence"])
            if has_gt and has_pred:
                ap[li, oi] = _pr_curve_ap(y_true, y_score, hard_fn)
            elif has_gt:
                ap[li, oi] = 0.0
    return ap


def ap_scores(ap_table: np.ndarray, class_names: Sequence[str]) -> dict:
    o50 = np.isclose(OVERLAPS, 0.5)
    o25 = np.isclose(OVERLAPS, 0.25)
    main = ~o25
    out = dict(
        all_ap=float(np.nanmean(ap_table[:, main])),
        all_ap_50=float(np.nanmean(ap_table[:, o50])),
        all_ap_25=float(np.nanmean(ap_table[:, o25])),
        classes={},
    )
    for li, name in enumerate(class_names):
        out["classes"][name] = dict(
            ap=float(np.nanmean(ap_table[li, main])),
            ap50=float(np.nanmean(ap_table[li, o50])),
            ap25=float(np.nanmean(ap_table[li, o25])),
        )
    return out
