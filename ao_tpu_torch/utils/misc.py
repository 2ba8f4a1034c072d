"""Metric helpers (port of ao_tpu/utils/misc.py, host-side numpy)."""

from __future__ import annotations

import numpy as np


def intersection_and_union(output, target, K, ignore_index=-1, get_output=False):
    """Per-class intersection / union / target histograms of two int arrays
    of the same shape (reference: pointcept/utils/misc.py:38-71)."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1)
    output[np.where(target == ignore_index)[0]] = ignore_index
    intersection = output[np.where(output == target)[0]]
    area_intersection, _ = np.histogram(intersection, bins=np.arange(K + 1))
    area_output, _ = np.histogram(output, bins=np.arange(K + 1))
    area_target, _ = np.histogram(target, bins=np.arange(K + 1))
    area_union = area_output + area_target - area_intersection
    if get_output:
        return area_intersection, area_union, area_target, area_output
    return area_intersection, area_union, area_target
