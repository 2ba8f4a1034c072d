"""Metric helpers (port of ao_tpu/utils/misc.py): histograms of
predictions against labels, in numpy on the host or in torch on the
tensors' device."""

from __future__ import annotations

import numpy as np
import torch


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


def intersection_and_union_torch(output, target, K, ignore_index=-1):
    """Per-class intersection / union / target histograms (int64 tensors of
    shape (K,)) of two int tensors of the same shape, on their device
    (port of ao_tpu's intersection_and_union_jax): points whose target is
    ``ignore_index`` count nowhere."""
    output = output.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    output, target = output[valid], target[valid]
    inter = torch.bincount(output[output == target], minlength=K)[:K]
    area_out = torch.bincount(output, minlength=K)[:K]
    area_tgt = torch.bincount(target, minlength=K)[:K]
    return inter, area_out + area_tgt - inter, area_tgt


def make_divisible(x: int, divisor: int) -> int:
    """The least multiple of ``divisor`` that is at least ``x``."""
    return int(np.ceil(x / divisor) * divisor)
