"""Ragged-to-padded batch collation (port of ao_tpu/datasets/collate.py).

Samples are padded to a capacity rounded up to ``pad_multiple`` and
stacked into ``(B, N_max, ...)`` CPU tensors with a bool ``mask``;
``segment`` and ``instance`` pad with the ignore label. The caller moves
the batch to its device. ``point_collate_fn`` adds Mix3D: with probability
``mix_prob`` consecutive sample pairs merge into one scene.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

# per-point keys that are padded and stacked
PAD_KEYS = {
    "coord": np.float32,
    "discrete_coord": np.int32,
    "feat": np.float32,
    "color": np.float32,
    "normal": np.float32,
    "strength": np.float32,
    "segment": np.int32,
    "instance": np.int32,
    "instance_center": np.float32,
    "displacement": np.float32,
}
# per-sample keys stacked without padding
STACK_KEYS = {"category": np.int32}
IGNORE_LABEL_KEYS = ("segment", "instance")


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_to(arr: np.ndarray, n: int, fill=0):
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def collate_fn(
    batch: List[Dict],
    pad_multiple: int = 1024,
    max_points: Optional[int] = None,
    ignore_index: int = -1,
) -> Dict[str, torch.Tensor]:
    """Pad and stack a list of sample dicts into CPU tensors plus ``mask``;
    keys that are not per-point arrays are returned under ``extras``."""
    if not batch:
        raise ValueError("collate_fn needs at least one sample")
    counts = [b["coord"].shape[0] for b in batch]
    n_max = _ceil_to(max(counts), pad_multiple)
    if max_points is not None:
        n_max = min(n_max, max_points)

    mask = np.zeros((len(batch), n_max), bool)
    for i, c in enumerate(counts):
        mask[i, : min(c, n_max)] = True
    out = {"mask": torch.from_numpy(mask)}
    extras: Dict[str, list] = {}
    for k in batch[0].keys():
        if k in PAD_KEYS:
            fill = ignore_index if k in IGNORE_LABEL_KEYS else 0
            out[k] = torch.from_numpy(np.stack([
                pad_to(np.asarray(b[k], PAD_KEYS[k])[:n_max], n_max, fill)
                for b in batch
            ]))
        elif k in STACK_KEYS:
            out[k] = torch.from_numpy(np.stack(
                [np.asarray(b[k], STACK_KEYS[k]).reshape(()) for b in batch]
            ))
        elif k != "offset":  # offsets are superseded by mask
            extras[k] = [b[k] for b in batch]
    if extras:
        out["extras"] = extras
    return out


def point_collate_fn(
    batch: List[Dict],
    mix_prob: float = 0.0,
    pad_multiple: int = 1024,
    max_points: Optional[int] = None,
    ignore_index: int = -1,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Collate with Mix3D (port of ao_tpu/datasets/collate.py:
    point_collate_fn): for a batch of even length, with probability
    ``mix_prob`` every pair (2i, 2i + 1) is concatenated along the point
    axis (the per-point arrays of ``PAD_KEYS``; other keys keep the first
    sample's) before :func:`collate_fn`, which then truncates each merged
    scene to ``max_points``. The draw is one uniform number from
    ``generator`` (the default generator when None), taken only when
    ``mix_prob > 0`` and the length is even."""
    if (mix_prob > 0 and len(batch) % 2 == 0
            and float(torch.rand((), generator=generator)) < mix_prob):
        merged = []
        for a, b in zip(batch[0::2], batch[1::2]):
            merged.append({k: (np.concatenate([a[k], b[k]], axis=0)
                               if isinstance(a[k], np.ndarray) and k in PAD_KEYS
                               else a[k]) for k in a})
        batch = merged
    return collate_fn(batch, pad_multiple, max_points, ignore_index)
