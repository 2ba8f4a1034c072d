"""Checkpoints (port of ao_tpu/utils/checkpoint.py): a dict of model,
optimizer and scheduler ``state_dict``s plus counters, written to
``<path>.tmp`` and atomically renamed."""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)
