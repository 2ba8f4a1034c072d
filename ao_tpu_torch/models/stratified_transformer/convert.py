"""Carry Stratified Transformer weights from the JAX package into the port.

:func:`flax_to_torch_state_dict` turns the numpy arrays of ao_tpu's
ST-v1m1 / ST-v1m2 ``params`` tree (of the backbone, or of a
DefaultSegmentor around it, whose ``backbone`` subtree gives
``backbone.``-prefixed names) into the port's ``state_dict``. The named
flax modules keep their names; the auto-named ones map onto the port's:
the embedding's ``LayerNorm_0`` to ``embed_norm``, the classifier's
``Dense_0`` / ``LayerNorm_1`` / ``Dense_1`` to ``seg_fc`` / ``seg_norm`` /
``seg_out``, a block's ``LayerNorm_0`` / ``LayerNorm_1`` to ``norm1`` /
``norm2`` and its MLP's ``Dense_0`` / ``Dense_1`` to ``mlp.0`` /
``mlp.2``. A Dense kernel, (in, out), transposes to a Linear's (out, in)
weight, a LayerNorm's ``scale`` goes to ``weight``; the KPConv kernel and
the position tables keep their shapes and names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

TOP = {"LayerNorm_0": "embed_norm", "Dense_0": "seg_fc",
       "LayerNorm_1": "seg_norm", "Dense_1": "seg_out"}
BLOCK = {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2", "Dense_0": "mlp.0",
         "Dense_1": "mlp.2"}


def _walk(tree: Mapping, names: Mapping[str, str], block: Mapping[str, str],
          prefix: str, out: dict):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            sub = block if re.fullmatch(r"stage\d+_block\d+", k) else {}
            _walk(v, sub, block, f"{prefix}{names.get(k, k)}.", out)
            continue
        a = np.asarray(v, np.float32)
        if k == "kernel" and a.ndim == 2:  # a Dense
            out[prefix + "weight"] = a.T
        else:
            out[prefix + ("weight" if k == "scale" else k)] = a


def convert(params: Mapping, top: Mapping[str, str], block: Mapping[str, str]
            ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a flax ``params`` tree whose auto-named modules
    at the top level are renamed by ``top`` and inside a
    ``stage{s}_block{d}`` by ``block``."""
    out: Dict[str, np.ndarray] = {}
    body, prefix = params, ""
    if "backbone" in params:  # a DefaultSegmentor
        body, prefix = params["backbone"], "backbone."
    _walk(body, top, block, prefix, out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def flax_to_torch_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from numpy arrays of a flax
    Stratified Transformer ``params`` tree (or its gradients)."""
    return convert(params, TOP, BLOCK)
