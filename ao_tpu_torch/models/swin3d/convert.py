"""Carry Swin3D weights from the JAX package into the port.

:func:`flax_to_torch_state_dict` turns the numpy arrays of ao_tpu's
Swin3D-v1m1 ``params`` and ``batch_stats`` trees (of the backbone, or of a
DefaultSegmentor around it, whose ``backbone`` subtree gives
``backbone.``-prefixed names) into the port's ``state_dict``. The named
flax modules keep their names; the auto-named ones map onto the port's:
a block's MLP ``Dense_0`` / ``Dense_1`` to ``mlp.0`` / ``mlp.2``, the
classifier's ``Dense_0`` / ``PointBatchNorm_0`` / ``Dense_1`` to
``seg_fc`` / ``seg_bn`` / ``seg_out``. A Dense kernel, (in, out),
transposes to a Linear's (out, in) weight; a PointBatchNorm's ``scale`` /
``bias`` / ``mean`` / ``var`` go to ``<name>.norm.{weight, bias,
running_mean, running_var}``, a LayerNorm's ``scale`` / ``bias`` to
``weight`` / ``bias``; the stem's kernel (27, C_in, C_out) and the cRSE
tables (3, L, H, D) keep their shapes and names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_BN = {"scale": "norm.weight", "bias": "norm.bias", "mean": "norm.running_mean",
       "var": "norm.running_var"}
_DENSE = {"kernel": "weight", "bias": "bias"}
_LN = {"scale": "weight", "bias": "bias"}

_BLOCK = {"Dense_0": "mlp.0", "Dense_1": "mlp.2"}
_HEAD = {"Dense_0": "seg_fc", "PointBatchNorm_0": "seg_bn", "Dense_1": "seg_out"}


def _kind(name: str):
    """The leaf map of the flax module ``name``, or None for a container."""
    if name in ("stem_bn",) or name.startswith("PointBatchNorm_"):
        return _BN
    if re.fullmatch(r"(norm\d|(down|up)\d+_norm\d?)", name):
        return _LN
    if name in ("qkv", "proj") or name.startswith("Dense_") or re.fullmatch(
            r"(down|up)\d+_linear\d?", name):
        return _DENSE
    return None


def _walk(tree: Mapping, names: Dict[str, str], prefix: str, out: dict,
          leaf_kind=None):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            kind = _kind(k)
            sub = _BLOCK if re.fullmatch(r"stage\d+_block\d+", k) else {}
            _walk(v, sub, f"{prefix}{names.get(k, k)}.", out, kind)
        else:
            a = np.asarray(v, np.float32)
            if leaf_kind is None:  # the stem's kernel, the cRSE tables
                out[prefix + k] = a
            else:
                out[prefix + leaf_kind[k]] = a.T if (
                    leaf_kind is _DENSE and k == "kernel") else a


def flax_to_torch_state_dict(params: Mapping,
                             batch_stats: Optional[Mapping] = None
                             ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from numpy arrays of a
    flax Swin3D ``params`` tree and its ``batch_stats``; with no
    ``batch_stats`` (the gradients of ``jax.grad``, say) only the
    parameters' names."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats or {}):
        body, prefix = tree, ""
        if "backbone" in tree:  # a DefaultSegmentor
            body, prefix = tree["backbone"], "backbone."
        _walk(body, _HEAD, prefix, out)
    if batch_stats is not None:
        for name in [k for k in out if k.endswith(".norm.running_mean")]:
            out[name[:-len("running_mean")] + "num_batches_tracked"] = (
                np.asarray(0, np.int64))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
