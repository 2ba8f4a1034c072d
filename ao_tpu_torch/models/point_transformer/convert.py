"""Carry PT-v1 weights from the JAX package into the port.

:func:`flax_to_torch_state_dict` turns the numpy arrays of ao_tpu's PT-v1
``params`` and ``batch_stats`` trees (of a PointTransformer-Seg / Cls /
PartSeg model, or of a DefaultSegmentor or DefaultClassifier around one,
whose ``backbone`` subtree gives ``backbone.``-prefixed names) into the
port's ``state_dict``. The named flax modules (``enc{s}_down``,
``enc{s}_block{b}``, ``dec{s}_up``, ``dec{s}_block0``) keep their names;
the auto-named ones inside them (``Dense_i``, ``LayerNorm_i``,
``PointBatchNorm_i``) map by their order in the flax module onto the
reference's names (:data:`_LAYER`, :data:`_BOTTLENECK`, ...). A Dense
kernel, (in, out), transposes to a Linear's (out, in) weight; a
PointBatchNorm's ``scale`` / ``bias`` / ``mean`` / ``var`` go to
``<name>.norm.{weight, bias, running_mean, running_var}``, a LayerNorm's
``scale`` / ``bias`` to ``weight`` / ``bias``.
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

# flax child -> port child, per module kind
_LAYER = {"Dense_0": "linear_q", "Dense_1": "linear_k", "Dense_2": "linear_v",
          "Dense_3": "linear_p.0", "LayerNorm_0": "linear_p.1",
          "Dense_4": "linear_p.3", "LayerNorm_1": "linear_w.0",
          "Dense_5": "linear_w.2", "LayerNorm_2": "linear_w.3",
          "Dense_6": "linear_w.5"}
_BOTTLENECK = {"Dense_0": "linear1", "PointBatchNorm_0": "bn1",
               "PointTransformerLayer_0": "transformer", "PointBatchNorm_1": "bn2",
               "Dense_1": "linear3", "PointBatchNorm_2": "bn3"}
_DOWN = {"Dense_0": "linear", "PointBatchNorm_0": "bn"}
_UP = {"Dense_0": "linear_skip", "PointBatchNorm_0": "bn_skip",
       "Dense_1": "linear_up", "PointBatchNorm_1": "bn_up"}
_HEAD_UP = {"Dense_0": "linear_global", "Dense_1": "linear",
            "PointBatchNorm_0": "bn"}
_HEAD_UP_SHAPE = {"Dense_0": "linear_global", "Dense_1": "linear_shape",
                  "Dense_2": "linear", "PointBatchNorm_0": "bn"}
_SEG_HEAD = {"Dense_0": "seg_fc", "PointBatchNorm_0": "seg_bn",
             "Dense_1": "seg_out"}
_CLS_HEAD = {"Dense_0": "head.cls_fc1", "PointBatchNorm_0": "head.cls_bn1",
             "Dense_1": "head.cls_fc2", "PointBatchNorm_1": "head.cls_bn2",
             "Dense_2": "head.cls_out"}


def _children(tree: Mapping, name: str) -> Dict[str, str]:
    """The child map of the flax module ``name`` holding ``tree``."""
    if re.fullmatch(r"enc\d_down", name):
        return _DOWN
    if re.fullmatch(r"(enc\d_block\d+|dec\d_block0)", name):
        return _BOTTLENECK
    if name == "PointTransformerLayer_0":
        return _LAYER
    if name == "dec5_up":
        return _HEAD_UP_SHAPE if "Dense_2" in tree else _HEAD_UP
    if re.fullmatch(r"dec\d_up", name):
        return _UP
    raise KeyError(f"no PT-v1 module named {name!r}")


def _model_children(tree: Mapping) -> Dict[str, str]:
    """The child map of a model's top level: its named stages keep their
    names; the head is the Seg / PartSeg one (one PointBatchNorm) or the
    classifier's (two)."""
    head = _CLS_HEAD if "PointBatchNorm_1" in tree else _SEG_HEAD
    return {k: head.get(k, k) for k in tree}


def _walk(tree: Mapping, children: Dict[str, str], prefix: str, out: dict,
          leaf_kind=None):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            port = children.get(k, k) if children is not None else k
            if k.startswith("Dense_"):
                kind, sub = _DENSE, None
            elif k.startswith("LayerNorm_"):
                kind, sub = _LN, None
            elif k.startswith("PointBatchNorm_"):
                kind, sub = _BN, None
            else:
                kind, sub = None, _children(v, k)
            _walk(v, sub, f"{prefix}{port}.", out, kind)
        else:
            a = np.asarray(v, np.float32)
            if leaf_kind is _DENSE and k == "kernel":
                a = a.T
            out[prefix + leaf_kind[k]] = a


def flax_to_torch_state_dict(params: Mapping,
                             batch_stats: Optional[Mapping] = None
                             ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from numpy arrays of a
    flax PT-v1 ``params`` tree and its ``batch_stats``; with no
    ``batch_stats`` (the gradients of ``jax.grad``, say) only the
    parameters' names."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, batch_stats or {}):
        body, prefix = tree, ""
        if "backbone" in tree:  # a DefaultSegmentor / DefaultClassifier
            body, prefix = tree["backbone"], "backbone."
            rest = {k: v for k, v in tree.items() if k != "backbone"}
            _walk(rest, _CLS_HEAD, "", out)
        _walk(body, _model_children(body), prefix, out)
    if batch_stats is not None:
        for name in [k for k in out if k.endswith(".norm.running_mean")]:
            out[name[:-len("running_mean")] + "num_batches_tracked"] = (
                np.asarray(0, np.int64))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

