"""Carry SpUNet / MinkUNet / SPVCNN weights from the JAX package into the
port.

The port's module names are the flax module names of ao_tpu's models
(``conv_input``, ``down{s}_bn``, ``enc{s}_block{i}.conv1``, ``up{s}_kernel``,
``point_transform{j}`` ...), so the map is mechanical: a submanifold
kernel (3-D) keeps its (K, C_in, C_out) layout; a Dense kernel (2-D,
``final`` and a point transform's ``Dense_0``, here ``linear``) transposes
to a Linear's (out, in) weight; a SparseBN's ``PointBatchNorm_0`` (a point
transform's, here ``bn``) maps ``scale`` / ``bias`` and the batch
statistics ``mean`` / ``var`` onto ``<name>.norm.{weight, bias,
running_mean, running_var}``. A DefaultSegmentor tree (its ``backbone``
subtree) gives ``backbone.``-prefixed names.

The SpUNet task heads' own leaves (:func:`head_state_dict`) map onto the
reference's names: CAC's ``seg_head_weight`` / ``seg_head_bias`` onto
``seg_head``, its ``proj`` / ``apd_proj`` ``Dense_0`` / ``Dense_1`` onto
``.0`` / ``.2``, ``feat_proj_in`` / ``feat_proj_bn`` / ``feat_proj_out``
onto ``feat_proj_layer.0`` / ``.1.norm`` / ``.3``; PointGroup's
``bias_fc1`` / ``bias_bn`` / ``bias_fc2`` onto ``bias_head.0`` /
``.1.norm`` / ``.3`` and ``seg_head``; MSC's ``mask_token``,
``color_head`` and ``normal_head`` keep their names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree, np.float32)


def _port_name(path):
    *mods, leaf = path
    if mods and mods[-1] == "PointBatchNorm_0":
        mods = mods[:-1] + (["bn"] if mods[-2].startswith("point_transform")
                            else [])
        return ".".join(mods + ["norm", _BN_LEAVES[leaf]])
    if mods and mods[-1] == "Dense_0":
        mods[-1] = "linear"
    if leaf == "kernel" and mods and (mods[-1] in ("final", "linear")):
        return ".".join(mods + ["weight"])
    return ".".join(mods + [leaf])


# flax module path of a head -> the port's module name
_HEAD_MODULES = {
    ("proj", "Dense_0"): "proj.0", ("proj", "Dense_1"): "proj.2",
    ("apd_proj", "Dense_0"): "apd_proj.0", ("apd_proj", "Dense_1"): "apd_proj.2",
    ("feat_proj_in",): "feat_proj_layer.0", ("feat_proj_bn",): "feat_proj_layer.1.norm",
    ("feat_proj_out",): "feat_proj_layer.3",
    ("bias_fc1",): "bias_head.0", ("bias_bn",): "bias_head.1.norm",
    ("bias_fc2",): "bias_head.3",
    ("seg_head",): "seg_head", ("color_head",): "color_head",
    ("normal_head",): "normal_head",
}
_HEAD_LEAVES = {"seg_head_weight": "seg_head.weight",
                "seg_head_bias": "seg_head.bias", "mask_token": "mask_token"}
_LEAF = {"kernel": "weight", "bias": "bias", **_BN_LEAVES}


def head_state_dict(variables) -> Dict[str, np.ndarray]:
    """The port's names and arrays of the head leaves (every leaf outside
    ``backbone``) of a flax ``{"params", "batch_stats"}`` tree of ao_tpu's
    CAC, PointGroup or MSC model; a Dense kernel transposes to a Linear's
    weight. Given a params tree alone, its parameters."""
    trees = ([variables["params"], variables.get("batch_stats", {})]
             if "params" in variables else [variables])
    out = {}
    if "backbone" not in trees[0]:
        return out
    for tree in trees:
        for path, v in _leaves({k: t for k, t in tree.items() if k != "backbone"}):
            if path[:-1] in _HEAD_MODULES:
                name = _HEAD_MODULES[path[:-1]] + "." + _LEAF[path[-1]]
                out[name] = v.T if path[-1] == "kernel" else v
                if path[-1] == "mean":
                    out[name[:-len("running_mean")] + "num_batches_tracked"] = (
                        np.asarray(0, np.int64))
            else:
                out[_HEAD_LEAVES[".".join(path)]] = v
    return out


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from the numpy arrays of a
    flax ``{"params", "batch_stats"}`` tree of ao_tpu's SpUNet, MinkUNet or
    SPVCNN (or of a DefaultSegmentor around one). Given a params tree alone
    (no ``"params"`` key: the gradients of ``jax.grad``, say), it maps that
    onto the port's parameter names."""
    params = variables.get("params", variables)
    out = head_state_dict(variables)
    head = bool(out)  # a head beside the backbone: only its subtree maps here
    for path, v in _leaves({"backbone": params["backbone"]} if head else params):
        name = _port_name(path)
        out[name] = v.T if name.endswith(("final.weight", "linear.weight")) else v
    if "params" in variables:
        stats = variables.get("batch_stats", {})
        for path, v in _leaves({"backbone": stats.get("backbone", {})}
                               if head else stats):
            out[_port_name(path)] = v
        for name in [k for k in out if k.endswith(".norm.running_mean")]:
            out[name[:-len("running_mean")] + "num_batches_tracked"] = np.asarray(
                0, np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
