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


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from the numpy arrays of a
    flax ``{"params", "batch_stats"}`` tree of ao_tpu's SpUNet, MinkUNet or
    SPVCNN (or of a DefaultSegmentor around one). Given a params tree alone
    (no ``"params"`` key: the gradients of ``jax.grad``, say), it maps that
    onto the port's parameter names."""
    params = variables.get("params", variables)
    out = {}
    for path, v in _leaves(params):
        name = _port_name(path)
        out[name] = v.T if name.endswith(("final.weight", "linear.weight")) else v
    if "params" in variables:
        for path, v in _leaves(variables.get("batch_stats", {})):
            out[_port_name(path)] = v
        for name in [k for k in out if k.endswith(".norm.running_mean")]:
            out[name[:-len("running_mean")] + "num_batches_tracked"] = np.asarray(
                0, np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
