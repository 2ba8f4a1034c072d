"""Carry PT-v2m1 / PT-v2m2 weights from the JAX package into the port.

``from_jax_variables`` maps the numpy arrays of a flax ``{params,
batch_stats}`` tree of ao_tpu's PT-v2 onto the port's ``state_dict``,
whose names are the reference torch model's. The PT-v2m2 mapping is a copy
of ao_tpu/models/point_transformer_v2/convert.py:flax_to_torch_state_dict
(the port imports nothing of ao_tpu): flax ``Dense.kernel`` is (in, out)
and torch ``Linear.weight`` (out, in), so every kernel transposes; the
GVA's raw pe / weight-encoding parameters map onto its two MLPs. The
legacy (PT-v2m1 / pe-multiplier) attention, which ao_tpu's converter does
not name, maps its flax submodules (``linear_p_multiplier`` and
``linear_p_bias`` MLPs, ``grouped_weight``, the weight encoding's Dense /
PointBatchNorm) onto the reference PT-v2m1's names
(``linear_p_multiplier.{0,1,3}``, ``weight_encoding.0.weight`` the
GroupedLinear's (1, C)). Blocks of a model built with
``enable_checkpoint`` (flax ``CheckpointBlock_j``) map as ``Block_j``.
Given no batch statistics it maps a tree shaped like ``params`` alone,
such as the gradients of ``jax.grad``, onto the port's parameter names.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _get(tree, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, np.float32)


def _has(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return False
        node = node[p]
    return True


class _Writer:
    def __init__(self, params, stats):
        self.params = params
        self.stats = stats
        self.out: Dict[str, np.ndarray] = {}

    def dense(self, fpath, tname, bias=True):
        self.out[tname + ".weight"] = _get(self.params, fpath + ("kernel",)).T
        if bias:
            self.out[tname + ".bias"] = _get(self.params, fpath + ("bias",))

    def bn(self, scale, bias, mean, var, tname):
        """A PointBatchNorm's BatchNorm1d at ``tname``."""
        self.out[tname + ".weight"] = _get(self.params, scale)
        self.out[tname + ".bias"] = _get(self.params, bias)
        if self.stats is None:
            return
        self.out[tname + ".running_mean"] = _get(self.stats, mean)
        self.out[tname + ".running_var"] = _get(self.stats, var)
        self.out[tname + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def pbn(self, fpath, tname):
        self.bn(fpath + ("scale",), fpath + ("bias",), fpath + ("mean",),
                fpath + ("var",), tname + ".norm")

    def raw(self, fpath, tname, transpose=False):
        v = _get(self.params, fpath)
        self.out[tname] = v.T if transpose else v


def _legacy_gva(w: _Writer, t, g):
    """The legacy attention's pe MLPs and weight encoding (ao_tpu
    ptv2m2.py:_legacy_attention, flax auto-names after q / k / v's
    Dense_0-2 and PointBatchNorm_0-1)."""
    for mlp in ("linear_p_multiplier", "linear_p_bias"):
        if _has(w.params, g + (mlp,)):
            w.dense(g + (mlp, "Dense_0"), f"{t}.{mlp}.0")
            w.pbn(g + (mlp, "PointBatchNorm_0"), f"{t}.{mlp}.1")
            w.dense(g + (mlp, "Dense_1"), f"{t}.{mlp}.3")
    last = "Dense_4"
    if _has(w.params, g + ("grouped_weight",)):
        w.raw(g + ("grouped_weight",), f"{t}.weight_encoding.0.weight")
        last = "Dense_3"
    else:
        w.dense(g + ("Dense_3",), f"{t}.weight_encoding.0")
    w.pbn(g + ("PointBatchNorm_2",), f"{t}.weight_encoding.1")
    w.dense(g + (last,), f"{t}.weight_encoding.3")


def _gva(w: _Writer, t, path, qkv_bias=True):
    g = path + ("GroupedVectorAttention_0",)
    w.dense(g + ("Dense_0",), t + ".linear_q.0", qkv_bias)
    w.pbn(g + ("PointBatchNorm_0",), t + ".linear_q.1")
    w.dense(g + ("Dense_1",), t + ".linear_k.0", qkv_bias)
    w.pbn(g + ("PointBatchNorm_1",), t + ".linear_k.1")
    w.dense(g + ("Dense_2",), t + ".linear_v", qkv_bias)
    if not _has(w.params, g + ("pe_w1",)):
        _legacy_gva(w, t, g)
        return
    for mlp, pre in (("linear_p_bias", "pe"), ("weight_encoding", "we")):
        w.raw(g + (f"{pre}_w1",), f"{t}.{mlp}.0.weight", True)
        w.raw(g + (f"{pre}_b1",), f"{t}.{mlp}.0.bias")
        w.bn(g + (f"{pre}_bn_scale",), g + (f"{pre}_bn_bias",),
             g + (f"{pre}_bn_mean",), g + (f"{pre}_bn_var",),
             f"{t}.{mlp}.1.norm")
        w.raw(g + (f"{pre}_w2",), f"{t}.{mlp}.3.weight", True)
        w.raw(g + (f"{pre}_b2",), f"{t}.{mlp}.3.bias")


def _block_name(params, path, j):
    """The flax name of block j: ``Block_j``, or ``CheckpointBlock_j`` in a
    model built with enable_checkpoint (flax's nn.remat); None past the
    last."""
    for name in (f"Block_{j}", f"CheckpointBlock_{j}"):
        if _has(params, path + (name,)):
            return name
    return None


def _block_seq(w: _Writer, t, path, qkv_bias=True):
    j = 0
    while (name := _block_name(w.params, path, j)) is not None:
        b, tb = path + (name,), f"{t}.blocks.{j}"
        w.dense(b + ("Dense_0",), tb + ".fc1", bias=False)
        w.pbn(b + ("PointBatchNorm_0",), tb + ".norm1")
        _gva(w, tb + ".attn", b, qkv_bias)
        w.pbn(b + ("PointBatchNorm_1",), tb + ".norm2")
        w.dense(b + ("Dense_1",), tb + ".fc3", bias=False)
        w.pbn(b + ("PointBatchNorm_2",), tb + ".norm3")
        j += 1
    if j == 0:
        raise KeyError(f"no blocks under flax path {path}")


def from_jax_variables(params, batch_stats=None, qkv_bias: bool = True):
    """Map ao_tpu PT-v2m2 flax ``params`` / ``batch_stats`` (nested dicts of
    arrays) to the port's ``state_dict`` of torch tensors. A DefaultSegmentor
    tree (a ``backbone`` subtree) gives ``backbone.``-prefixed names. With
    ``batch_stats`` None only the parameters are mapped (a gradient tree
    maps this way)."""
    prefix = ""
    if "backbone" in params:
        params = params["backbone"]
        if batch_stats is not None:
            batch_stats = batch_stats.get("backbone", {})
        prefix = "backbone."
    w = _Writer(params, batch_stats)
    w.dense(("Dense_0",), "patch_embed.proj.0", bias=False)
    w.pbn(("PointBatchNorm_0",), "patch_embed.proj.1")
    _block_seq(w, "patch_embed.blocks", ("patch_embed",), qkv_bias)
    i = 0
    while _has(params, (f"enc{i}_pool",)):
        w.dense((f"enc{i}_pool", "Dense_0"), f"enc_stages.{i}.down.fc",
                bias=False)
        w.pbn((f"enc{i}_pool", "PointBatchNorm_0"), f"enc_stages.{i}.down.norm")
        _block_seq(w, f"enc_stages.{i}.blocks", (f"enc{i}_blocks",), qkv_bias)
        w.dense((f"dec{i}_up", "Dense_0"), f"dec_stages.{i}.up.proj.0")
        w.pbn((f"dec{i}_up", "PointBatchNorm_0"), f"dec_stages.{i}.up.proj.1")
        w.dense((f"dec{i}_up", "Dense_1"), f"dec_stages.{i}.up.proj_skip.0")
        w.pbn((f"dec{i}_up", "PointBatchNorm_1"),
              f"dec_stages.{i}.up.proj_skip.1")
        _block_seq(w, f"dec_stages.{i}.blocks", (f"dec{i}_blocks",), qkv_bias)
        i += 1
    if i == 0:
        raise KeyError("no enc stages in flax params")
    if _has(params, ("Dense_1",)):
        w.dense(("Dense_1",), "seg_head.0")
        w.pbn(("PointBatchNorm_1",), "seg_head.1")
        w.dense(("Dense_2",), "seg_head.3")
    return {prefix + k: torch.from_numpy(np.array(v))
            for k, v in w.out.items()}


def load_jax_npz(path: str):
    """Read JAX variables saved as one ``.npz`` whose keys are the
    '/'-joined flax paths (``params/backbone/...``, ``batch_stats/...``)
    and return the port's ``state_dict``."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return from_jax_variables(tree["params"], tree.get("batch_stats", {}))


def load_jax_ckpt(path: str):
    """The port's ``state_dict`` from a JAX package checkpoint (``.ckpt``,
    flax msgpack of a train state's ``params`` and ``batch_stats``), read
    without flax."""
    from ...utils.checkpoint import load_flax_checkpoint

    state, _ = load_flax_checkpoint(path)
    return from_jax_variables(state["params"], state.get("batch_stats", {}))
