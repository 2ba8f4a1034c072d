"""Carry OctFormer weights from the JAX package into the port.

:func:`flax_to_torch_state_dict` turns the numpy arrays of ao_tpu's
OctFormer-v1m1 ``params`` tree (of the backbone, or of a DefaultSegmentor
around it) into the port's ``state_dict``. The named flax modules keep
their names (``embed``, ``stage{s}_block{d}`` with ``cpe_kernel`` and
``attn`` (``qkv``, ``proj``, ``rpe_table``), ``down{s}``, ``up{s}``,
``up{s}_skip``); the auto-named ones map onto the port's: the
classifier's ``LayerNorm_0`` / ``Dense_0`` to ``seg_norm`` / ``seg_out``,
a block's ``LayerNorm_0`` / ``LayerNorm_1`` to ``norm1`` / ``norm2`` and
its MLP's ``Dense_0`` / ``Dense_1`` to ``mlp.0`` / ``mlp.2``. Dense
kernels transpose, as for the Stratified Transformer.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..stratified_transformer.convert import BLOCK, convert

TOP = {"LayerNorm_0": "seg_norm", "Dense_0": "seg_out"}


def flax_to_torch_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (torch tensors) from numpy arrays of a flax
    OctFormer ``params`` tree (or its gradients)."""
    return convert(params, TOP, BLOCK)
