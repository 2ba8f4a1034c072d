"""SAM checkpoints into the port's parameter names (port of
ao_tpu/models/sam/convert.py).

The port's ``SamModel`` uses the official ``segment_anything`` names, so an
original checkpoint (``sam_vit_h_4b8939.pth`` etc.) loads as it is.
``load_sam_checkpoint`` also reads HuggingFace ``SamModel`` state dicts
(facebook/sam-vit-*), renaming their keys.

``flax_to_torch_state_dict`` carries ao_tpu's flax SAM parameters (numpy
arrays) into the port: the inverse of ao_tpu's
``convert_original_checkpoint``. Layout rules: flax Dense kernel (in, out)
-> Linear weight (out, in); flax Conv kernel (kh, kw, in, out) -> Conv2d
(out, in, kh, kw); flax ConvTranspose kernel (kh, kw, in, out) ->
ConvTranspose2d (in, out, kh, kw); LayerNorm scale -> weight. The flax
model holds the image-wide and the prompt positional Gaussians as two
parameters; the official model has one, so they must be equal.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_NECK = {"conv1": "0", "layer_norm1": "1", "conv2": "2", "layer_norm2": "3"}
_MASK_DOWN = {"conv1": "0", "layer_norm1": "1", "conv2": "3",
              "layer_norm2": "4", "conv3": "6"}
_UPSCALE = {"upscale_conv1": "0", "upscale_layer_norm": "1",
            "upscale_conv2": "3"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(kind: str, name: str, v: np.ndarray):
    """(official leaf name, array) of one flax leaf of a layer of ``kind``
    ("dense", "conv", "conv_t", "ln")."""
    if name == "bias":
        return "bias", v
    if kind == "ln":
        return "weight", v  # scale
    if kind == "dense":
        return "weight", v.T
    if kind == "conv":
        return "weight", np.transpose(v, (3, 2, 0, 1))
    return "weight", np.transpose(v, (2, 3, 0, 1))  # conv_t


def _ff(name: str, depth: int) -> str:
    """flax FeedForward layer name -> the official MLP's ``layers.i``."""
    if name == "proj_in":
        return "layers.0"
    if name == "proj_out":
        return f"layers.{depth - 1}"
    return f"layers.{int(name.split('_')[1]) + 1}"


def flax_to_torch_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """ao_tpu flax SAM params ({"params": ...} or the bare tree) -> the
    port's ``state_dict`` (official names)."""
    params = params.get("params", params)

    def depth(mlp):  # proj_in, layers_0 .. layers_{d-3}, proj_out
        return 2 + sum(k.startswith("layers_") for k in params["mask_decoder"][mlp])

    sd: Dict[str, np.ndarray] = {}
    pe = {}
    for path, v in _flat(params):
        top, rest = path[0], path[1:]
        if rest and rest[-1] == "positional_embedding":
            pe[path] = v
            continue
        if top == "vision_encoder":
            if rest[0] == "patch_embed":
                k, a = _leaf("conv", rest[1], v)
                sd[f"image_encoder.patch_embed.proj.{k}"] = a
            elif rest[0] == "pos_embed":
                sd["image_encoder.pos_embed"] = v
            elif rest[0] == "neck":
                kind = "conv" if rest[1].startswith("conv") else "ln"
                k, a = _leaf(kind, rest[2], v)
                sd[f"image_encoder.neck.{_NECK[rest[1]]}.{k}"] = a
            else:  # layers_i
                base = f"image_encoder.blocks.{rest[0].split('_')[1]}"
                if rest[1] in ("layer_norm1", "layer_norm2"):
                    k, a = _leaf("ln", rest[2], v)
                    sd[f"{base}.norm{rest[1][-1]}.{k}"] = a
                elif rest[1] == "attn" and rest[2] in ("rel_pos_h", "rel_pos_w"):
                    sd[f"{base}.attn.{rest[2]}"] = v
                else:  # attn.{qkv,proj}, mlp.{lin1,lin2}
                    k, a = _leaf("dense", rest[3], v)
                    sd[f"{base}.{rest[1]}.{rest[2]}.{k}"] = a
        elif top == "prompt_encoder":
            if rest[0] == "mask_embed":
                kind = "conv" if rest[1].startswith("conv") else "ln"
                k, a = _leaf(kind, rest[2], v)
                sd[f"prompt_encoder.mask_downscaling.{_MASK_DOWN[rest[1]]}.{k}"] = a
            elif rest[0].startswith("point_embed_"):
                sd[f"prompt_encoder.point_embeddings.{rest[0].split('_')[-1]}.weight"] = v
            else:  # no_mask_embed, not_a_point_embed
                sd[f"prompt_encoder.{rest[0]}.weight"] = v
        elif top == "mask_decoder":
            if rest[0] in ("iou_token", "mask_tokens"):
                sd[f"mask_decoder.{rest[0]}.weight"] = v
            elif rest[0] == "transformer":
                base = "mask_decoder.transformer"
                if rest[1] == "layer_norm_final_attn":
                    k, a = _leaf("ln", rest[2], v)
                    sd[f"{base}.norm_final_attn.{k}"] = a
                elif rest[1] == "final_attn_token_to_image":
                    k, a = _leaf("dense", rest[3], v)
                    sd[f"{base}.final_attn_token_to_image.{rest[2]}.{k}"] = a
                else:  # layers_i
                    lb = f"{base}.layers.{rest[1].split('_')[1]}"
                    if rest[2].startswith("layer_norm"):
                        k, a = _leaf("ln", rest[3], v)
                        sd[f"{lb}.norm{rest[2][-1]}.{k}"] = a
                    else:  # self_attn / cross_attn_* / mlp
                        k, a = _leaf("dense", rest[4], v)
                        sd[f"{lb}.{rest[2]}.{rest[3]}.{k}"] = a
            elif rest[0] in _UPSCALE:
                kind = "ln" if rest[0] == "upscale_layer_norm" else "conv_t"
                k, a = _leaf(kind, rest[1], v)
                sd[f"mask_decoder.output_upscaling.{_UPSCALE[rest[0]]}.{k}"] = a
            elif rest[0].startswith("output_hypernetworks_mlps_"):
                i = rest[0].rsplit("_", 1)[1]
                k, a = _leaf("dense", rest[2], v)
                ff = _ff(rest[1], depth(rest[0]))
                sd[f"mask_decoder.output_hypernetworks_mlps.{i}.{ff}.{k}"] = a
            elif rest[0] == "iou_prediction_head":
                k, a = _leaf("dense", rest[2], v)
                ff = _ff(rest[1], depth(rest[0]))
                sd[f"mask_decoder.iou_prediction_head.{ff}.{k}"] = a
            else:
                raise KeyError(f"unknown flax SAM parameter {'/'.join(path)}")
        else:
            raise KeyError(f"unknown flax SAM parameter {'/'.join(path)}")
    mats = list(pe.values())
    if not mats or any(not np.array_equal(m, mats[0]) for m in mats[1:]):
        raise ValueError(
            "the flax model's positional Gaussians differ "
            f"({[ '/'.join(p) for p in pe]}); the official SAM has one")
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = mats[0]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def convert_hf_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HuggingFace ``SamModel`` state dict -> the port's (official) names."""
    out = {}
    for k, v in sd.items():
        r = k
        if k == "shared_image_embedding.positional_embedding":
            out["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = v
            continue
        if k == "prompt_encoder.shared_embedding.positional_embedding":
            continue  # tied to the image-wide one
        if r.startswith("vision_encoder."):
            r = "image_encoder." + r[len("vision_encoder."):]
            r = r.replace("patch_embed.projection.", "patch_embed.proj.")
            r = re.sub(r"\.layers\.(\d+)\.layer_norm(\d)\.", r".blocks.\1.norm\2.", r)
            r = re.sub(r"\.layers\.(\d+)\.", r".blocks.\1.", r)
            m = re.match(r"image_encoder\.neck\.(\w+)\.(.*)", r)
            if m:
                r = f"image_encoder.neck.{_NECK[m.group(1)]}.{m.group(2)}"
        elif r.startswith("prompt_encoder."):
            r = re.sub(r"point_embed\.(\d)\.", r"point_embeddings.\1.", r)
            m = re.match(r"prompt_encoder\.mask_embed\.(\w+)\.(.*)", r)
            if m:
                r = f"prompt_encoder.mask_downscaling.{_MASK_DOWN[m.group(1)]}.{m.group(2)}"
        elif r.startswith("mask_decoder."):
            r = re.sub(r"transformer\.layers\.(\d+)\.layer_norm(\d)\.",
                       r"transformer.layers.\1.norm\2.", r)
            r = r.replace("transformer.layer_norm_final_attn.",
                          "transformer.norm_final_attn.")
            m = re.match(r"mask_decoder\.(upscale_\w+)\.(.*)", r)
            if m:
                r = f"mask_decoder.output_upscaling.{_UPSCALE[m.group(1)]}.{m.group(2)}"
            m = re.match(r"(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
                         r"iou_prediction_head))\.(proj_in|proj_out|layers\.\d+)\.(.*)", r)
            if m:
                middle = {kk.split(".")[-2] for kk in sd
                          if kk.startswith(m.group(1) + ".layers.")}
                depth = 2 + len(middle)
                name = m.group(2).replace("layers.", "layers_")
                r = f"{m.group(1)}.{_ff(name, depth)}.{m.group(3)}"
        out[r] = v
    return out


def load_sam_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch SAM checkpoint file (original or HF) -> the port's
    ``state_dict``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if any(k.startswith("image_encoder.") for k in sd):
        return dict(sd)
    return convert_hf_state_dict(sd)
