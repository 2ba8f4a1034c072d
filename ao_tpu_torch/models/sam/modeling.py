"""Segment Anything Model (SAM) in PyTorch (port of ao_tpu/models/sam/modeling.py).

The architecture of ao_tpu's flax SAM — the ViT image encoder with
windowed and global attention and decomposed relative-position bias, the
neck, the positional prompt encoder, the two-way transformer and the mask
decoder — under the parameter names of the official ``segment_anything``
package (``image_encoder.blocks.N.attn.qkv.weight``, ...), so that a
user's ViT-H checkpoint loads as it is (``convert.py``). The batch layout
is ao_tpu's: ``get_image_embeddings`` returns channel-last (B, s, s, C)
embeddings, and ``predict_masks`` decodes (B, P, n, 2) prompts, frames x
prompts in one call. Attention is written as in ao_tpu (f32 logits, the
relative-position bias added, softmax in f32); the large products are
``torch.matmul`` / ``nn.Linear``, as ao_tpu computes them outside any
Pallas kernel.

Two choices follow the official package, where ao_tpu's flax module
differs from it: the two-way blocks' MLP is ReLU (as in segment_anything
and HuggingFace; ao_tpu's is GELU), and the output upscaling's
``ConvTranspose2d`` applies its kernel as torch does (flax's
``ConvTranspose`` applies a kernel converted by ao_tpu's
``convert_original_checkpoint`` spatially flipped).

``build_sam(config, seed, device)`` builds the model directly on the
device, its weights drawn from a seeded ``torch.Generator``: the same seed
gives the same weights in every process, so cached PP2S embeddings and
REAL's in-loop decodes come from one model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    hidden_size: int = 1280  # ViT-H
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 1024
    patch_size: int = 16
    num_channels: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    output_channels: int = 256
    layer_norm_eps: float = 1e-6
    num_pos_feats: int = 128


@dataclasses.dataclass(frozen=True)
class SamPromptEncoderConfig:
    hidden_size: int = 256
    image_embedding_size: int = 64
    input_image_size: int = 1024
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SamMaskDecoderConfig:
    hidden_size: int = 256
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = SamVisionConfig()
    prompt: SamPromptEncoderConfig = SamPromptEncoderConfig()
    decoder: SamMaskDecoderConfig = SamMaskDecoderConfig()

    @staticmethod
    def vit_h():
        return SamConfig()

    @staticmethod
    def vit_l():
        return SamConfig(
            vision=SamVisionConfig(
                hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                global_attn_indexes=(5, 11, 17, 23),
            )
        )

    @staticmethod
    def vit_b():
        return SamConfig(
            vision=SamVisionConfig(
                hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                global_attn_indexes=(2, 5, 8, 11),
            )
        )

    @staticmethod
    def tiny():
        """Small config for tests."""
        return SamConfig(
            vision=SamVisionConfig(
                hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                image_size=64, patch_size=8, window_size=2,
                global_attn_indexes=(1,), output_channels=16, num_pos_feats=8,
            ),
            prompt=SamPromptEncoderConfig(
                hidden_size=16, image_embedding_size=8, input_image_size=64,
                mask_input_channels=8,
            ),
            decoder=SamMaskDecoderConfig(
                hidden_size=16, num_attention_heads=2, mlp_dim=32,
                iou_head_hidden_dim=16,
            ),
        )


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of a channel-first (B, C, H, W) map."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        x = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight,
                         self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# --------------------------------------------------------------------------
# Image encoder
# --------------------------------------------------------------------------
def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Slice (or linearly resize) relative positional embeddings for q/k
    sizes."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(
            rel_pos.t()[None], size=max_rel_dist, mode="linear",
        )[0].t()
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class Attention(nn.Module):
    """Multi-head attention of the image encoder over a (B, H, W, C) map,
    with the decomposed relative-position bias."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_rel_pos: bool = True, input_size: int = 14):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim**-0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nh, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)  # (B*nh, HW, HW)
        if self.use_rel_pos:
            rh = get_rel_pos(H, H, self.rel_pos_h)  # (H, H, hd)
            rw = get_rel_pos(W, W, self.rel_pos_w)
            rq = q.reshape(B * nh, H, W, -1)
            rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
            attn = (attn.view(B * nh, H, W, H, W) + (
                rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
            )).view(B * nh, H * W, H * W)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        x = (attn @ v).view(B, nh, H, W, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(B, H, W, -1))


def window_partition(x, window_size: int):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, padded, original):
    Hp, Wp = padded
    H, W = original
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W].contiguous()


class Block(nn.Module):
    def __init__(self, cfg: SamVisionConfig, window_size: int):
        super().__init__()
        dim = cfg.hidden_size
        self.norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attn = Attention(
            dim, cfg.num_attention_heads, cfg.qkv_bias, cfg.use_rel_pos,
            window_size if window_size > 0 else cfg.image_size // cfg.patch_size,
        )
        self.norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = MLPBlock(dim, int(dim * cfg.mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, padded = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, padded, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamVisionConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.num_channels, cfg.hidden_size,
                              cfg.patch_size, stride=cfg.patch_size)

    def forward(self, x):  # (B, 3, H, W) -> (B, h, w, C)
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamVisionConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        grid = cfg.image_size // cfg.patch_size
        self.pos_embed = (nn.Parameter(torch.zeros(1, grid, grid, cfg.hidden_size))
                          if cfg.use_abs_pos else None)
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.num_hidden_layers)
        )
        out = cfg.output_channels
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.hidden_size, out, 1, bias=False),
            LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False),
            LayerNorm2d(out),
        )

    def forward(self, x):
        """(B, 3, H, W) normalised pixels -> (B, C_out, h, w)."""
        x = self.patch_embed(x)
        if self.pos_embed is not None:
            x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# --------------------------------------------------------------------------
# Prompt encoder
# --------------------------------------------------------------------------
class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding of [0, 1]^2 coords."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))

    def forward(self, coords):
        coords = 2 * coords - 1
        coords = 2 * math.pi * (coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamPromptEncoderConfig, num_pos_feats: int):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_size
        self.pe_layer = PositionEmbeddingRandom(num_pos_feats)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, dim) for _ in range(cfg.num_point_embeddings))
        self.not_a_point_embed = nn.Embedding(1, dim)
        c = cfg.mask_input_channels
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, stride=2),
            LayerNorm2d(c // 4, cfg.layer_norm_eps),
            nn.GELU(),
            nn.Conv2d(c // 4, c, 2, stride=2),
            LayerNorm2d(c, cfg.layer_norm_eps),
            nn.GELU(),
            nn.Conv2d(c, dim, 1),
        )
        self.no_mask_embed = nn.Embedding(1, dim)

    def get_dense_pe(self):
        """The image-wide positional encoding, (1, s, s, C)."""
        s = self.cfg.image_embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        grid = torch.ones((s, s), device=dev)
        y = (grid.cumsum(0) - 0.5) / s
        x = (grid.cumsum(1) - 0.5) / s
        return self.pe_layer(torch.stack([x, y], dim=-1))[None]

    def _embed_points(self, points, labels, pad: bool):
        points = points + 0.5  # pixel centers
        if pad:
            points = torch.cat([points, points.new_zeros(points.shape[:2] + (1, 2))], 2)
            labels = torch.cat([labels, -labels.new_ones(labels.shape[:2] + (1,))], 2)
        pe = self.pe_layer(points / self.cfg.input_image_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        pe = torch.where(lab == 0, pe + self.point_embeddings[0].weight[0], pe)
        pe = torch.where(lab == 1, pe + self.point_embeddings[1].weight[0], pe)
        return pe

    def forward(self, points, labels, masks=None):
        """points (B, P, n, 2), labels (B, P, n), masks (B, 1, H, W) or None
        -> (sparse (B, P, n + 1, C), dense (B, s, s, C))."""
        sparse = self._embed_points(points, labels, pad=True)
        if masks is not None:
            dense = self.mask_downscaling(masks).permute(0, 2, 3, 1)
        else:
            s = self.cfg.image_embedding_size
            dense = self.no_mask_embed.weight.view(1, 1, 1, -1).expand(
                points.shape[0], s, s, -1)
        return sparse, dense


# --------------------------------------------------------------------------
# Mask decoder
# --------------------------------------------------------------------------
class DecoderAttention(nn.Module):
    """Attention of the two-way transformer over (B, P, t, C) tokens, with
    the optional downscaled internal width."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(dim, internal)
        self.v_proj = nn.Linear(dim, internal)
        self.out_proj = nn.Linear(internal, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        B, P = q.shape[:2]
        nh = self.num_heads
        hd = q.shape[-1] // nh

        def split(x):
            return x.reshape(B * P, x.shape[2], nh, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = (q @ k.transpose(-2, -1)) * (hd**-0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, P, -1, nh * hd)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SamMaskDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        dim, nh, eps = cfg.hidden_size, cfg.num_attention_heads, cfg.layer_norm_eps
        ds = cfg.attention_downsample_rate
        self.self_attn = DecoderAttention(dim, nh)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.cross_attn_token_to_image = DecoderAttention(dim, nh, ds)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = MLPBlock(dim, cfg.mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim, eps=eps)
        self.norm4 = nn.LayerNorm(dim, eps=eps)
        self.cross_attn_image_to_token = DecoderAttention(dim, nh, ds)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamMaskDecoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.num_hidden_layers))
        self.final_attn_token_to_image = DecoderAttention(
            cfg.hidden_size, cfg.num_attention_heads,
            cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        """point_embeddings (B, P, t, C); image_embeddings and image_pe
        (B, h, w, C). Returns (queries (B, P, t, C), keys (B, P, hw, C))."""
        B, h, w, C = image_embeddings.shape
        P = point_embeddings.shape[1]
        keys = image_embeddings.reshape(B, 1, h * w, C).expand(B, P, h * w, C)
        key_pe = image_pe.reshape(B, 1, h * w, C).expand(B, P, h * w, C)
        queries = point_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, key_pe)
        q = queries + point_embeddings
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            nn.Linear(n, k) for n, k in zip(dims, dims[1:] + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamMaskDecoderConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2),
            LayerNorm2d(dim // 4),
            nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, cfg.iou_head_hidden_dim,
                                       self.num_mask_tokens, cfg.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense,
                multimask_output: bool = True):
        """image_embeddings, image_pe, dense (B, h, w, C); sparse
        (B, P, t, C). Returns (masks (B, P, m, 4h, 4w), iou_pred (B, P, m))."""
        B, h, w, C = image_embeddings.shape
        P = sparse.shape[1]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens.expand(B, P, -1, C), sparse], dim=2)
        hs, keys = self.transformer(tokens, image_embeddings + dense, image_pe)
        iou_token_out = hs[:, :, 0]
        mask_tokens_out = hs[:, :, 1: 1 + self.num_mask_tokens]

        up = self.output_upscaling(
            keys.transpose(2, 3).reshape(B * P, C, h, w))  # (B*P, C/8, 4h, 4w)
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, :, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=2)
        masks = hyper_in @ up.reshape(B, P, C // 8, -1)  # (B, P, m, 16hw)
        masks = masks.reshape(B, P, self.num_mask_tokens, 4 * h, 4 * w)
        iou_pred = self.iou_prediction_head(iou_token_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou_pred[:, :, sl]


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------
class SamModel(nn.Module):
    def __init__(self, config: Optional[SamConfig] = None):
        super().__init__()
        self.config = config or SamConfig.vit_h()
        self.image_encoder = ImageEncoderViT(self.config.vision)
        self.prompt_encoder = PromptEncoder(self.config.prompt,
                                            self.config.vision.num_pos_feats)
        self.mask_decoder = MaskDecoder(self.config.decoder)

    def get_image_embeddings(self, pixel_values):
        """pixel_values (B, 3, H, W) normalised -> (B, s, s, C)."""
        return self.image_encoder(pixel_values).permute(0, 2, 3, 1)

    def predict_masks(self, image_embeddings, input_points, input_labels,
                      input_masks=None, multimask_output: bool = True):
        """image_embeddings (B, s, s, C); input_points (B, P, n, 2) in input
        image pixel coords (x, y); labels (B, P, n). Returns
        (low_res_masks (B, P, m, 4s, 4s), iou_pred (B, P, m))."""
        sparse, dense = self.prompt_encoder(input_points, input_labels,
                                            input_masks)
        image_pe = self.prompt_encoder.get_dense_pe().expand_as(image_embeddings)
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense,
                                 multimask_output)

    def forward(self, pixel_values, input_points, input_labels,
                multimask_output: bool = True):
        return self.predict_masks(self.get_image_embeddings(pixel_values),
                                  input_points, input_labels,
                                  multimask_output=multimask_output)


@torch.no_grad()
def init_weights(model: SamModel, seed: int = 0):
    """Deterministic random weights from a seeded generator on the model's
    device: Linear / Conv weights N(0, 1 / fan_in), biases 0, LayerNorms 1
    and 0, token embeddings and the positional Gaussian N(0, 1), the
    absolute and relative position embeddings 0. Parameters are drawn in
    ``named_parameters`` order, then the buffers."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        mod = modules[owner]
        if isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(mod, nn.Embedding):
            p.normal_(0.0, 1.0, generator=g)
        elif leaf != "weight":  # biases, pos_embed, rel_pos_h / rel_pos_w
            p.zero_()
        else:
            # Linear (out, in), Conv2d (out, in, kh, kw); ConvTranspose2d
            # (in, out, 2, 2) at stride 2 sums over its `in` only
            fan_in = (p.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                      else p[0].numel())
            p.normal_(0.0, fan_in**-0.5, generator=g)
    for _, b in model.named_buffers():
        b.normal_(0.0, 1.0, generator=g)
    return model


def build_sam(config: Optional[SamConfig] = None, seed: int = 0,
              device="cuda") -> SamModel:
    """The model built directly on ``device`` (no host copy of its
    weights), with the weights of :func:`init_weights` from ``seed``."""
    with torch.device("meta"):
        model = SamModel(config)
    model = model.to_empty(device=device)
    return init_weights(model, seed).eval()
