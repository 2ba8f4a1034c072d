"""SparseUNet (SpUNet-v1m1 / v1m2) on the port's sparse convolution (port
of ao_tpu/models/sparse_unet/spunet.py).

The U-Net: a k=5 submanifold stem, four stride-2 stages (a k=2 conv to
the unique ``dc // 2`` sites, then residual blocks of k=3 submanifold
convs), four decoder stages (the inverse k=2 conv through each fine
site's parent, the skip concatenated, residual blocks) and a 1x1 head.
BatchNorms take eps 1e-3 and momentum 0.01 over the valid rows. Static
site capacities per stage (``stage_cap_ratios`` of the previous level, at
least 32); clusters beyond them merge into the last row, and
``pool_overflow`` holds how many did in the last forward (``stage_overflow``
per stage), as device tensors.

The voxel set is the point set: ``discrete_coord`` (GridSample's integer
grid coordinates) gives the sites. Without it the sites are
``floor(coord - min)``, cells of one coordinate unit, as in the JAX package.

Module and parameter names follow the JAX package's flax names
(``conv_input``, ``down{s}``, ``enc{s}_block{i}.conv1``, ``up{s}_kernel``,
``dec{s}_block{i}``, ``final`` ...), so ``convert.from_jax_variables``
carries its weights across mechanically. Submanifold kernels are
(K, C_in, C_out) as there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.sparse_conv import (build_table, kernel_offsets, neighbor_idx,
                                sparse_conv_apply, sparse_downsample)
from ..builder import MODELS
from ..utils import PointBatchNorm


def trunc_kernel(*shape):
    """A kernel parameter drawn as flax's truncated_normal(0.02)."""
    k = nn.Parameter(torch.empty(shape))
    nn.init.trunc_normal_(k, std=0.02, a=-0.04, b=0.04)
    return k


class SubMConv(nn.Module):
    """Sparse convolution with a (K, C_in, C_out) kernel, K = size^3, on
    precomputed neighbour rows; K = 1 is a pointwise product."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__()
        self.kernel = trunc_kernel(kernel_size ** 3, in_channels, out_channels)

    def forward(self, feat, idx, valid):
        return sparse_conv_apply(feat, idx, valid, self.kernel)

    def pointwise(self, feat, mask):
        """The K = 1 conv on the identity rows: a product, padding rows 0."""
        return torch.where(mask[..., None], feat @ self.kernel[0], 0.0)


def SparseBN(channels):
    return PointBatchNorm(channels, eps=1e-3, momentum=0.01)


class BasicBlock(nn.Module):
    """Two k=3 submanifold convs and a residual, projected by a 1x1 conv
    when the width changes (reference spconv_unet_v1m1_base.py:22-87)."""

    def __init__(self, in_channels, channels):
        super().__init__()
        self.out_channels = channels
        if in_channels != channels:
            self.proj = SubMConv(in_channels, channels, 1)
            self.proj_bn = SparseBN(channels)
        self.conv1 = SubMConv(in_channels, channels)
        self.bn1 = SparseBN(channels)
        self.conv2 = SubMConv(channels, channels)
        self.bn2 = SparseBN(channels)

    def forward(self, feat, mask, idx, valid):
        residual = feat
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj.pointwise(feat, mask), mask)
        h = torch.relu(self.bn1(self.conv1(feat, idx, valid), mask))
        h = self.bn2(self.conv2(h, idx, valid), mask)
        return torch.where(mask[..., None], torch.relu(h + residual), 0.0)


class Bottleneck(nn.Module):
    """1-3-1 residual block of expansion 4, the block of MinkUNet50 / 101
    (reference mink_unet.py:95-156): ``channels`` wide inside, ``channels
    * 4`` out."""

    expansion = 4

    def __init__(self, in_channels, channels):
        super().__init__()
        co = channels * self.expansion
        self.out_channels = co
        if in_channels != co:
            self.proj = SubMConv(in_channels, co, 1)
            self.proj_bn = SparseBN(co)
        self.conv1 = SubMConv(in_channels, channels, 1)
        self.bn1 = SparseBN(channels)
        self.conv2 = SubMConv(channels, channels)
        self.bn2 = SparseBN(channels)
        self.conv3 = SubMConv(channels, co, 1)
        self.bn3 = SparseBN(co)

    def forward(self, feat, mask, idx, valid):
        residual = feat
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj.pointwise(feat, mask), mask)
        h = torch.relu(self.bn1(self.conv1.pointwise(feat, mask), mask))
        h = torch.relu(self.bn2(self.conv2(h, idx, valid), mask))
        h = self.bn3(self.conv3.pointwise(h, mask), mask)
        return torch.where(mask[..., None], torch.relu(h + residual), 0.0)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def voxel_coords(coord, mask, discrete_coord=None):
    """The sites (B, N, 3), padding rows 0: ``discrete_coord``, or without
    it ``floor(coord - min)`` over each scene's valid points."""
    if discrete_coord is None:
        lo = torch.where(mask[..., None], coord, 1e30).amin(dim=1)
        discrete_coord = torch.floor(coord - lo[:, None, :]).to(torch.int32)
    return torch.where(mask[..., None], discrete_coord, 0)


def neighbours(dc, mask, kernel_size):
    """Submanifold neighbour rows and validity of a voxel set, (B, M, K)."""
    offsets = kernel_offsets(kernel_size, dc.device)
    return neighbor_idx(build_table(dc, mask), dc, mask, offsets)


def downsample(dc, mask, cap):
    """The stride-2 level of (dc, mask) at capacity ``cap``: (out_dc,
    out_mask, parent, overflow, k=2 conv rows, their validity)."""
    out_dc, out_mask, parent, overflow = sparse_downsample(dc, mask, cap)
    idx2, val2 = neighbor_idx(build_table(dc, mask), out_dc, out_mask,
                              kernel_offsets(2, dc.device), stride=2)
    return out_dc, out_mask, parent, overflow, idx2, val2


def inverse_conv(h, kernel, parent, fine_dc):
    """The k=2 inverse conv: each fine site takes its parent's feature
    through the kernel slot of its position inside the parent's 2^3 block.
    Computes ``h @ kernel[j]`` for the 8 slots at the coarse level, then
    picks each fine row's (parent, slot)."""
    B, Mc, C_in = h.shape
    C_out = kernel.shape[-1]
    y = h.reshape(B * Mc, C_in) @ kernel.permute(1, 0, 2).reshape(C_in, 8 * C_out)
    slot = ((fine_dc[..., 0] % 2) * 4 + (fine_dc[..., 1] % 2) * 2
            + fine_dc[..., 2] % 2).to(torch.int64)
    base = torch.arange(B, device=h.device)[:, None] * Mc
    rows = ((base + parent) * 8 + slot).reshape(-1)
    return y.reshape(B * Mc * 8, C_out).index_select(0, rows).reshape(
        B, -1, C_out)


def stage_capacities(n, ratios):
    """[n] and each stride-2 level's static capacity, ``max(int(cap * r),
    32)`` of the level before."""
    caps = [n]
    for r in ratios:
        caps.append(max(int(caps[-1] * r), 32))
    return caps


@MODELS.register_module("SpUNet-v1m1")
class SpUNet(nn.Module):
    """SpUNet-v1m1 (reference spconv_unet_v1m1_base.py:89-240). ``block``:
    "basic" or "bottleneck"; ``mink_skeleton``: the MinkUNet encoder, whose
    stride-2 convs keep their width and whose stage's first block projects
    (reference mink_unet.py:174-306); ``cls_mode``: no decoder, the head's
    output mean-pooled over each scene's sites."""

    def __init__(
        self,
        in_channels,
        num_classes,
        base_channels=32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        cls_mode=False,
        block="basic",
        mink_skeleton=False,
        stage_cap_ratios: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
    ):
        super().__init__()
        self.num_classes = num_classes
        self.channels = tuple(channels)
        self.layers = tuple(layers)
        self.cls_mode = cls_mode
        self.stage_cap_ratios = tuple(stage_cap_ratios)
        self.num_stages = len(layers) // 2
        self.pool_overflow = None
        self.stage_overflow = None
        Block = _BLOCKS[block]

        self.conv_input = SubMConv(in_channels, base_channels, 5)
        self.bn_input = SparseBN(base_channels)
        c = base_channels
        skip_c = []
        for s in range(self.num_stages):
            skip_c.append(c)
            down_c = c if mink_skeleton else channels[s]
            self.add_module(f"down{s}", SubMConv(c, down_c, 2))
            self.add_module(f"down{s}_bn", SparseBN(down_c))
            c = down_c
            for i in range(layers[s]):
                blk = Block(c, channels[s])
                self.add_module(f"enc{s}_block{i}", blk)
                c = blk.out_channels
        if not cls_mode:
            for s in reversed(range(self.num_stages)):
                dec_c = channels[len(channels) - s - 2]
                self.register_parameter(f"up{s}_kernel", trunc_kernel(8, c, dec_c))
                self.add_module(f"up{s}_bn", SparseBN(dec_c))
                c = dec_c + skip_c[s]
                for i in range(layers[len(channels) - s - 1]):
                    blk = Block(c, dec_c)
                    self.add_module(f"dec{s}_block{i}", blk)
                    c = blk.out_channels
        if num_classes > 0:
            self.final = nn.Linear(c, num_classes)

    def stage_capacities(self, n: int):
        """Static site capacity of every level for padded size n."""
        return stage_capacities(n, self.stage_cap_ratios[:self.num_stages])

    def forward(self, coord, feat, mask, discrete_coord: Optional[torch.Tensor] = None):
        dc = voxel_coords(coord, mask, discrete_coord)
        h = self.conv_input(feat, *neighbours(dc, mask, 5))
        h = torch.relu(self.bn_input(h, mask))

        caps = self.stage_capacities(dc.shape[1])
        levels = [(dc, mask)]
        parents, skips, nbr3, overflow = [], [], {}, []
        for s in range(self.num_stages):
            cur_dc, cur_mask = levels[-1]
            out_dc, out_mask, parent, over, idx2, val2 = downsample(
                cur_dc, cur_mask, caps[s + 1])
            skips.append(h)
            parents.append(parent)
            overflow.append(over)
            h = getattr(self, f"down{s}")(h, idx2, val2)
            h = torch.relu(getattr(self, f"down{s}_bn")(h, out_mask))
            levels.append((out_dc, out_mask))
            nbr3[s + 1] = neighbours(out_dc, out_mask, 3)
            for i in range(self.layers[s]):
                h = getattr(self, f"enc{s}_block{i}")(h, out_mask, *nbr3[s + 1])
        self.stage_overflow = torch.stack(overflow)
        self.pool_overflow = self.stage_overflow.sum()

        level = self.num_stages
        if not self.cls_mode:
            for s in reversed(range(self.num_stages)):
                fine_dc, fine_mask = levels[s]
                up = inverse_conv(h, getattr(self, f"up{s}_kernel"), parents[s],
                                  fine_dc)
                up = torch.relu(getattr(self, f"up{s}_bn")(up, fine_mask))
                h = torch.cat([up, skips[s]], dim=-1)
                if s not in nbr3:
                    nbr3[s] = neighbours(fine_dc, fine_mask, 3)
                for i in range(self.layers[len(self.channels) - s - 1]):
                    h = getattr(self, f"dec{s}_block{i}")(h, fine_mask, *nbr3[s])
            level = 0

        if self.num_classes > 0:
            h = self.final(h)
        if self.cls_mode:
            m = levels[level][1][..., None].to(h.dtype)
            h = (h * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
        return h


@MODELS.register_module("SpUNet-v1m2")
def _spunet_v1m2(bn_momentum=None, **kwargs):
    """SpUNet-v1m2 (reference spconv_unet_v1m2_bn_momentum.py): takes the
    config's ``bn_momentum`` and, as the JAX package, ignores it."""
    return SpUNet(**kwargs)
