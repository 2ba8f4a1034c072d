"""The MinkUNet variants and SPVCNN on the port's sparse convolution (port
of ao_tpu/models/sparse_unet/mink_spvcnn.py).

MinkUNet (reference pointcept/models/sparse_unet/mink_unet.py:159-443)
shares SpUNet's U-Net and differs by each variant's layers and planes,
so the variants are registered as SpUNet configurations with the MinkUNet
encoder skeleton (and the Bottleneck block for 50 / 101).

SPVCNN (reference pointcept/models/spvcnn/ts_spvcnn.py:179-436) adds a
full-resolution point branch fused with the voxel U-Net at three
boundaries: devoxelisation is 3-NN inverse-distance interpolation from the
voxel centres (``ops.interpolation``, K1 and K2 on the card above 2M query
x key pairs), re-voxelisation a scatter mean over the composed downsample
parent maps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.interpolation import interpolation
from ..builder import MODELS
from ..utils import Dropout, PointBatchNorm
from .spunet import (BasicBlock, SparseBN, SpUNet, SubMConv, downsample,
                     inverse_conv, neighbours, stage_capacities, trunc_kernel,
                     voxel_coords)

# (layers, planes) per MinkUNet variant (reference mink_unet.py:366-441)
_MINK_VARIANTS = {
    "MinkUNet14": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet34": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet50": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet101": ((2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14A": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": ((1, 1, 1, 1, 1, 1, 1, 1), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18D": ((2, 2, 2, 2, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet34A": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet34B": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": ((2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
}
# the variants built from the Bottleneck block (reference mink_unet.py:385-397)
_MINK_BOTTLENECK = {"MinkUNet50", "MinkUNet101"}


def _register_mink(name, layers, planes):
    def factory(**kwargs):
        kwargs.setdefault("layers", layers)
        kwargs.setdefault("channels", planes)
        kwargs.setdefault("mink_skeleton", True)
        if name in _MINK_BOTTLENECK:
            kwargs.setdefault("block", "bottleneck")
        return SpUNet(**kwargs)

    MODELS.register_module(name=name, module=factory)


for _name, (_layers, _planes) in _MINK_VARIANTS.items():
    _register_mink(_name, _layers, _planes)


def _segment_mean(values, seg, mask, num_segments):
    """Per-segment mean of (B, N, C) values under the (B, N) segment map,
    over the valid rows; (B, num_segments, C), empty segments 0."""
    B, N, C = values.shape
    rows = torch.where(mask, seg, num_segments) + torch.arange(
        B, device=values.device)[:, None] * (num_segments + 1)
    rows = rows.reshape(-1)
    sums = values.new_zeros((B * (num_segments + 1), C)).index_add(
        0, rows, torch.where(mask[..., None], values, 0.0).reshape(-1, C))
    counts = values.new_zeros(B * (num_segments + 1)).index_add(
        0, rows, mask.reshape(-1).to(values.dtype))
    mean = sums / torch.clamp_min(counts, 1.0)[:, None]
    return mean.reshape(B, num_segments + 1, C)[:, :num_segments]


class _PointTransform(nn.Module):
    """Linear -> BN -> ReLU of the point branch (reference
    ts_spvcnn.py:355-373)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels)
        self.bn = PointBatchNorm(out_channels)

    def forward(self, x, mask):
        return torch.relu(self.bn(self.linear(x), mask))


@MODELS.register_module("SPVCNN")
class SPVCNN(nn.Module):
    """SPVCNN (reference ts_spvcnn.py:179-436): a sparse voxel U-Net with a
    full-resolution point branch, z1 = devoxelize(x4) + pt0(z0) before the
    decoder, z2 = devoxelize(y2) + pt1(z1) at its midpoint (each
    re-voxelised by a scatter mean, then dropout), z3 = y4 + pt2(z2) at the
    head. The two dropouts draw from ``dropout.generator`` (the trainer's)."""

    def __init__(
        self,
        in_channels,
        out_channels,
        base_channels=32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        stage_cap_ratios: Sequence[float] = (0.5, 0.5, 0.5, 0.5),
        dropout_rate=0.3,
    ):
        super().__init__()
        ch = tuple(channels)
        self.layers = tuple(layers)
        self.stage_cap_ratios = tuple(stage_cap_ratios)
        self.pool_overflow = None
        self.stage_overflow = None
        self.stem_conv1 = SubMConv(in_channels, base_channels)
        self.stem_bn1 = SparseBN(base_channels)
        self.stem_conv2 = SubMConv(base_channels, base_channels)
        self.stem_bn2 = SparseBN(base_channels)
        c = base_channels
        skip_c = []
        for s in range(4):
            skip_c.append(c)
            self.add_module(f"down{s}", SubMConv(c, ch[s], 2))
            self.add_module(f"down{s}_bn", SparseBN(ch[s]))
            c = ch[s]
            for i in range(layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(c, ch[s]))
        # decoder stages up0-up3 return to the levels of encoder stages 3-0
        for j, s in enumerate((3, 2, 1, 0)):
            dec_c = ch[4 + j]
            self.register_parameter(f"up{j}_kernel", trunc_kernel(8, c, dec_c))
            self.add_module(f"up{j}_bn", SparseBN(dec_c))
            c = dec_c + skip_c[s]
            for i in range(layers[4 + j]):
                self.add_module(f"up{j}_blocks_block{i}", BasicBlock(c, dec_c))
                c = dec_c
        self.point_transform0 = _PointTransform(base_channels, ch[3])
        self.point_transform1 = _PointTransform(ch[3], ch[5])
        self.point_transform2 = _PointTransform(ch[5], ch[7])
        self.dropout = Dropout(dropout_rate)
        self.final = nn.Linear(ch[7], out_channels)

    def stage_capacities(self, n: int):
        """Static site capacity of every level for padded size n."""
        return stage_capacities(n, self.stage_cap_ratios[:4])

    def _blocks(self, prefix, n, h, dc, mask):
        nbr = neighbours(dc, mask, 3)
        for i in range(n):
            h = getattr(self, f"{prefix}_block{i}")(h, mask, *nbr)
        return h

    def forward(self, coord, feat, mask, discrete_coord: Optional[torch.Tensor] = None):
        dc0 = voxel_coords(coord, mask, discrete_coord)
        nbr0 = neighbours(dc0, mask, 3)
        h = torch.relu(self.stem_bn1(self.stem_conv1(feat, *nbr0), mask))
        h = torch.relu(self.stem_bn2(self.stem_conv2(h, *nbr0), mask))
        z0 = h

        skips = []  # (dc, feat, mask, parent) at the input of each stage
        caps = self.stage_capacities(dc0.shape[1])
        cur_dc, cur_mask = dc0, mask
        point_parent = None  # full-resolution point -> current-level site
        centers, overflow = [], []
        for s in range(4):
            out_dc, out_mask, parent, over, idx2, val2 = downsample(
                cur_dc, cur_mask, caps[s + 1])
            skips.append((cur_dc, h, cur_mask, parent))
            overflow.append(over)
            h = getattr(self, f"down{s}")(h, idx2, val2)
            h = torch.relu(getattr(self, f"down{s}_bn")(h, out_mask))
            cur_dc, cur_mask = out_dc, out_mask
            h = self._blocks(f"enc{s}", self.layers[s], h, cur_dc, cur_mask)
            point_parent = (parent if point_parent is None
                            else torch.gather(parent, 1, point_parent))
            centers.append((cur_dc.float() + 0.5) * float(2 ** (s + 1)))
        self.stage_overflow = torch.stack(overflow)
        self.pool_overflow = self.stage_overflow.sum()

        pcoord = dc0.float() + 0.5  # full-resolution positions
        z1 = interpolation(centers[3], pcoord, h, cur_mask, mask, k=3)
        z1 = z1 + self.point_transform0(z0, mask)
        h = _segment_mean(z1, point_parent, mask, h.shape[1])
        h = self.dropout(torch.where(cur_mask[..., None], h, 0.0))

        def up_stage(h, j):
            fine_dc, skip_feat, fine_mask, parent = skips[3 - j]
            up = inverse_conv(h, getattr(self, f"up{j}_kernel"), parent, fine_dc)
            up = torch.relu(getattr(self, f"up{j}_bn")(up, fine_mask))
            h = torch.cat([up, skip_feat], dim=-1)
            h = self._blocks(f"up{j}_blocks", self.layers[4 + j], h, fine_dc,
                             fine_mask)
            return h, fine_mask

        h, cur_mask = up_stage(h, 0)
        h, cur_mask = up_stage(h, 1)
        z2 = interpolation(centers[1], pcoord, h, cur_mask, mask, k=3)
        z2 = z2 + self.point_transform1(z1, mask)
        # re-voxelise at y2's level: the parents of stages 0 and 1 composed
        p01 = torch.gather(skips[1][3], 1, skips[0][3])
        h = _segment_mean(z2, p01, mask, h.shape[1])
        h = self.dropout(torch.where(cur_mask[..., None], h, 0.0))

        h, cur_mask = up_stage(h, 2)
        h, cur_mask = up_stage(h, 3)
        z3 = h + self.point_transform2(z2, mask)
        out = self.final(z3)
        return torch.where(mask[..., None], out, 0.0)
