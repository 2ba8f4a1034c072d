"""Point Transformer V1: segmentation, part segmentation and classification
(port of ao_tpu/models/point_transformer/ptv1.py; reference:
pointcept/models/point_transformer/point_transformer_{seg,partseg,cls}.py).

Subtraction-relation vector attention over each point's k nearest points
(:class:`PointTransformerLayer`), FPS + kNN strided downsampling
(:class:`TransitionDown`), interpolation / global-context upsampling
(:class:`TransitionUp`), Bottleneck residual blocks and the 26 / 38 /
50-layer U-Nets. Batches are padded ``(B, N, ...)`` with masks; FPS, kNN
and interpolation come from ``ao_tpu_torch.ops`` (FPS on the card is
``csrc/fps.cu``, the unpooling's curve-window search above 2M pairs K1
and K2). The flax package's LayerNorm epsilon (1e-6) is kept. The module
names are the flax ones where flax names them (``enc{s}_down``,
``enc{s}_block{b}``, ``dec{s}_up``, ``dec{s}_block0``) and the reference's
inside the blocks; ``convert.py`` maps one onto the other. Train mode
normalises with batch statistics of the valid rows and draws dropout (the
classifier head's) from ``generator``; eval mode uses the running
statistics and no dropout. FPS keeps a fixed count of points, so
``pool_overflow`` is always 0.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..builder import MODELS
from ..utils import ClassifierHead, PointBatchNorm
from ...ops import (
    farthest_point_sampling,
    grouping,
    grouping_with_rel_coord,
    interpolation,
    knn,
    knn_query,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default

_PLANES = (32, 64, 128, 256, 512)
_STRIDE = (1, 4, 4, 4, 4)
_NSAMPLE = (8, 16, 16, 16, 16)


class LayerNorm1d(nn.LayerNorm):
    """LayerNorm over the channel axis (reference utils.LayerNorm1d) with
    flax's epsilon. Its variance is torch's two-pass one, where flax takes
    mean(x^2) - mean(x)^2: the two differ by rounding, which the
    three-channel LayerNorm of the position encoding amplifies where its
    channels are nearly equal (tests/test_torch_ptv1.py)."""

    def __init__(self, features: int):
        super().__init__(features, eps=LN_EPS)


class PointTransformerLayer(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, share_planes: int = 8,
                 nsample: int = 16):
        super().__init__()
        self.mid_planes = mid = out_planes
        self.out_planes = out_planes
        self.share_planes = share_planes
        self.nsample = nsample
        self.linear_q = nn.Linear(in_planes, mid)
        self.linear_k = nn.Linear(in_planes, mid)
        self.linear_v = nn.Linear(in_planes, out_planes)
        self.linear_p = nn.Sequential(
            nn.Linear(3, 3), LayerNorm1d(3), nn.ReLU(),
            nn.Linear(3, out_planes))
        w = out_planes // share_planes
        self.linear_w = nn.Sequential(
            LayerNorm1d(mid), nn.ReLU(), nn.Linear(mid, w), LayerNorm1d(w),
            nn.ReLU(), nn.Linear(w, w))

    def forward(self, coord, feat, mask):
        q = self.linear_q(feat)
        k = self.linear_k(feat)
        v = self.linear_v(feat)
        idx, _, valid = knn_query(self.nsample, coord, mask)
        k_g = grouping(k, idx, valid)  # (B, N, ns, mid)
        v_g = grouping(v, idx, valid)
        pe = self.linear_p(grouping_with_rel_coord(coord, coord, idx, valid))
        B, N, ns, _ = k_g.shape
        pe_sum = pe.reshape(B, N, ns, -1, self.mid_planes).sum(3)
        w = self.linear_w(k_g - q[:, :, None, :] + pe_sum)
        # a padded query has no valid neighbour: its softmax over -inf is
        # NaN, which the second where turns to 0 (and whose gradient the
        # first where stops)
        w = torch.where(valid[..., None], w, -torch.inf)
        w = torch.where(valid[..., None], torch.softmax(w, dim=2), 0.0)
        s = self.share_planes
        vpe = (v_g + pe).reshape(B, N, ns, s, self.out_planes // s)
        out = (vpe * w[:, :, :, None, :]).sum(2).reshape(B, N, self.out_planes)
        return torch.where(mask[:, :, None], out, 0.0)


class TransitionDown(nn.Module):
    """Stride 1: Linear-BN-ReLU. Otherwise FPS keeps N // stride of the
    padded points (the valid ones: max(n_valid // stride, 1)), and each
    kept point max-pools Linear-BN-ReLU of its ``nsample`` nearest points'
    [relative position, feature]."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 nsample: int = 16):
        super().__init__()
        self.stride = stride
        self.nsample = nsample
        extra = 0 if stride == 1 else 3
        self.linear = nn.Linear(extra + in_planes, out_planes, bias=False)
        self.bn = PointBatchNorm(out_planes)

    def forward(self, coord, feat, mask):
        if self.stride == 1:
            return coord, torch.relu(self.bn(self.linear(feat), mask)), mask
        B, N, _ = coord.shape
        m = N // self.stride
        sel, _ = farthest_point_sampling(coord, mask, m)
        new_coord = torch.gather(coord, 1, sel.long()[:, :, None].expand(B, m, 3))
        n_valid = mask.sum(1, keepdim=True)
        new_mask = (torch.arange(m, device=coord.device)[None, :]
                    < torch.clamp_min(n_valid // self.stride, 1))
        idx, _, valid = knn(new_coord, coord, self.nsample, new_mask, mask)
        grouped = grouping(feat, idx, valid)
        rel = grouping_with_rel_coord(coord, new_coord, idx, valid)
        h = self.linear(torch.cat([rel, grouped], dim=-1))  # (B, m, ns, out)
        h = torch.relu(self.bn(h, valid))
        h = torch.amax(torch.where(valid[..., None], h, -torch.inf), dim=2)
        return new_coord, torch.where(new_mask[:, :, None], h, 0.0), new_mask


class TransitionUp(nn.Module):
    """``out_planes`` 0: the decoder head, [feature, Linear-ReLU of the
    masked mean (, the shape class' embedding)] -> Linear-BN-ReLU.
    Otherwise: Linear-BN-ReLU of the skip features plus the interpolation
    of Linear-BN-ReLU of the coarse ones."""

    def __init__(self, in_planes: int, out_planes: int = 0,
                 num_shape_classes: int = 0, shape_embed_dim: int = 1024):
        super().__init__()
        self.out_planes = out_planes
        self.num_shape_classes = num_shape_classes
        if out_planes == 0:
            self.linear_global = nn.Linear(in_planes, in_planes)
            width = 2 * in_planes
            if num_shape_classes:
                self.linear_shape = nn.Linear(num_shape_classes, shape_embed_dim)
                width += shape_embed_dim
            self.linear = nn.Linear(width, in_planes)
            self.bn = PointBatchNorm(in_planes)
        else:
            self.linear_skip = nn.Linear(out_planes, out_planes)
            self.bn_skip = PointBatchNorm(out_planes)
            self.linear_up = nn.Linear(in_planes, out_planes)
            self.bn_up = PointBatchNorm(out_planes)

    def forward(self, coord, feat, mask, skip_coord=None, skip_feat=None,
                skip_mask=None, category=None):
        if self.out_planes == 0:
            mm = mask[..., None].to(feat.dtype)
            gmean = (feat * mm).sum(1) / torch.clamp_min(mm.sum(1), 1.0)
            g = torch.relu(self.linear_global(gmean))
            parts = [feat, g[:, None, :].expand_as(feat)]
            if self.num_shape_classes:
                # PartSeg: one-hot shape class -> Linear(1024) -> ReLU,
                # broadcast to every point (reference
                # point_transformer_partseg.py:143-178)
                onehot = nn.functional.one_hot(
                    category.reshape(-1).long(), self.num_shape_classes
                ).to(feat.dtype)
                y = torch.relu(self.linear_shape(onehot))
                parts.append(y[:, None, :].expand(
                    feat.shape[0], feat.shape[1], y.shape[-1]))
            h = self.linear(torch.cat(parts, dim=-1))
            return torch.relu(self.bn(h, mask))
        h1 = torch.relu(self.bn_skip(self.linear_skip(skip_feat), skip_mask))
        h2 = torch.relu(self.bn_up(self.linear_up(feat), mask))
        up = interpolation(coord, skip_coord, h2, mask, skip_mask)
        return torch.where(skip_mask[:, :, None], h1 + up, 0.0)


class Bottleneck(nn.Module):
    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16):
        super().__init__()
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = PointBatchNorm(planes)
        self.transformer = PointTransformerLayer(planes, planes, share_planes,
                                                 nsample)
        self.bn2 = PointBatchNorm(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = PointBatchNorm(planes)

    def forward(self, coord, feat, mask):
        h = torch.relu(self.bn1(self.linear1(feat), mask))
        h = torch.relu(self.bn2(self.transformer(coord, h, mask), mask))
        h = self.bn3(self.linear3(h), mask)
        return torch.where(mask[:, :, None], torch.relu(feat + h), 0.0)


class _Encoder(nn.Module):
    """The five stages of TransitionDown + Bottlenecks shared by the three
    models."""

    pool_overflow = 0

    def __init__(self, blocks: Sequence[int], in_channels: int,
                 share_planes: int):
        super().__init__()
        self.blocks = tuple(blocks)
        self.share_planes = share_planes
        in_planes = in_channels
        for s in range(5):
            setattr(self, f"enc{s + 1}_down", TransitionDown(
                in_planes, _PLANES[s], _STRIDE[s], _NSAMPLE[s]))
            for b in range(self.blocks[s]):
                setattr(self, f"enc{s + 1}_block{b}", Bottleneck(
                    _PLANES[s], share_planes, _NSAMPLE[s]))
            in_planes = _PLANES[s]

    def encode(self, coord, feat, mask):
        """The five stages' (coord, feat, mask)."""
        skips = []
        c, h, mk = coord, feat, mask
        for s in range(5):
            c, h, mk = getattr(self, f"enc{s + 1}_down")(c, h, mk)
            for b in range(self.blocks[s]):
                h = getattr(self, f"enc{s + 1}_block{b}")(c, h, mk)
            skips.append((c, h, mk))
        return skips


class PointTransformerSeg(_Encoder):
    def __init__(self, blocks, in_channels: int = 6, num_classes: int = 13,
                 share_planes: int = 8, num_shape_classes: int = 0):
        super().__init__(blocks, in_channels, share_planes)
        self.dec5_up = TransitionUp(_PLANES[4], 0,
                                    num_shape_classes=num_shape_classes)
        self.dec5_block0 = Bottleneck(_PLANES[4], share_planes, _NSAMPLE[4])
        for s in reversed(range(4)):
            setattr(self, f"dec{s + 1}_up", TransitionUp(_PLANES[s + 1], _PLANES[s]))
            setattr(self, f"dec{s + 1}_block0", Bottleneck(
                _PLANES[s], share_planes, _NSAMPLE[s]))
        self.seg_fc = nn.Linear(_PLANES[0], _PLANES[0])
        self.seg_bn = PointBatchNorm(_PLANES[0])
        self.seg_out = nn.Linear(_PLANES[0], num_classes)

    def forward(self, coord, feat, mask):
        return self.decode(self.encode(coord, feat, mask))

    def decode(self, skips, category=None):
        """Logits of the five stages' (coord, feat, mask)."""
        c, h, mk = skips[-1]
        h = self.dec5_up(c, h, mk, category=category)
        h = self.dec5_block0(c, h, mk)
        for s in reversed(range(4)):
            sc, sh, sm = skips[s]
            h = getattr(self, f"dec{s + 1}_up")(c, h, mk, sc, sh, sm)
            c, mk = sc, sm
            h = getattr(self, f"dec{s + 1}_block0")(c, h, mk)
        g = torch.relu(self.seg_bn(self.seg_fc(h), mk))
        return self.seg_out(g)


class PointTransformerPartSeg(PointTransformerSeg):
    """PT-v1 part segmentation (reference point_transformer_partseg.py:
    216-351): the Seg U-Net whose decoder head also takes the shape
    category's one-hot -> Linear(1024) embedding (class 0 when none is
    given)."""

    def __init__(self, blocks, in_channels: int = 6, num_classes: int = 50,
                 share_planes: int = 8, num_shape_classes: int = 16):
        super().__init__(blocks, in_channels, num_classes, share_planes,
                         num_shape_classes)

    def forward(self, coord, feat, mask, category=None):
        if category is None:
            category = torch.zeros(coord.shape[0], dtype=torch.long,
                                   device=coord.device)
        return self.decode(self.encode(coord, feat, mask), category)


class PointTransformerCls(_Encoder):
    def __init__(self, blocks, in_channels: int = 6, num_classes: int = 40,
                 share_planes: int = 8):
        super().__init__(blocks, in_channels, share_planes)
        self.head = ClassifierHead(_PLANES[4], num_classes)

    def forward(self, coord, feat, mask):
        _, h, mk = self.encode(coord, feat, mask)[-1]
        mm = mk[..., None].to(h.dtype)
        gmean = (h * mm).sum(1) / torch.clamp_min(mm.sum(1), 1.0)
        return self.head(gmean)


_BLOCKS = {26: (1, 1, 1, 1, 1), 38: (1, 2, 2, 2, 2), 50: (1, 2, 3, 5, 2)}
_KINDS = {"Seg": PointTransformerSeg, "Cls": PointTransformerCls,
          "PartSeg": PointTransformerPartSeg}


def _factory(cls, blocks):
    def make(**kwargs):
        return cls(blocks, **kwargs)

    return make


for _kind, _cls in _KINDS.items():
    for _depth, _blocks in _BLOCKS.items():
        MODELS.register_module(name=f"PointTransformer-{_kind}{_depth}",
                               module=_factory(_cls, _blocks))
