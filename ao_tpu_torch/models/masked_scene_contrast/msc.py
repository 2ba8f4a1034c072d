"""Masked Scene Contrast pretraining, MSC-v1m1 and its CSC variant MSC-v1m2
(port of ao_tpu/models/masked_scene_contrast/msc.py; reference:
pointcept/models/masked_scene_contrast/masked_scene_contrast_v1m1_base.py:
24-300 and masked_scene_contrast_v1m2_csc.py:25-265).

Two augmented views of a scene are patch-masked with complementary masks,
encoded by one backbone, and trained with an InfoNCE loss over
radius-matched cross-view point pairs and MSE colour / normal
reconstruction at the masked points. As in the JAX package:

* cross masks (:func:`cross_masks`): every 0.1 m patch of a view's origin
  coords draws a uniform tag from a hash of its grid key and the step's
  seed; tag < mask_rate masks view 1, the next mask_rate band view 2. The
  grid key wraps as int32 products do and the hash is uint32 arithmetic,
  computed here in int64 with the low 32 bits kept after each product, so
  the tags are the JAX package's bit for bit.
* pairs (:func:`match_pairs`): exact 8-NN from view 1 to view 2 on origin
  coords (``ops.knn``: chunked above its score budget), one random
  in-radius neighbour a query, then a random subset of the matched rows
  capped at ``matching_max_pair`` a scene, ordered as ``lax.top_k`` orders
  them (stable, lower index first on ties); pad rows carry no loss.
* the seed (an integer in [0, 2^31 - 1)) and the two uniform draws come
  from ``generator`` (the default one when None) unless the forward is
  given them (``draws``), as the tests give JAX's.
* CSC: negatives restricted to the spatial partition of each pair (near /
  far by r1 / r2, upper / lower by the offset's z), pairs closer than r1
  forming a fifth partition, the sum over partitions divided by 4.

Under a process group each process draws its own masks and pairs for its
scenes, and the losses are the global batch's: the NCE over every matched
pair of every process, the reconstruction over every masked point
(this process's share of each sum).

The contrastive loss runs a scene at a time under activation
checkpointing, so that no tensor larger than a scene's (P, P) similarity
(268 MB at P = 8192 in f32) lives outside it and nothing of it is kept
for the backward.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.knn import knn
from ..builder import MODELS
from ..default import call_backbone, takes_discrete_coord
from ..losses.misc import global_den

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) (int64) and a constant c < 2^32,
    in two products below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _wrap32(x):
    """An int64 value as the int32 it wraps to."""
    return ((x + 2**31) & _M32) - 2**31


def hash_uniform(key, seed):
    """Uniform [0, 1) per int32 key and the step's seed: the JAX package's
    splitmix-style uint32 hash (f32, as it converts)."""
    x = ((key & _M32) + (seed & _M32)) & _M32
    x = _mul32(x, 0x9E3779B9)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x.float() / 2**32


def patch_tag(origin_coord, mask, grid_size, seed):
    """Uniform tag (B, N) of each point's mask-grid patch."""
    lo = torch.where(mask[..., None], origin_coord, 1e30).amin(1)
    grid = torch.tensor(grid_size, dtype=torch.float32, device=origin_coord.device)
    d = torch.floor((origin_coord - lo[:, None, :]) / grid).long()
    d = torch.where(mask[..., None], d, 0)
    key = (_wrap32(d[..., 0] * 19349663 + d[..., 1] * 83492791)
           ^ _wrap32(d[..., 2] * 73856093))
    return hash_uniform(key, seed)


def cross_masks(origin1, mask1, origin2, mask2, grid_size, mask_rate, seed):
    """Complementary patch masks (B, N1) and (B, N2) of the two views."""
    tag1 = patch_tag(origin1, mask1, grid_size, seed)
    tag2 = patch_tag(origin2, mask2, grid_size, seed)
    return ((tag1 < mask_rate) & mask1,
            (tag2 >= mask_rate) & (tag2 < 2 * mask_rate) & mask2)


def match_pairs(origin1, origin2, mask1, mask2, k, radius, max_pair, r_pick, r_row):
    """Cross-view pairs: (rows (B, P) of view 1, their partners (B, P) in
    view 2, validity (B, P)), P = min(max_pair, N1). ``r_pick`` (B, N1, k)
    and ``r_row`` (B, N1) are the uniform draws that pick a neighbour and
    the subset."""
    idx, dist, valid = knn(origin1, origin2, k, mask1, mask2)
    in_radius = valid & (dist < radius)
    pick = torch.where(in_radius, r_pick, -1.0).argmax(-1)
    picked = idx.gather(-1, pick[..., None])[..., 0].long()
    row_valid = in_radius.any(-1)
    P = min(max_pair, origin1.shape[1])
    score = torch.where(row_valid, r_row, -1.0)
    rows = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :P]
    return rows, picked.gather(1, rows), row_valid.gather(1, rows)


def _take(x, rows):
    return x.gather(1, rows[..., None].expand(-1, -1, x.shape[-1]))


@MODELS.register_module("MSC-v1m1")
class MaskedSceneContrast(nn.Module):
    def __init__(self, backbone=None, backbone_in_channels=6,
                 backbone_out_channels=96, mask_grid_size=0.1, mask_rate=0.4,
                 matching_max_k=8, matching_max_radius=0.03,
                 matching_max_pair=8192, nce_t=0.4, contrast_weight=1.0,
                 reconstruct_weight=1.0, reconstruct_color=True,
                 reconstruct_normal=True, csc=False, partitions=4, r1=0.125,
                 r2=2.0):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)
        self.mask_grid_size = mask_grid_size
        self.mask_rate = mask_rate
        self.matching_max_k = matching_max_k
        self.matching_max_radius = matching_max_radius
        self.matching_max_pair = matching_max_pair
        self.nce_t = nce_t
        self.contrast_weight = contrast_weight
        self.reconstruct_weight = reconstruct_weight
        self.csc = csc
        self.partitions = partitions
        self.r1, self.r2 = r1, r2
        self.mask_token = nn.Parameter(torch.empty(1, backbone_in_channels))
        nn.init.trunc_normal_(self.mask_token, std=0.02, a=-0.04, b=0.04)
        self.color_head = (nn.Linear(backbone_out_channels, 3)
                           if reconstruct_color else None)
        self.normal_head = (nn.Linear(backbone_out_channels, 3)
                            if reconstruct_normal else None)
        self.generator = None  # the draws' generator (the trainer's)

    def draws(self, mask1):
        """(seed, r_pick (B, N1, k), r_row (B, N1)) from ``generator``."""
        g, dev = self.generator, mask1.device
        B, N = mask1.shape
        seed = int(torch.randint(0, 2**31 - 1, (), generator=g, device=dev))
        return (seed, torch.rand((B, N, self.matching_max_k), generator=g, device=dev),
                torch.rand((B, N), generator=g, device=dev))

    def _scene_nce(self, z1, z2, c1, c2, pair_valid):
        """Minus the sum over the valid rows of one scene's InfoNCE
        log-probabilities of the diagonal (CSC: summed over partitions and
        divided by 4)."""
        sim = z1 @ z2.t() / self.nce_t
        neg = pair_valid[None, :]

        def nce(extra=None):
            m = neg if extra is None else neg & extra
            logp = torch.log_softmax(torch.where(m, sim, -1e9), dim=-1)
            return -torch.where(pair_valid, logp.diagonal(), 0.0).sum()

        if not self.csc:
            return nce()
        dx, dy, dz = (c2[None, :, i] - c1[:, None, i] for i in range(3))
        d = torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-7)
        upper, lower = dz > 0.0, dz < 0.0
        near, far = (d > self.r1) & (d <= self.r2), d > self.r2
        eye = torch.eye(len(pair_valid), dtype=torch.bool, device=sim.device)
        parts = [near & upper, near & lower, far & upper, far & lower]
        parts.append(~(parts[0] | parts[1] | parts[2] | parts[3]))
        return sum(nce(pm | eye) for pm in parts) / 4.0

    def _reconstruct(self, head, feat1, feat2, t1, t2, m1, m2):
        se = (torch.where(m1[..., None], (head(feat1) - t1) ** 2, 0.0).sum()
              + torch.where(m2[..., None], (head(feat2) - t2) ** 2, 0.0).sum())
        return se / torch.clamp_min(global_den(m1.sum() + m2.sum()), 1.0)

    def forward(self, view1_origin_coord, view1_coord, view1_feat, view1_mask,
                view2_origin_coord, view2_coord, view2_feat, view2_mask,
                view1_color=None, view1_normal=None, view2_color=None,
                view2_normal=None, view1_discrete_coord=None,
                view2_discrete_coord=None, draws=None):
        """The losses (``loss``, ``nce_loss``, ``color_loss``,
        ``normal_loss``), ``pos_sim``, the matched ``pairs`` and the masks
        ``mask1`` / ``mask2``."""
        seed, r_pick, r_row = draws if draws is not None else self.draws(view1_mask)
        m1, m2 = cross_masks(view1_origin_coord, view1_mask, view2_origin_coord,
                             view2_mask, self.mask_grid_size, self.mask_rate, seed)
        f1 = torch.where(m1[..., None], self.mask_token, view1_feat)
        f2 = torch.where(m2[..., None], self.mask_token, view2_feat)
        feat1 = call_backbone(self.backbone, self._takes_dc, view1_coord, f1,
                              view1_mask, view1_discrete_coord)
        feat2 = call_backbone(self.backbone, self._takes_dc, view2_coord, f2,
                              view2_mask, view2_discrete_coord)

        rows, v2_rows, pair_valid = match_pairs(
            view1_origin_coord, view2_origin_coord, view1_mask, view2_mask,
            self.matching_max_k, self.matching_max_radius,
            self.matching_max_pair, r_pick, r_row)
        z1, z2 = _take(feat1, rows), _take(feat2, v2_rows)
        z1 = z1 / (torch.linalg.vector_norm(z1, dim=-1, keepdim=True) + 1e-7)
        z2 = z2 / (torch.linalg.vector_norm(z2, dim=-1, keepdim=True) + 1e-7)
        c1, c2 = _take(view1_coord, rows), _take(view2_coord, v2_rows)
        pairs = pair_valid.sum()
        count = torch.clamp_min(global_den(pairs.float()), 1.0)
        nce = sum(checkpoint(self._scene_nce, z1[b], z2[b], c1[b], c2[b],
                             pair_valid[b], use_reentrant=False,
                             preserve_rng_state=False)
                  for b in range(len(rows))) / count
        pos_sim = torch.where(pair_valid, (z1 * z2).sum(-1), 0.0).sum() / count
        loss = nce * self.contrast_weight
        out = dict(nce_loss=nce, pos_sim=pos_sim.detach(), pairs=pairs,
                   mask1=m1, mask2=m2)
        for name, head, t1, t2 in (("color", self.color_head, view1_color, view2_color),
                                   ("normal", self.normal_head, view1_normal,
                                    view2_normal)):
            if head is not None and t1 is not None:
                out[f"{name}_loss"] = self._reconstruct(head, feat1, feat2, t1,
                                                        t2, m1, m2)
                loss = loss + out[f"{name}_loss"] * self.reconstruct_weight
        out["loss"] = loss
        return out


@MODELS.register_module("MSC-v1m2")
def _msc_v1m2(**kwargs):
    """MSC-v1m2: MSC with CSC's partition-aware InfoNCE."""
    kwargs.setdefault("csc", True)
    return MaskedSceneContrast(**kwargs)
