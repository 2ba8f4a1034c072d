"""PointGroup instance segmentation, PG-v1m1 (port of
ao_tpu/models/point_group/point_group.py; reference: pointcept/models/
point_group/point_group_v1m1_base.py:19-180).

Backbone features feed a semantic head and a per-point centre-offset
("bias") head; the training loss (:func:`point_group_loss`) is CE plus the
offsets' L1 and cosine terms over the points of an instance. At inference
(:func:`propose_instances`, host numpy) points are shifted by their
predicted offsets and clustered by ``ops.cluster.bfs_cluster``; proposals
of at most ``cluster_propose_points`` points are dropped, the others
scored by their mean semantic confidence.

Parameter names are the reference's: ``bias_head`` (Linear,
PointBatchNorm with eps 1e-3 and momentum 0.01, ReLU, Linear to 3) and
``seg_head``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...ops.cluster import bfs_cluster
from ..builder import MODELS
from ..default import call_backbone, takes_discrete_coord
from ..losses.misc import CrossEntropyLoss, global_den
from ..utils import PointBatchNorm


class BiasHead(nn.Sequential):
    def __init__(self, c):
        super().__init__(nn.Linear(c, c), PointBatchNorm(c, eps=1e-3, momentum=0.01),
                         nn.ReLU(), nn.Linear(c, 3))

    def forward(self, x, mask):
        return self[3](self[2](self[1](self[0](x), mask)))


@MODELS.register_module("PG-v1m1")
class PointGroup(nn.Module):
    def __init__(self, backbone=None, backbone_out_channels=96,
                 semantic_num_classes=20, semantic_ignore_index=-1,
                 segment_ignore_index: Tuple[int, ...] = (-1, 0, 1),
                 instance_ignore_index=-1, cluster_thresh=1.5,
                 cluster_closed_points=300, cluster_propose_points=100,
                 cluster_min_points=50, voxel_size=0.02):
        super().__init__()
        self.backbone = backbone
        self._takes_dc = takes_discrete_coord(backbone)
        self.semantic_num_classes = semantic_num_classes
        self.semantic_ignore_index = semantic_ignore_index
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        self.cluster_closed_points = cluster_closed_points
        self.cluster_propose_points = cluster_propose_points
        self.cluster_min_points = cluster_min_points
        self.voxel_size = voxel_size
        self.bias_head = BiasHead(backbone_out_channels)
        self.seg_head = nn.Linear(backbone_out_channels, semantic_num_classes)

    def forward(self, coord, feat, mask, discrete_coord=None):
        """Returns (seg_logits (B, N, K), bias_pred (B, N, 3))."""
        h = call_backbone(self.backbone, self._takes_dc, coord, feat, mask,
                          discrete_coord)
        return self.seg_head(h), self.bias_head(h, mask)


def point_group_loss(seg_logits, bias_pred, coord, segment, instance,
                     instance_center, mask, ignore_index=-1,
                     instance_ignore_index=-1):
    """CE plus the offsets' L1 and negative cosine, each averaged over the
    valid points of an instance (reference :78-98); under a process group,
    over the global batch's points (this process's share)."""
    seg_loss = CrossEntropyLoss(ignore_index=ignore_index)(
        seg_logits, segment.long(), mask)
    m = ((instance != instance_ignore_index) & mask).float()
    bias_gt = instance_center - coord
    l1 = (bias_pred - bias_gt).abs().sum(-1)
    den = global_den(m.sum()) + 1e-8
    bias_l1_loss = (l1 * m).sum() / den
    pn = bias_pred / (torch.linalg.vector_norm(bias_pred, dim=-1, keepdim=True) + 1e-8)
    gn = bias_gt / (torch.linalg.vector_norm(bias_gt, dim=-1, keepdim=True) + 1e-8)
    cos = -(pn * gn).sum(-1)
    bias_cos_loss = (cos * m).sum() / den
    return {"loss": seg_loss + bias_l1_loss + bias_cos_loss,
            "seg_loss": seg_loss, "bias_l1_loss": bias_l1_loss,
            "bias_cosine_loss": bias_cos_loss}


def propose_instances(seg_logits, bias_pred, coord, segment_ignore_index=(-1, 0, 1),
                      cluster_thresh=1.5, cluster_min_points=50,
                      cluster_propose_points=100, voxel_size=0.02):
    """Host proposals of one scene from its (N, K) logits, (N, 3) offsets
    and (N, 3) coords (numpy; reference :103-177): points whose argmax
    class is not ignored, shifted by their offsets and divided by the voxel
    size, cluster by label within ``cluster_thresh``. Returns pred_masks
    (P, N) uint8, pred_classes (P,) int64 (the first member's class),
    pred_scores (P,) float32 (that class's mean probability)."""
    from scipy.special import softmax

    probs = softmax(seg_logits, axis=-1)
    segment_pred = probs.argmax(-1)
    keep = ~np.isin(segment_pred, segment_ignore_index)
    n = coord.shape[0]
    masks, classes, scores = [], [], []
    if keep.any():
        center_pred = (coord + bias_pred) / voxel_size
        labels, n_clusters = bfs_cluster(
            center_pred.astype(np.float32),
            np.where(keep, segment_pred, -1).astype(np.int32),
            radius=cluster_thresh, min_points=cluster_min_points)
        for cid in range(n_clusters):
            members = labels == cid
            if members.sum() <= cluster_propose_points:
                continue
            cls = segment_pred[members][0]
            masks.append(members.astype(np.uint8))
            classes.append(cls)
            scores.append(float(probs[members, cls].mean()))
    if not masks:
        return dict(pred_masks=np.zeros((0, n), np.uint8),
                    pred_classes=np.zeros(0, np.int64),
                    pred_scores=np.zeros(0, np.float32))
    return dict(pred_masks=np.stack(masks),
                pred_classes=np.asarray(classes, np.int64),
                pred_scores=np.asarray(scores, np.float32))
