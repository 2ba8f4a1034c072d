"""Instance segmentation training, PointGroup (port of
ao_tpu/engines/train_insseg.py).

The PointGroup model returns (seg_logits, bias_pred) and its loss needs
each point's instance and instance centre, so the train step's loss is
:func:`point_group_loss` over ``segment``, ``instance`` and
``instance_center`` (its three terms reported beside it); everything else
(loaders, optimizer, schedule, hooks, checkpoints) is the semantic
trainer's. The ``InsSegEvaluator`` hook makes each validation scene's
proposals on the host (``propose_instances`` over the native BFS
clustering) and scores ScanNet-protocol AP (engines/insseg_eval.py), as
the reference's InsSegEvaluator does (reference: pointcept/engines/hooks/
evaluator.py:204-581).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.point_group import point_group_loss, propose_instances
from .hooks import HOOKS, HookBase
from .insseg_eval import ap_scores, associate_instances, evaluate_matches
from .train import Trainer


class InsSegTrainer(Trainer):
    def _loss(self, batch):
        inputs, segment = self._to_device(batch)
        instance, center = (batch[k].to(self.device, non_blocking=True)
                            for k in ("instance", "instance_center"))
        seg_logits, bias_pred = self.model(**inputs)
        losses = point_group_loss(
            seg_logits, bias_pred, inputs["coord"], segment, instance, center,
            inputs["mask"], ignore_index=self.cfg.data.get("ignore_index", -1))
        terms = {k: v.detach() for k, v in losses.items() if k != "loss"}
        return losses["loss"], seg_logits, terms

    @torch.no_grad()
    def eval_scene(self, batch):
        """(seg_logits, bias_pred) of a validation batch in eval mode, on the
        host."""
        self.model.eval()
        inputs, _ = self._to_device(batch)
        seg_logits, bias_pred = self.model(**inputs)
        return seg_logits.float().cpu().numpy(), bias_pred.float().cpu().numpy()


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """After every epoch: proposals of every validation scene and their
    mAP / AP50 / AP25; AP50 becomes the trainer's current metric, and
    ``comm_info["insseg_result"]`` holds the scores, the number of
    proposals, and the host seconds of clustering and of the AP table."""

    def __init__(self, segment_ignore_index=(-1,), instance_ignore_index=-1,
                 min_region_size: int = 100):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.min_region_size = min_region_size

    def after_epoch(self):
        trainer = self.trainer
        if trainer.cfg.get("evaluate", True) and trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start InsSeg Evaluation >>>>>>>>>>>>>>>>")
        cfg = trainer.cfg
        names, K = cfg.data.names, cfg.data.num_classes
        pg = trainer.model
        scenes, proposals, cluster_s = [], 0, 0.0
        for batch in trainer.val_loader:
            seg_logits, bias_pred = trainer.eval_scene(batch)
            mask = batch["mask"].numpy()
            for b in range(mask.shape[0]):
                m = mask[b]
                if not m.any():
                    continue
                t0 = time.perf_counter()
                pred = propose_instances(
                    seg_logits[b][m], bias_pred[b][m], batch["coord"][b].numpy()[m],
                    segment_ignore_index=self.segment_ignore_index,
                    cluster_thresh=pg.cluster_thresh,
                    cluster_min_points=pg.cluster_min_points,
                    cluster_propose_points=pg.cluster_propose_points,
                    voxel_size=pg.voxel_size)
                cluster_s += time.perf_counter() - t0
                proposals += len(pred["pred_classes"])
                gt, pr = associate_instances(
                    pred, batch["segment"][b].numpy()[m],
                    batch["instance"][b].numpy()[m], K, names,
                    segment_ignore_index=self.segment_ignore_index,
                    instance_ignore_index=self.instance_ignore_index,
                    min_region_size=self.min_region_size)
                scenes.append(dict(gt=gt, pred=pr))
        t0 = time.perf_counter()
        valid_names = [names[i] for i in range(K)
                       if i not in self.segment_ignore_index]
        table = evaluate_matches(scenes, valid_names,
                                 min_region_size=self.min_region_size)
        scores = ap_scores(table, valid_names)
        ap_s = time.perf_counter() - t0
        trainer.logger.info(
            f"Val insseg: mAP/AP50/AP25 {scores['all_ap']:.4f}/"
            f"{scores['all_ap_50']:.4f}/{scores['all_ap_25']:.4f}; "
            f"{proposals} proposals in {len(scenes)} scenes; host seconds: "
            f"clustering {cluster_s:.3f}, AP table {ap_s:.3f}")
        if trainer.writer is not None:
            ep = trainer.epoch + 1
            trainer.writer.add_scalar("val/mAP", scores["all_ap"], ep)
            trainer.writer.add_scalar("val/AP50", scores["all_ap_50"], ep)
            trainer.writer.add_scalar("val/AP25", scores["all_ap_25"], ep)
        trainer.comm_info["current_metric_value"] = scores["all_ap_50"]
        trainer.comm_info["current_metric_name"] = "AP50"
        trainer.comm_info["insseg_result"] = dict(
            scores, proposals=proposals, scenes=len(scenes),
            cluster_seconds=cluster_s, ap_seconds=ap_s)
