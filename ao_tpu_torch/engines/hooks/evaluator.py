"""Per-epoch evaluation (port of ao_tpu/engines/hooks/evaluator.py;
reference: pointcept/engines/hooks/evaluator.py:105-201).

``SemSegEvaluator`` sums the per-class intersection / union / target
histograms of ``trainer.eval_batch`` over the validation loader and
reports mIoU, mAcc and allAcc; mIoU becomes the trainer's current metric.
``ClsEvaluator`` (reference :21-102) sums the same histograms of a
classifier's batches (one prediction a scene) and reports mAcc and
allAcc; allAcc becomes the current metric.
"""

from __future__ import annotations

import time

import numpy as np

from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    def after_epoch(self):
        trainer = self.trainer
        if trainer.cfg.get("evaluate", True) and trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        t0 = time.perf_counter()
        K = trainer.cfg.data.num_classes
        inter_sum = np.zeros(K)
        union_sum = np.zeros(K)
        target_sum = np.zeros(K)
        loss_sum, n_batches = 0.0, 0
        for i, batch in enumerate(trainer.val_loader):
            loss, inter, union, target = (
                np.asarray(x) for x in trainer.eval_batch(batch))
            inter_sum += inter
            union_sum += union
            target_sum += target
            loss_sum += float(loss)
            n_batches += 1
            iou = inter.sum() / (union.sum() + 1e-10)
            trainer.logger.info(
                f"Test: [{i + 1}/{len(trainer.val_loader)}] "
                f"Loss {float(loss):.4f} Batch allIoU {iou:.4f}")
        iou_class = inter_sum / (union_sum + 1e-10)
        acc_class = inter_sum / (target_sum + 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter_sum.sum() / (target_sum.sum() + 1e-10))
        seconds = time.perf_counter() - t0
        trainer.logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}.")
        names = trainer.cfg.data.get("names", [str(i) for i in range(K)])
        for i in range(K):
            trainer.logger.info(
                f"Class_{i}-{names[i]} Result: iou/accuracy "
                f"{iou_class[i]:.4f}/{acc_class[i]:.4f}")
        trainer.logger.info(f"Evaluation of {n_batches} batches: {seconds:.2f} s")
        current_epoch = trainer.epoch + 1
        loss_avg = loss_sum / max(n_batches, 1)
        if trainer.writer is not None:
            trainer.writer.add_scalar("val/loss", loss_avg, current_epoch)
            trainer.writer.add_scalar("val/mIoU", m_iou, current_epoch)
            trainer.writer.add_scalar("val/mAcc", m_acc, current_epoch)
            trainer.writer.add_scalar("val/allAcc", all_acc, current_epoch)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"
        trainer.comm_info["val_result"] = dict(
            epoch=current_epoch, mIoU=m_iou, mAcc=m_acc, allAcc=all_acc,
            loss=loss_avg, batches=n_batches, seconds=seconds)

    def after_train(self):
        self.trainer.logger.info(
            f"Best mIoU: {self.trainer.best_metric_value:.4f}")


@HOOKS.register_module()
class ClsEvaluator(HookBase):
    def after_epoch(self):
        trainer = self.trainer
        if trainer.cfg.get("evaluate", True) and trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        t0 = time.perf_counter()
        K = trainer.cfg.data.num_classes
        inter_sum = np.zeros(K)
        target_sum = np.zeros(K)
        loss_sum, n_batches = 0.0, 0
        for batch in trainer.val_loader:
            loss, inter, _, target = (
                np.asarray(x) for x in trainer.eval_batch(batch))
            inter_sum += inter
            target_sum += target
            loss_sum += float(loss)
            n_batches += 1
        acc_class = inter_sum / (target_sum + 1e-10)
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter_sum.sum() / (target_sum.sum() + 1e-10))
        seconds = time.perf_counter() - t0
        trainer.logger.info(f"Val result: mAcc/allAcc {m_acc:.4f}/{all_acc:.4f}.")
        trainer.logger.info(f"Evaluation of {n_batches} batches: {seconds:.2f} s")
        current_epoch = trainer.epoch + 1
        loss_avg = loss_sum / max(n_batches, 1)
        if trainer.writer is not None:
            trainer.writer.add_scalar("val/loss", loss_avg, current_epoch)
            trainer.writer.add_scalar("val/mAcc", m_acc, current_epoch)
            trainer.writer.add_scalar("val/allAcc", all_acc, current_epoch)
        trainer.logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        trainer.comm_info["current_metric_value"] = all_acc
        trainer.comm_info["current_metric_name"] = "allAcc"
        trainer.comm_info["val_result"] = dict(
            epoch=current_epoch, mAcc=m_acc, allAcc=all_acc, loss=loss_avg,
            batches=n_batches, seconds=seconds)

    def after_train(self):
        self.trainer.logger.info(
            f"Best allAcc: {self.trainer.best_metric_value:.4f}")
