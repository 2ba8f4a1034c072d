"""Testers (port of the SemSegTester, ClsTester and PartSegTester of
ao_tpu/engines/test.py).

Semantic segmentation:

Each scene is expanded by the dataset into TTA views and, per view, into
complementary GridSample fragments. Fragments are batched ``fb`` at a
time into one padded forward on the tester's device (with their
``discrete_coord`` when the fragments carry it); softmax
probabilities are added onto a full-resolution (n, K) accumulator on the
host and the argmax is scored against the full-resolution labels.
Per-scene votes are cached as ``<name>_pred.npy`` for resume. With
``submit=True`` in the config each scene's prediction is also written in
its benchmark's submission format (:meth:`SemSegTester.save_submission`).

Under a process group each process tests the scenes ``[rank::world]`` and
the histograms are gathered, so that every process reports the whole
split's metrics (only process 0 logs them); each scene's files are written
by the process that tested it.

Classification (``ClsTester``): one padded forward a sample, its argmax
against the category; mAcc and allAcc. Part segmentation
(``PartSegTester``): each shape's views (the dataset's test-mode
fragments, or the sample itself) forwarded with the shape's category, the
softmax averaged per point over the views; per shape the mean part IoU of
its category's parts (a part absent from both labels and prediction counts
1), averaged per shape (ins.mIoU) and per category (cat.mIoU, categories
without a shape counting 0, as in the reference).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..datasets import build_dataset, collate_fn
from ..datasets.scannet_meta import VALID_CLASS_IDS_20, VALID_CLASS_IDS_200
from ..models import build_model
from ..models.point_transformer_v2.convert import load_jax_ckpt, load_jax_npz
from ..utils import (AverageMeter, Registry, comm, get_root_logger,
                     intersection_and_union)

TEST = Registry("test")


def load_weights(path: str):
    """A model ``state_dict`` from a torch ``.pt`` file (a trainer
    checkpoint's ``model``, a ``state_dict`` key, or the dict itself), from
    a JAX package ``.ckpt`` or from an ``.npz`` of JAX variables."""
    if path.endswith(".npz"):
        return load_jax_npz(path)
    if path.endswith(".ckpt"):
        return load_jax_ckpt(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("model", obj.get("state_dict", obj))


class TesterBase:
    """Holds the model; builds it from ``cfg.model`` and loads ``cfg.weight``
    unless a model is given."""

    def __init__(self, cfg=None, verbose=True, device="cuda", model=None):
        self.cfg = cfg
        self.verbose = verbose
        self.device = torch.device(device)
        self.model = model

    def setup(self, cfg):
        self.cfg = cfg
        self.logger = get_root_logger(
            log_file=os.path.join(cfg.save_path, "test.log")
        )
        if self.model is None:
            self.model = build_model(dict(cfg.model))
            weight = cfg.get("weight") or os.path.join(
                cfg.save_path, "model", "model_best.pt"
            )
            self.logger.info(f"Loading weights: {weight}")
            self.model.load_state_dict(load_weights(weight))
        self.model.to(self.device).eval()
        self.save_path = cfg.save_path

    @torch.inference_mode()
    def forward(self, coord, feat, mask, discrete_coord=None, category=None):
        """The model's logits (its ``seg_logits`` where it returns a dict,
        as CAC does); ``category`` goes to a part-segmentation model."""
        kw = {} if category is None else dict(category=category)
        out = self.model(coord, feat, mask, discrete_coord=discrete_coord, **kw)
        return out["seg_logits"] if isinstance(out, dict) else out

    def inputs(self, batch):
        """A collated batch's model inputs on the tester's device."""
        return {k: batch[k].to(self.device)
                for k in ("coord", "feat", "mask", "discrete_coord") if k in batch}

    @staticmethod
    def batches(frags, pad_multiple, fb=8):
        """Yield (fragments, padded batch) for every ``fb`` fragments, as
        :meth:`vote_fragments` feeds them to the model."""
        for i0 in range(0, len(frags), fb):
            group = frags[i0 : i0 + fb]
            yield group, collate_fn(
                [{k: v for k, v in f.items() if k != "index"} for f in group],
                pad_multiple=pad_multiple,
            )

    def vote_fragments(self, frags, n, num_classes, pad_multiple, fb=8):
        """Softmax-vote fragments into a full-scene (n, K) accumulator,
        ``fb`` fragments per padded forward. Returns (votes, [(B, N) of
        every forward])."""
        pred = np.zeros((n, num_classes), np.float32)
        shapes = []
        for group, batch in self.batches(frags, pad_multiple, fb):
            logits = self.forward(**self.inputs(batch))
            probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
            shapes.append(tuple(batch["mask"].shape))
            for b, f in enumerate(group):
                # valid rows are the first len(index) of each batch row
                pred[f["index"]] += probs[b, : len(f["index"])]
        return pred, shapes


@TEST.register_module()
class SemSegTester(TesterBase):
    def __call__(self):
        cfg = self.cfg
        self.setup(cfg)
        logger = self.logger
        dataset = build_dataset(dict(cfg.data.test))
        K = cfg.data.num_classes
        ignore = cfg.data.get("ignore_index", -1)
        pad_multiple = cfg.get("pad_multiple", 4096)
        fb = int(cfg.get("test_fragments_per_batch", 8))

        save_path = os.path.join(cfg.save_path, "result")
        os.makedirs(save_path, exist_ok=True)
        intersection_meter = AverageMeter()
        union_meter = AverageMeter()
        target_meter = AverageMeter()
        scenes = []
        # each process tests its share of the scenes
        scene_ids = range(comm.get_rank(), len(dataset), comm.get_world_size())
        for pos, i in enumerate(scene_ids):
            data_dict = dataset[i]
            name = data_dict["name"]
            segment = data_dict["segment"]
            pred_save = os.path.join(save_path, f"{name}_pred.npy")
            record = dict(name=name, fragments=len(data_dict["fragment_list"]))
            if os.path.isfile(pred_save):
                pred = np.load(pred_save)
            else:
                t0 = time.perf_counter()
                pred, record["batches"] = self.vote_fragments(
                    data_dict["fragment_list"], segment.shape[0], K,
                    pad_multiple, fb,
                )
                record["seconds"] = time.perf_counter() - t0
                np.save(pred_save, pred)
            seg_pred = pred.argmax(-1)
            inter, union, target = intersection_and_union(
                seg_pred, segment, K, ignore
            )
            intersection_meter.update(inter)
            union_meter.update(union)
            target_meter.update(target)
            scenes.append(record)
            self.save_submission(cfg, save_path, name, seg_pred, dataset)
            mask_v = union != 0
            iou = inter[mask_v] / (union[mask_v] + 1e-10)
            acc = inter.sum() / (target.sum() + 1e-10) if target.sum() > 0 else 1.0
            m_iou = np.mean(intersection_meter.sum / (union_meter.sum + 1e-10))
            logger.info(
                f"Test: {name} [{pos + 1}/{len(scene_ids)}] "
                f"Acc {acc:.4f} mIoU {np.mean(iou) if len(iou) else 0:.4f} "
                f"running mIoU {m_iou:.4f}"
            )

        # every process's scene records and histograms (the reference
        # pickles its meters over gloo, test.py:197-229)
        scenes = [r for g in comm.all_gather(scenes) for r in g]
        sums = comm.reduce_dict(dict(inter=intersection_meter.sum,
                                     union=union_meter.sum,
                                     target=target_meter.sum), average=False)
        inter, union, target = sums["inter"], sums["union"], sums["target"]
        iou_class = inter / (union + 1e-10)
        acc_class = inter / (target + 1e-10)
        m_iou = float(np.mean(iou_class))
        m_acc = float(np.mean(acc_class))
        all_acc = float(inter.sum() / (target.sum() + 1e-10))
        logger.info(
            f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}"
        )
        names = cfg.data.get("names", [str(i) for i in range(K)])
        for i in range(K):
            logger.info(
                f"Class_{i}-{names[i]} Result: iou/accuracy "
                f"{iou_class[i]:.4f}/{acc_class[i]:.4f}"
            )
        return dict(mIoU=m_iou, mAcc=m_acc, allAcc=all_acc, scenes=scenes)

    @staticmethod
    def save_submission(cfg, save_path, name, pred, dataset):
        """Write one scene's predicted classes ``pred`` (n,) in its
        benchmark's submission format under ``<save_path>/submit``, only when
        the config sets ``submit`` (port of ao_tpu/engines/test.py:
        SemSegTester.save_submission): ScanNet(200) ``<name>.txt``, one raw
        class id a line; SemanticKITTI
        ``sequences/<seq>/predictions/<frame>.label``, uint32 through
        ``learning_map_inv``; nuScenes ``lidarseg/test/<token>_lidarseg.bin``,
        uint8 of ``pred + 1``."""
        if not cfg.get("submit", False):
            return
        dtype = cfg.get("dataset_type", "")
        if dtype in ("ScanNetDataset", "ScanNet200Dataset"):
            ids = (VALID_CLASS_IDS_200 if dtype == "ScanNet200Dataset"
                   else VALID_CLASS_IDS_20)
            sub_dir = os.path.join(save_path, "submit")
            os.makedirs(sub_dir, exist_ok=True)
            np.savetxt(os.path.join(sub_dir, f"{name}.txt"),
                       np.asarray(ids)[pred].reshape(-1, 1), fmt="%d")
        elif dtype == "SemanticKITTIDataset":
            seq, frame = name.split("_")
            sub_dir = os.path.join(save_path, "submit", "sequences", seq,
                                   "predictions")
            os.makedirs(sub_dir, exist_ok=True)
            inv = cfg.get("learning_map_inv")
            out = pred.astype(np.uint32)
            if inv:
                lut = np.zeros(max(inv.keys()) + 1, np.uint32)
                for k, v in inv.items():
                    lut[k] = v
                out = lut[np.clip(out, 0, len(lut) - 1)]
            out.tofile(os.path.join(sub_dir, f"{frame}.label"))
        elif dtype == "NuScenesDataset":
            sub_dir = os.path.join(save_path, "submit", "lidarseg", "test")
            os.makedirs(sub_dir, exist_ok=True)
            (pred + 1).astype(np.uint8).tofile(
                os.path.join(sub_dir, f"{name}_lidarseg.bin"))


@TEST.register_module()
class ClsTester(TesterBase):
    def __call__(self):
        cfg = self.cfg
        self.setup(cfg)
        dataset = build_dataset(dict(cfg.data.test))
        K = cfg.data.num_classes
        pad_multiple = cfg.get("pad_multiple", 1024)
        correct, total = 0, 0
        inter_sum = np.zeros(K)
        target_sum = np.zeros(K)
        for idx in range(len(dataset)):
            sample = dataset[idx]
            category = int(np.asarray(sample["category"]).reshape(-1)[0])
            batch = collate_fn([sample], pad_multiple=pad_multiple)
            pred = int(self.forward(**self.inputs(batch))[0].argmax())
            correct += int(pred == category)
            total += 1
            inter_sum[category] += pred == category
            target_sum[category] += 1
            if self.verbose and idx % 50 == 0:
                self.logger.info(f"Test: [{idx + 1}/{len(dataset)}] acc "
                                 f"{correct / total:.4f}")
        all_acc = correct / max(total, 1)
        m_acc = float(np.mean(inter_sum / np.maximum(target_sum, 1)))
        self.logger.info(f"Test result: mAcc {m_acc:.4f} allAcc {all_acc:.4f}")
        return dict(allAcc=all_acc, mAcc=m_acc)


@TEST.register_module()
class PartSegTester(TesterBase):
    def __call__(self):
        cfg = self.cfg
        self.setup(cfg)
        dataset = build_dataset(dict(cfg.data.test))
        K = cfg.data.num_classes
        pad_multiple = cfg.get("pad_multiple", 1024)
        categories = dataset.categories
        iou_category = np.zeros(len(categories))
        iou_count = np.zeros(len(categories))
        for idx in range(len(dataset)):
            sample = dataset[idx]
            label = np.asarray(sample["segment"]).reshape(-1)
            cat_idx = int(np.asarray(sample["category"]).reshape(-1)[0])
            category = torch.tensor([cat_idx], device=self.device)
            views = sample.get("fragment_list") or [sample]
            probs = np.zeros((label.size, K), np.float64)
            counts = np.zeros((label.size, 1), np.float64)
            for view in views:
                batch = collate_fn([view], pad_multiple=pad_multiple)
                logits = self.forward(**self.inputs(batch), category=category)
                m = batch["mask"][0].numpy()
                p = torch.softmax(logits[0].float(), dim=-1).cpu().numpy()[m]
                vidx = np.asarray(view.get("index", np.arange(label.size))).reshape(-1)
                np.add.at(probs, vidx, p[: vidx.size])
                np.add.at(counts, vidx, 1.0)
            pred = (probs / np.maximum(counts, 1.0)).argmax(-1)
            parts = dataset.category2part[categories[cat_idx]]
            parts_iou = np.zeros(len(parts))
            for j, part in enumerate(parts):
                gt_m, pr_m = label == part, pred == part
                if not gt_m.any() and not pr_m.any():
                    parts_iou[j] = 1.0
                else:
                    parts_iou[j] = np.sum(gt_m & pr_m) / max(np.sum(gt_m | pr_m), 1)
            iou_category[cat_idx] += parts_iou.mean()
            iou_count[cat_idx] += 1
            if self.verbose and idx % 50 == 0:
                self.logger.info(f"Test: [{idx + 1}/{len(dataset)}]")
        ins_miou = iou_category.sum() / (iou_count.sum() + 1e-10)
        cat_miou = np.mean(iou_category / (iou_count + 1e-10))
        self.logger.info(
            f"Test result: ins.mIoU/cat.mIoU {ins_miou:.4f}/{cat_miou:.4f}")
        return dict(ins_mIoU=float(ins_miou), cat_mIoU=float(cat_miou))
