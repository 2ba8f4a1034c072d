"""REAL — SAM-in-the-loop pseudo-label refinement training (port of
ao_tpu/engines/train_real.py; reference: pointcept/engines/train_sam_real.py).

Per epoch:

1. hot loop: the train step (the port's ``Trainer``, all six CUDA kernels
   of PT-v2m2) additionally returns the step's logits, detached; each
   step copies them to the host and scatters them into the per-scene
   logit "basket" keyed by original point row (the dataset's weak mode
   stores original indices in ``instance`` — datasets/s3dis.py real
   mode). As in ao_tpu, the basket stays on the host.
2. after_epoch (reference :257-582): merge baskets across processes (a
   host object gather replaces the reference's filesystem-pickle exchange,
   :266-294); per scene compute prediction + top1-top2 softmax confidence;
   grid prompt search (0.5 m XY cells x GT-present classes, picking the
   max-confidence "incognita" point — predicted class disagrees with the
   current SAM label — with confidence > 0.9, :361-390); prompt SAM on
   cached frame embeddings (batched through the predictor); accept a
   mask only if its class equals the mode of high-confidence predictions
   inside it (:464-472); vote masks onto points; reject votes that
   disagree with the model prediction ("check by model", :499-500); write
   the updated labels that the next epoch trains on; track
   ``sam_label/{mIoU, mPre, mRec, num_updated, prompt_accuracy}``
   (also kept, with the round's seconds, in ``refine_history``).

Grid prompt search and mask voting are vectorised numpy (no per-cell
python loops); SAM prompts are batched across frames. With the oracle
predictor the scenes are refined in a fork pool: the parent holds a CUDA
context by then, so ``_refine_one_scene`` stays numpy-only and never
touches the card. The neural predictor decodes in-process on the card.

Index convention: bridges store [u, v, visible] and masks are indexed
[v-1, u-1] (row, col). The reference is internally inconsistent here —
my_run_sam_final.py swaps bridge columns before indexing while
train_sam_real.py:463 does not; we standardise on the geometrically
correct row/col order.
"""

from __future__ import annotations

import glob
import os
import shutil
import time
from typing import Dict, List

import numpy as np

from ..datasets.defaults import load_scene
from ..pp2s.labels import load_basket
from ..utils import comm

from .label_eval import get_miou
from .train import Trainer


def grid_prompt_search(
    coord: np.ndarray,  # (N, 3)
    seg_pred: np.ndarray,  # (N,) argmax prediction (-1 where no logits)
    confidence: np.ndarray,  # (N,) top1 - top2 softmax confidence
    sam_label: np.ndarray,  # (N,) current pseudo-labels
    classes_present: np.ndarray,  # GT-present class ids
    grid_scale: float = 0.5,
    conf_thresh: float = 0.9,
    require_disagreement: bool = True,
):
    """Vectorised grid prompt mining (reference :361-390): per (0.5 m XY
    cell, present class), the max-confidence point predicted as that class
    whose current label disagrees, if its confidence exceeds the threshold.
    ``require_disagreement=False`` is the query ablation
    (train_sam_final_query_abl.py:370-375): any max-confidence point of
    the class qualifies, with the threshold raised to 0.95 by its config.
    Returns (prompt_idx (P,), prompt_cls (P,))."""
    lo = coord[:, :2].min(0)
    cell = np.floor((coord[:, :2] - lo) / grid_scale).astype(np.int64)
    n_cells_y = cell[:, 1].max() + 1 if len(cell) else 1
    cell_id = cell[:, 0] * n_cells_y + cell[:, 1]

    candidate = (
        np.isin(seg_pred, classes_present)
        & (confidence > conf_thresh)
        & (seg_pred >= 0)
    )
    if require_disagreement:
        candidate &= sam_label != seg_pred
    idx = np.where(candidate)[0]
    if idx.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # group by (cell, predicted class); keep the max-confidence member
    key = cell_id[idx] * 64 + seg_pred[idx]
    order = np.lexsort((confidence[idx], key))
    idx_sorted = idx[order]
    key_sorted = key[order]
    last_of_group = np.ones(len(idx_sorted), bool)
    last_of_group[:-1] = key_sorted[1:] != key_sorted[:-1]
    chosen = idx_sorted[last_of_group]
    return chosen, seg_pred[chosen].astype(np.int64)


def radius_prompt_search(
    coord: np.ndarray,  # (N, 3)
    seg_pred: np.ndarray,  # (N,)
    confidence: np.ndarray,  # (N,)
    sam_label: np.ndarray,  # (N,)
    classes_present: np.ndarray,
    radius_scale: float = 0.33,
    conf_thresh: float = 0.95,
):
    """Radius-based prompt mining (the reference's ablation variant,
    train_sam_final_radius.py:351-379): per present class, greedily pick
    the max-confidence incognita candidate and suppress all candidates
    within ``radius_scale`` meters of it, until none remain.
    Returns (prompt_idx (P,), prompt_cls (P,))."""
    prompt_idx, prompt_cls = [], []
    for cidx in classes_present:
        cand = (
            (seg_pred == cidx)
            & (sam_label != cidx)
            & (confidence > conf_thresh)
        )
        cand_idx = np.where(cand)[0]
        conf = confidence[cand_idx].copy()
        alive = np.ones(cand_idx.size, bool)
        while alive.any():
            best = np.argmax(np.where(alive, conf, -1.0))
            prompt_idx.append(cand_idx[best])
            prompt_cls.append(cidx)
            d = np.linalg.norm(
                coord[cand_idx] - coord[cand_idx[best]], axis=1
            )
            alive &= d > radius_scale
    return (
        np.asarray(prompt_idx, np.int64),
        np.asarray(prompt_cls, np.int64),
    )


def vote_masks_for_frame(
    masks: np.ndarray,  # (P, H, W) bool, mask 0 of the multimask output
    prompt_cls: np.ndarray,  # (P,)
    bridge: np.ndarray,  # (N, 3) [u, v, visible]
    seg_pred: np.ndarray,  # (N,)
    confidence: np.ndarray,  # (N,)
    vote: np.ndarray,  # (N, C) accumulator, updated in place
    conf_thresh: float = 0.9,
):
    """Reference :454-475: restrict each mask to bridge-visible points;
    verify the mask's class equals the mode of high-confidence predictions
    inside it; vote."""
    vis_idx = np.where(bridge[:, 2] == 1)[0]
    if vis_idx.size == 0:
        return
    u = bridge[vis_idx, 0].astype(np.int64) - 1
    v = bridge[vis_idx, 1].astype(np.int64) - 1
    n_cls = vote.shape[1]
    for pi in range(masks.shape[0]):
        inside = masks[pi, v, u]
        members = vis_idx[inside]
        if members.size == 0:
            continue
        conf_m = confidence[members]
        high = conf_m > conf_thresh
        if high.sum() == 0:
            continue
        # plurality class of the high-confidence members (bincount argmax
        # == scipy.stats.mode incl. smallest-on-ties, far cheaper)
        mode_cls = np.argmax(
            np.bincount(seg_pred[members][high], minlength=n_cls)
        )
        if mode_cls == prompt_cls[pi]:
            vote[members, prompt_cls[pi]] += 1


def _refine_one_scene(args):
    """Refine ONE scene's labels (reference train_sam_real.py:314-520):
    prompt mining -> batched SAM decode -> vote/verify -> label rewrite.
    Module-level and self-contained so the oracle path can fan scenes out
    over a process pool (each scene owns its label file). Returns
    (count_updated, prompt_accuracy, prompts mined, masks decoded): the
    first two are ao_tpu's whole return value."""
    cfg, predictor, scene_key, seg_logit = args
    from scipy.special import softmax

    area, room = scene_key.split("/") if "/" in scene_key else (
        scene_key.split("_")[0] + "_" + scene_key.split("_")[1],
        "_".join(scene_key.split("_")[2:]),
    )
    label_path = os.path.join(cfg["labels_dir"], area, room + ".npy")
    if not os.path.isfile(label_path):
        return 0, 0.0, 0, 0
    sam_label = np.load(label_path).reshape(-1)

    seg_pred = np.argmax(seg_logit, axis=1)
    seg_pred[seg_logit[:, 0] == -100] = -1
    probs = softmax(seg_logit, axis=1)
    top_two = np.sort(probs, axis=1)[:, -2:]
    confidence = top_two[:, 1] - top_two[:, 0]

    scene = None
    for ext in (".pth", ".npz"):
        p = os.path.join(cfg["data_root"], area, room + ext)
        if os.path.isfile(p):
            scene = load_scene(p)
            break
    if scene is None:
        return 0, 0.0, 0, 0
    coord = np.asarray(scene["coord"], np.float32)
    gt = np.asarray(scene["semantic_gt"], np.int64).reshape(-1)
    classes_present = np.unique(gt[gt >= 0])

    if cfg["prompt_search"] == "radius":
        prompt_idx, prompt_cls = radius_prompt_search(
            coord, seg_pred, confidence, sam_label, classes_present,
            cfg["radius_scale"], cfg["conf_thresh"],
        )
    elif cfg["prompt_search"] == "grid_query_abl":
        prompt_idx, prompt_cls = grid_prompt_search(
            coord, seg_pred, confidence, sam_label, classes_present,
            grid_scale=cfg["grid_scale"], conf_thresh=cfg["conf_thresh"],
            require_disagreement=False,
        )
    else:
        prompt_idx, prompt_cls = grid_prompt_search(
            coord, seg_pred, confidence, sam_label, classes_present,
            cfg["grid_scale"], cfg["conf_thresh"],
        )
    if prompt_idx.size == 0:
        return 0, 0.0, 0, 0
    prompt_acc = (gt[prompt_idx] == prompt_cls).sum() / prompt_idx.size

    vote = np.zeros((coord.shape[0], cfg["num_classes"]), np.int32)
    updated = False
    bridge_paths = sorted(
        glob.glob(os.path.join(cfg["bridge_root"], area, room, "*.npy"))
    )
    # Stage 1: collect every frame's visible prompts (host-only).
    tasks = []  # (emb_path, bridge, pts (k, 2), cls (k,))
    for bridge_path in bridge_paths:
        frame = os.path.splitext(os.path.basename(bridge_path))[0]
        emb_path = None
        for ext in (".npz", ".pth"):
            p = os.path.join(cfg["embedding_root"], area, room, frame + ext)
            if os.path.isfile(p):
                emb_path = p
                break
        if emb_path is None:
            continue
        bridge = np.load(bridge_path)
        visible = bridge[:, 2] == 1
        prompt_visible = visible[prompt_idx]
        if prompt_visible.sum() == 0:
            continue
        pts = bridge[prompt_idx[prompt_visible], :2].astype(np.float32)
        tasks.append((emb_path, bridge, pts, prompt_cls[prompt_visible]))

    # Stage 2: SAM decodes batched ACROSS frames (SURVEY hard-part #5;
    # the reference runs set_features + predict per frame,
    # train_sam_real.py:402-450). Prompt counts pad to power-of-2
    # buckets, as in ao_tpu: the -1 pad prompts are part of what the
    # decoder sees.
    FG = cfg["sam_frame_batch"]
    n_masks = 0
    for i0 in range(0, len(tasks), FG):
        group = tasks[i0: i0 + FG]
        updated = True
        pmax = max(len(t[2]) for t in group)
        pmax = max(8, 1 << (pmax - 1).bit_length())
        F = len(group)
        embs = np.stack(
            [RealTrainer._frame_embedding(t[0]) for t in group]
        )
        pts = np.zeros((F, pmax, 1, 2), np.float32)
        lbl = -np.ones((F, pmax, 1), np.int32)  # -1 = padding prompt
        for f, (_, _, p, _) in enumerate(group):
            pts[f, : len(p), 0] = p
            lbl[f, : len(p)] = 1
        masks, _ = predictor.predict_batch(
            embs, pts, lbl, tuple(cfg["frame_size"]), mask_index=0
        )
        n_masks += sum(len(t[2]) for t in group)
        for f, (_, bridge, p, cls) in enumerate(group):
            vote_masks_for_frame(
                masks[f, : len(p), 0], cls, bridge, seg_pred,
                confidence, vote, cfg["conf_thresh"],
            )

    count_updated = 0
    if updated:
        sam_result = np.argmax(vote, axis=1)
        vote_max = vote.max(axis=1)
        # load-bearing even with the evidence gates below: a 0/0
        # vote_min_fill/overwrite config would otherwise admit
        # zero-vote points as argmax-class (= class 0) labels
        sam_result[vote_max == 0] = -1
        reject = (sam_result != seg_pred) | (seg_pred == -1)
        sam_result[reject] = -1
        # cross-frame evidence gates (defaults 1/1 = reference :488-512)
        unlabeled = sam_label == -1
        sam_result[unlabeled & (vote_max < cfg["vote_min_fill"])] = -1
        sam_result[~unlabeled & (vote_max < cfg["vote_min_overwrite"])] = -1
        valid = sam_result != -1
        count_updated = int((sam_label[valid] != sam_result[valid]).sum())
        sam_label[valid] = sam_result[valid]
        np.save(label_path, sam_label.reshape(-1, 1))
    return count_updated, float(prompt_acc), int(prompt_idx.size), n_masks


class RealTrainer(Trainer):
    """Trainer with per-epoch SAM label refinement."""

    def __init__(self, cfg, device="cuda"):
        # point the weak-label path at a mutable copy inside the experiment
        # dir (reference :620-621) BEFORE loaders are built
        real_cfg = dict(cfg.get("real", {}))
        self.real_cfg = real_cfg
        labels_src = real_cfg.get("initial_labels", "data/sam_labels")
        self.labels_dir = os.path.join(cfg.save_path, "sam_labels_on_the_fly")
        # A fresh (non-resume) run must start from pristine initial labels:
        # the refinement loop mutates this directory in place, so reusing a
        # leftover copy from an earlier run silently trains on whatever
        # state that run's refinement left behind (r4 postmortem: a stale
        # dir with 615 floor labels instead of 183k collapsed the class
        # from epoch 1). Only a resumed run keeps the mutated labels.
        if os.path.isdir(labels_src):
            if os.path.isdir(self.labels_dir) and not cfg.get("resume"):
                shutil.rmtree(self.labels_dir)
            if not os.path.isdir(self.labels_dir):
                shutil.copytree(labels_src, self.labels_dir)
        cfg.data.train.weak = True
        cfg.data.train.mode = "real"
        cfg.data.train.weak_path = self.labels_dir
        super().__init__(cfg, device=device)

        self.num_classes = cfg.data.num_classes
        self.basket_path = real_cfg.get("basket", "data/basket_s3dis.pickle")
        self.basket: Dict[str, np.ndarray] = load_basket(self.basket_path)
        self.data_root = real_cfg.get("data_root", "data/s3dis")
        self.bridge_root = real_cfg.get("bridge_root", "data/bridge")
        self.embedding_root = real_cfg.get("embedding_root", "data/embeddings")
        self.frame_size = tuple(real_cfg.get("frame_size", (1080, 1080)))
        self.grid_scale = real_cfg.get("grid_scale", 0.5)
        # "grid" (release) or "radius" (the reference's
        # train_sam_final_radius.py ablation)
        self.prompt_search = real_cfg.get("prompt_search", "grid")
        # The ablation modes default to the reference's 0.95 threshold
        # (train_sam_final_radius.py / _query_abl.py); an explicitly
        # configured conf_thresh always wins, never clamped.
        default_thresh = (
            0.95 if self.prompt_search in ("radius", "grid_query_abl") else 0.9
        )
        self.conf_thresh = real_cfg.get("conf_thresh", default_thresh)
        self.radius_scale = real_cfg.get("radius_scale", 0.33)
        # frames decoded per batched SAM call during refinement
        self.sam_frame_batch = int(real_cfg.get("sam_frame_batch", 4))
        # Cross-frame evidence gates on the label rewrite. The reference
        # accepts any nonzero vote (train_sam_real.py:488-512) — that is
        # the default (1/1). With few views per scene (the rendered-frame
        # proxy has 6 vs S2D3D's hundreds) a single verified-but-wrong
        # mask can overwrite oracle-correct labels and the per-round
        # quality curve erodes; requiring >= vote_min_overwrite agreeing
        # frames to *change* an existing label (filling unlabeled points
        # still takes vote_min_fill) keeps each round net-positive.
        # clamped to >=1: a 0 gate would rely solely on the vote_max==0
        # clear above to keep zero-vote points out of the argmax labels
        self.vote_min_fill = max(1, int(real_cfg.get("vote_min_fill", 1)))
        self.vote_min_overwrite = max(
            1, int(real_cfg.get("vote_min_overwrite", 1)))
        self.eval_areas = tuple(real_cfg.get("eval_areas", ("Area_1",)))
        # one record per refinement round: the sam_label/* metrics and
        # the round's wall seconds
        self.refine_history: List[Dict[str, float]] = []

        self._predictor = None

    @property
    def predictor(self):
        if self._predictor is None and comm.is_main_process():
            if self.real_cfg.get("sam_oracle"):
                # GT-instance oracle masks (models/sam/oracle.py) — the
                # embedding cache must hold id maps (pp2s sam_oracle mode)
                from ..models.sam import OracleSamPredictor

                self._predictor = OracleSamPredictor(
                    quality=self.real_cfg.get("oracle_quality", 0.7)
                )
            else:
                from ..models.sam import (
                    SamConfig, SamPredictor, load_sam_checkpoint,
                )

                model_type = self.real_cfg.get("sam_model_type", "vit_h")
                cfg = getattr(SamConfig, model_type.replace("-", "_"))()
                ckpt = self.real_cfg.get("sam_checkpoint")
                state_dict = load_sam_checkpoint(ckpt) if ckpt else None
                self._predictor = SamPredictor(cfg, state_dict,
                                               device=self.device)
        return self._predictor

    def set_predictor(self, predictor):
        """Inject a predictor (tests use the tiny SAM)."""
        self._predictor = predictor

    # -- hot loop: also harvest logits into the basket --
    def train_step(self, batch):
        """The port's train step; returns (metrics, the step's logits
        (B, N, C), detached, on the device)."""
        return self._step(batch)

    def run_step(self, batch):
        lr = self.optimizer.param_groups[0]["lr"]
        metrics, logits = self.train_step(batch)
        self._record(batch, metrics, lr)  # waits for the step
        t = time.perf_counter()
        self.fill_basket(batch, logits)
        self.history[-1]["basket_seconds"] = time.perf_counter() - t

    def fill_basket(self, batch, logits):
        """Basket fill (reference :231-234): each scene's logits by
        original row, over the sample's valid points. One copy of the
        (B, N, C) logits to the host a step. Prefer scene_id (the full
        file path) over name (room basename only): room names repeat
        across areas, and the endswith fallback in _scene_key would
        silently route e.g. Area_2/hallway_4 logits into
        Area_1/hallway_4's basket."""
        extras = batch.get("extras", {})
        names = extras.get("scene_id") or extras.get("name")
        if names is None:
            return
        logits_np = logits.float().cpu().numpy()
        host_mask = np.asarray(batch["mask"])
        host_instance = np.asarray(batch["instance"])
        for b, name in enumerate(names):
            key = self._scene_key(name)
            if key not in self.basket:
                continue
            valid = host_mask[b]
            ori = host_instance[b][valid]
            self.basket[key][ori] = logits_np[b][valid]

    def _scene_key(self, name: str) -> str:
        if name in self.basket:
            return name
        if os.sep in name:
            # a file path: <root>/<area>/<room>.<ext> -> "<area>/<room>"
            area = os.path.basename(os.path.dirname(name))
            room = os.path.splitext(os.path.basename(name))[0]
            key = f"{area}/{room}"
            if key in self.basket:
                return key
        for key in self.basket:
            if key.endswith("/" + name) or key == name:
                return key
        return name

    # -- epoch-boundary refinement --
    def after_epoch(self):
        super().after_epoch()
        merged = comm.gather(self.basket, dst=0)
        if comm.is_main_process():
            basket = self.basket
            for other in merged[1:]:
                for k, v in other.items():
                    mask = v[:, 0] != -100
                    basket[k][mask] = v[mask]
            self.refine_labels(basket)
        comm.synchronize()
        self.basket = load_basket(self.basket_path)

    def _refine_cfg(self) -> dict:
        return dict(
            labels_dir=self.labels_dir,
            data_root=self.data_root,
            bridge_root=self.bridge_root,
            embedding_root=self.embedding_root,
            frame_size=self.frame_size,
            grid_scale=self.grid_scale,
            prompt_search=self.prompt_search,
            conf_thresh=self.conf_thresh,
            radius_scale=self.radius_scale,
            sam_frame_batch=self.sam_frame_batch,
            num_classes=self.num_classes,
            vote_min_fill=self.vote_min_fill,
            vote_min_overwrite=self.vote_min_overwrite,
        )

    def refine_labels(self, basket: Dict[str, np.ndarray]):
        t0 = time.perf_counter()
        cfg = self._refine_cfg()
        predictor = self.predictor
        n_scenes = max(len(basket), 1)
        # The oracle predictor is stateless and picklable — refine scenes
        # in a fork pool (each scene touches only its own label file; the
        # workers run numpy only, never the card). The neural predictor
        # owns the SAM model on the card: stay in-process.
        workers = int(self.real_cfg.get(
            "refine_workers", min(8, os.cpu_count() or 1)
        ))
        from ..models.sam.oracle import OracleSamPredictor

        if workers > 1 and isinstance(predictor, OracleSamPredictor):
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(
                max_workers=workers, mp_context=mp.get_context("fork")
            ) as pool:
                results = list(pool.map(
                    _refine_one_scene,
                    [(cfg, predictor, k, v) for k, v in basket.items()],
                    chunksize=1,
                ))
        else:
            results = [
                _refine_one_scene((cfg, predictor, k, v))
                for k, v in basket.items()
            ]
        count_updated = sum(r[0] for r in results)
        prompt_accuracy = sum(r[1] for r in results) / n_scenes

        metrics = get_miou(
            self.labels_dir, self.data_root, self.num_classes,
            areas=self.eval_areas,
        )
        if self.writer is not None:
            ep = self.epoch + 1
            self.writer.add_scalar("sam_label/mIoU", metrics["mIoU"], ep)
            self.writer.add_scalar("sam_label/mPre", metrics["mPrecision"], ep)
            self.writer.add_scalar("sam_label/mRec", metrics["mRecall"], ep)
            self.writer.add_scalar(
                "sam_label/num_updated", count_updated / n_scenes, ep
            )
            self.writer.add_scalar(
                "sam_label/prompt_accuracy", prompt_accuracy, ep
            )
        self.refine_history.append(dict(
            epoch=self.epoch + 1, mIoU=metrics["mIoU"],
            mPre=metrics["mPrecision"], mRec=metrics["mRecall"],
            num_updated=count_updated, prompt_accuracy=prompt_accuracy,
            prompts=sum(r[2] for r in results),
            masks=sum(r[3] for r in results),
            seconds=time.perf_counter() - t0))
        self.logger.info(
            f"REAL refinement: label mIoU {metrics['mIoU']:.4f} "
            f"mPre {metrics['mPrecision']:.4f} mRec {metrics['mRecall']:.4f} "
            f"updated {count_updated} prompts_acc {prompt_accuracy:.4f} "
            f"prompts {self.refine_history[-1]['prompts']} masks "
            f"{self.refine_history[-1]['masks']} "
            f"({self.refine_history[-1]['seconds']:.2f} s)"
        )

    @staticmethod
    def _load_embedding(path: str):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z["features"]
        import torch

        return torch.load(path, map_location="cpu", weights_only=False).numpy()

    @classmethod
    def _frame_embedding(cls, path: str):
        """One frame's embedding without the cached leading batch dim."""
        emb = np.asarray(cls._load_embedding(path))
        return np.squeeze(emb, axis=0) if emb.ndim == 4 else emb
