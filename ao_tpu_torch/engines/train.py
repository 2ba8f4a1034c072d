"""Semantic-segmentation training on one device (port of TrainerBase and
Trainer of ao_tpu/engines/train.py).

``TrainerBase`` is the hook lifecycle (reference: pointcept/engines/
train.py:34-111): before_train, then for every (mega-)epoch before_epoch,
``run_epoch`` (before_step, ``run_step``, after_step per batch) and
after_epoch, then after_train; hooks come from ``cfg.hooks``
(configs/_base_/default_runtime.py: CheckpointLoader, IterationTimer,
InformationWriter, SemSegEvaluator, CheckpointSaver).

One train step: forward in train mode (batch-statistic BatchNorms,
stochastic depth; the batch's ``discrete_coord``, when it has one, goes to
the model with coord, feat and mask), the configured criteria over the
valid points (or, for a model that owns its loss, such as CAC, whose
``forward`` takes ``segment``: the loss it returns, with its terms),
backward, ``optimizer.step()`` and a per-step ``scheduler.step()``. It
reports the metrics ``loss`` (and the model's ``*_loss`` terms),
``pool_overflow`` (clusters beyond the grid pools' static
capacities; 0 when they suffice) and ``grad_norm`` (the L2 norm of all
gradients; finite iff every gradient is), read back to the host once a
step. ``cfg.max_steps`` (optional) stops training after that many steps;
the epoch it ends still runs its after_epoch hooks (evaluation, saving).
``eval_batch`` scores one validation batch for the evaluator, on the
grid-sampled points or, when the batch carries ``origin_coord`` /
``origin_segment``, on the full-resolution points.

The train loader collates with Mix3D (``cfg.mix_prob``,
``point_collate_fn``); the mix draw comes from the loader's generator
(with workers, from each worker's default generator, which the loader
seeds from its own). The config's top-level ``param_dicts`` become the
optimizer's parameter groups, as in Pointcept's trainer (the JAX
package's Trainer hands only ``cfg.optimizer`` on and drops them).

Data parallelism (under a process group, ``engines/launch.py``): as the
JAX package shards the global batch over its data mesh axis, each process
takes ``batch_size // world`` scenes a step (and ``num_worker // world``
loader workers) from a ``DistributedSampler`` seeded by the run's seed,
which splits each epoch's permutation by rank (``drop_last``; its epoch set
every epoch); the validation scenes are split as ``[rank::world]``. The
initial parameters and buffers are broadcast from process 0. The loss is
the global batch's: every criterion divides by the global denominator
(``models/losses/misc.py``), so that a process's loss is its share and the
step sums the processes' gradients and metrics (the loss and its terms,
``pool_overflow``) in one bucketed ``all_reduce`` after the backward; every
BatchNorm takes the global batch's statistics (``models/utils.py``,
``ops/gva.py``). Only process 0 writes the log file, TensorBoard and
checkpoints; the state dict keeps the reference's names (no wrapper).
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..datasets import build_dataset, point_collate_fn
from ..models import build_criteria, build_model
from ..models.utils import DropPath, Dropout
from ..ops.knn import knn
from ..utils import comm, get_root_logger, intersection_and_union, tracing
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.env import set_seed
from ..utils.events import EventStorage, TensorboardWriter
from ..utils.misc import intersection_and_union_torch
from ..utils.optimizer import build_optimizer
from ..utils.scheduler import build_scheduler
from ..utils.timer import Timer
from .hooks import HookBase, build_hooks

# score-matrix elements of one chunk of the evaluator's exact 1-NN
_NN_CHUNK_ELEMENTS = 2**26


def train_sampler(dataset, world, rank, seed):
    """This process's sampler of the train set under a process group of
    ``world`` processes: each epoch's permutation (seeded by ``seed`` and
    the epoch, ``set_epoch``) split by rank, the tail that does not divide
    dropped; None in one process (the loader shuffles itself)."""
    if world == 1:
        return None
    return torch.utils.data.DistributedSampler(
        dataset, num_replicas=world, rank=rank, shuffle=True, seed=seed,
        drop_last=True)


class TrainerBase:
    """Hook lifecycle (reference: train.py:34-111)."""

    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.best_metric_value = -1e9
        self.comm_info: Dict[str, Any] = {}
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks_cfg):
        hooks = build_hooks(hooks_cfg)
        for h in hooks:
            if not isinstance(h, HookBase):
                raise TypeError(f"{type(h).__name__} is not a HookBase")
            h.trainer = self
        self.hooks = hooks

    def before_train(self):
        for h in self.hooks:
            h.before_train()

    def before_epoch(self):
        for h in self.hooks:
            h.before_epoch()

    def before_step(self):
        for h in self.hooks:
            h.before_step()

    def after_step(self):
        for h in self.hooks:
            h.after_step()

    def after_epoch(self):
        for h in self.hooks:
            h.after_epoch()

    def after_train(self):
        if "current_metric_value" in self.comm_info and (
                self.comm_info["current_metric_value"] > self.best_metric_value):
            self.best_metric_value = self.comm_info["current_metric_value"]
        for h in self.hooks:
            h.after_train()

    def finished(self) -> bool:
        """True once training should stop before the next epoch."""
        return False

    def train(self):
        with EventStorage() as self.storage:
            self.before_train()
            for self.epoch in range(self.start_epoch, self.max_epoch):
                if self.finished():
                    break
                self.before_epoch()
                self.run_epoch()
                self.after_epoch()
            self.after_train()

    def run_epoch(self):
        raise NotImplementedError


class Trainer(TrainerBase):
    """Builds model, criteria, loaders, optimizer, scheduler and hooks from
    ``cfg`` and trains on ``device``."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_path = cfg.save_path
        os.makedirs(os.path.join(self.save_path, "model"), exist_ok=True)
        self.logger = get_root_logger(
            log_file=os.path.join(self.save_path, "train.log"))
        self.seed = set_seed(cfg.get("seed"))
        self.world, self.rank = comm.get_world_size(), comm.get_rank()
        self.logger.info(f"Save path: {self.save_path}; device {self.device}"
                         f"; {self.world} process(es)")

        self.model = build_model(dict(cfg.model)).to(self.device)
        comm.broadcast_(list(self.model.parameters())
                        + list(self.model.buffers()))
        self.criteria = build_criteria(cfg.model.get("criteria", []))
        # stochastic depth and attention dropout draw on the device, from
        # one seeded generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed + self.rank)
        for m in self.model.modules():
            if isinstance(m, (DropPath, Dropout)):
                m.generator = self.generator
        self.logger.info(
            f"Num params: {sum(p.numel() for p in self.model.parameters())}")

        self.train_loader = self.build_train_loader()
        self.val_loader = self.build_val_loader()
        self.max_epoch = cfg.eval_epoch
        self.total_steps = len(self.train_loader) * self.max_epoch
        self.max_steps = min(cfg.get("max_steps") or self.total_steps,
                             self.total_steps)
        self.optimizer = build_optimizer(cfg.optimizer, self.model,
                                         cfg.get("param_dicts"))
        self.scheduler = build_scheduler(cfg.scheduler, self.optimizer,
                                         self.total_steps)
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.writer = (TensorboardWriter(self.save_path)
                       if cfg.get("enable_tensorboard", True)
                       and comm.is_main_process() else None)
        self.register_hooks(cfg.get("hooks"))

    def _collate(self, mix_prob=0.0, generator=None):
        """The loaders' collate: Mix3D at ``mix_prob``, its draw from
        ``generator``."""
        cfg = self.cfg
        return functools.partial(
            point_collate_fn, mix_prob=mix_prob, generator=generator,
            pad_multiple=cfg.get("pad_multiple", 4096),
            max_points=cfg.get("max_points"),
            ignore_index=cfg.data.get("ignore_index", -1))

    def _workers(self):
        return min(self.cfg.get("num_worker", 0) // self.world,
                   os.cpu_count() or 1)

    def build_train_loader(self):
        dataset = build_dataset(self.cfg.data.train)
        g = torch.Generator()
        g.manual_seed(self.seed + self.rank)
        workers = self._workers()
        # a worker collates with its default generator, seeded by the
        # loader from g; in-process collation draws from g itself
        collate = self._collate(self.cfg.get("mix_prob", 0.0),
                                None if workers else g)
        sampler = train_sampler(dataset, self.world, self.rank, self.seed)
        return torch.utils.data.DataLoader(
            dataset, batch_size=self.cfg.batch_size // self.world,
            shuffle=sampler is None, sampler=sampler, generator=g,
            drop_last=True, num_workers=workers, collate_fn=collate,
            pin_memory=self.device.type == "cuda")

    def build_val_loader(self):
        cfg = self.cfg
        if not cfg.get("evaluate", True) or "val" not in cfg.data:
            return None
        dataset = build_dataset(cfg.data.val)
        return torch.utils.data.DataLoader(
            dataset, batch_size=cfg.get("batch_size_val") or 1,
            sampler=range(self.rank, len(dataset), self.world),
            drop_last=False, num_workers=self._workers(),
            collate_fn=self._collate(), pin_memory=self.device.type == "cuda")

    def _to_device(self, batch):
        """(the model's inputs: coord, feat, mask and, when the batch carries
        it, discrete_coord; the target), on the device. The target is the
        batch's ``segment`` or, where it has none (classification), its
        ``category``; a batch with both (part segmentation) also hands its
        ``category`` to a model that takes it (``takes_category``)."""
        keys = ["coord", "feat", "mask", "discrete_coord"]
        if "segment" in batch and getattr(self.model, "takes_category", False):
            keys.append("category")
        inputs = {k: batch[k].to(self.device, non_blocking=True)
                  for k in keys if k in batch}
        target = batch["segment"] if "segment" in batch else batch["category"]
        return inputs, target.to(self.device, non_blocking=True)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a collated batch; returns the metrics as
        device tensors."""
        return self._step(batch)[0]

    @property
    def _takes_segment(self) -> bool:
        """True for a model that owns its loss (its forward takes
        ``segment``)."""
        return "segment" in inspect.signature(self.model.forward).parameters

    def _forward(self, inputs, segment):
        """(loss, logits (B, N, C), or (B, C) for a classifier, the loss's
        terms) of the model on one batch. A model that owns its loss
        (``forward`` takes ``segment``) returns a dict: its ``loss``, its
        ``seg_logits`` and every ``*_loss`` term; otherwise the criteria
        score the logits, over the valid points where they are per point."""
        segment = segment.long()
        if not self._takes_segment:
            logits = self.model(**inputs)
            mask = inputs["mask"] if logits.dim() == 3 else None
            return self.criteria(logits, segment, mask), logits, {}
        out = self.model(**inputs, segment=segment)
        terms = {k: v.detach() for k, v in out.items() if k.endswith("_loss")}
        return out["loss"], out["seg_logits"], terms

    def _loss(self, batch):
        """(loss, the step's logits, the loss's terms) of a batch in train
        mode."""
        return self._forward(*self._to_device(batch))

    def _step(self, batch):
        """One optimizer step; returns (the metrics as device tensors, the
        step's logits, detached). Its three phases are spans
        (utils/tracing.py): ``step/forward`` (the copies to the device, the
        forward, the loss), ``step/backward`` (with the reduction across
        processes) and ``step/optimizer`` (the gradient norm, the optimizer
        and the schedule)."""
        self.model.train()
        # the losses' denominators are global
        with tracing.span("step/forward"), comm.global_batch():
            loss, logits, terms = self._loss(batch)
        with tracing.span("step/backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            metrics = dict(loss=loss.detach(), **terms,
                           pool_overflow=self.model.backbone.pool_overflow)
            if comm.is_distributed():
                metrics = self._reduce(metrics)
        with tracing.span("step/optimizer"):
            grad_norm = torch.nn.utils.get_total_norm(
                [p.grad for p in self.model.parameters() if p.grad is not None])
            self.optimizer.step()
            self.scheduler.step()
        metrics["grad_norm"] = grad_norm
        return metrics, None if logits is None else logits.detach()

    def _reduce(self, metrics):
        """Sum every process's gradients and metrics in one bucketed
        ``all_reduce`` (a parameter without a gradient here contributes
        zeros, and has one after it). Returns the summed metrics."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        names = list(metrics)
        vals = [torch.as_tensor(metrics[k], device=self.device).float()
                for k in names]
        flat = comm.all_reduce(torch.cat(
            [p.grad.reshape(-1).float() for p in params]
            + [v.reshape(1) for v in vals]))
        o = 0
        for p in params:
            p.grad.copy_(flat[o:o + p.numel()].view_as(p.grad))
            o += p.numel()
        return {k: flat[o + i] for i, k in enumerate(names)}

    def finished(self) -> bool:
        return self.step >= self.max_steps

    def run_epoch(self):
        sampler = self.train_loader.sampler
        if hasattr(sampler, "set_epoch"):  # each epoch its own permutation
            sampler.set_epoch(self.epoch)
        timer = Timer()  # the data wait, then the step
        for i, batch in enumerate(self.train_loader):
            self.comm_info["data_seconds"] = timer.seconds()
            self.comm_info["iter"] = i
            self.before_step()
            timer.reset()
            self.run_step(batch)
            self.history[-1]["step_seconds"] = timer.seconds()
            self.after_step()
            self.storage.step()
            if self.finished():
                break
            timer.reset()

    def run_step(self, batch):
        lr = self.optimizer.param_groups[0]["lr"]
        self._record(batch, self.train_step(batch), lr)

    def _record(self, batch, metrics, lr):
        """The step's metrics (read back: waits for the step) into
        ``comm_info`` and ``history``."""
        loss_dict = {k: float(v) for k, v in metrics.items()}  # waits for the step
        self.comm_info["loss_dict"] = loss_dict
        self.step += 1
        masks = self._masks(batch)
        self.history.append(dict(
            loss_dict, data_seconds=self.comm_info["data_seconds"], lr=lr,
            points=sum(int(m.sum()) for m in masks),
            scenes=int(masks[0].shape[0]), epoch=self.epoch))

    def _masks(self, batch):
        """The batch's (B, N) point masks."""
        return [batch["mask"]]

    def current_lr(self) -> float:
        """The learning rate of the last step taken."""
        if self.history:
            return self.history[-1]["lr"]
        return self.optimizer.param_groups[0]["lr"]

    @torch.no_grad()
    def eval_batch(self, batch):
        """(loss, intersection, union, target) of one validation batch: the
        loss over its valid points and the per-class IoU histograms (numpy)
        of its predictions (of a classifier: one prediction a scene against
        its category). When the batch carries ``origin_coord`` /
        ``origin_segment`` (under ``extras``), each scene's predictions on
        its grid-sampled points are carried to its full-resolution points
        by their exact nearest sampled point and scored there."""
        self.model.eval()
        inputs, segment = self._to_device(batch)
        coord, mask = inputs["coord"], inputs["mask"]
        loss, logits, _ = self._forward(inputs, segment)
        loss = float(loss)
        pred = logits.argmax(-1)
        K = self.cfg.data.num_classes
        ignore = self.cfg.data.get("ignore_index", -1)
        extras = batch.get("extras", {})
        if logits.dim() == 2:
            hist = intersection_and_union_torch(pred, segment, K, ignore)
            return (loss, *(h.cpu().numpy() for h in hist))
        if "origin_coord" not in extras:
            target = torch.where(mask, segment.long(), ignore)
            hist = intersection_and_union_torch(pred, target, K, ignore)
            return (loss, *(h.cpu().numpy() for h in hist))
        inter, union, target = np.zeros(K), np.zeros(K), np.zeros(K)
        for b, origin in enumerate(extras["origin_coord"]):
            sampled = coord[b][mask[b]]
            oc = torch.as_tensor(np.asarray(origin, np.float32),
                                 device=self.device)
            chunk = max(_NN_CHUNK_ELEMENTS // max(len(sampled), 1), 1)
            nn = torch.cat([knn(q[None], sampled[None], 1)[0][0, :, 0]
                            for q in oc.split(chunk)])
            full_pred = pred[b][mask[b]][nn.long()].cpu().numpy()
            i, u, t = intersection_and_union(
                full_pred, np.asarray(extras["origin_segment"][b]).reshape(-1),
                K, ignore)
            inter += i
            union += u
            target += t
        return loss, inter, union, target

    def save(self, path, epoch):
        """The port's checkpoint: model, optimizer and scheduler state, the
        number of completed epochs, the step and the best metric (written by
        process 0 only)."""
        if not comm.is_main_process():
            return
        save_checkpoint(path, dict(
            model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            epoch=epoch, step=self.step,
            best_metric_value=float(self.best_metric_value)))
        self.logger.info(f"Saved checkpoint: {path}")

    def resume(self, path):
        state = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.start_epoch, self.step = state["epoch"], state["step"]
        self.best_metric_value = state.get("best_metric_value",
                                           self.best_metric_value)
        self.logger.info(f"Resumed from {path} at epoch {self.start_epoch}, "
                         f"step {self.step} (best {self.best_metric_value:.4f})")
