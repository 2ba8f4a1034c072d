"""Semantic-segmentation training on one device (port of the Trainer of
ao_tpu/engines/train.py).

One train step: forward in train mode (batch-statistic BatchNorms,
stochastic depth), the configured criteria over the valid points, backward,
``optimizer.step()`` and a per-step ``scheduler.step()``. It reports the
metrics ``loss``, ``pool_overflow`` (clusters beyond the grid pools' static
capacities; 0 when they suffice) and ``grad_norm`` (the L2 norm of all
gradients; finite iff every gradient is). The train loader shuffles with a
seeded generator and pads every batch to ``pad_multiple``. A checkpoint of
model, optimizer and scheduler state is written at the end of training;
``resume=True`` continues from it.

Not ported yet: the evaluator and the other hooks, Mix3D collation
(``mix_prob``), parameter groups, and data parallelism over several cards.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import torch

from ..datasets import build_dataset, collate_fn
from ..models import build_criteria, build_model
from ..models.utils import DropPath
from ..utils import get_root_logger
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.env import set_seed
from ..utils.optimizer import build_optimizer
from ..utils.scheduler import build_scheduler
from ..utils.timer import Timer


class Trainer:
    """Builds model, criteria, train loader, optimizer and scheduler from
    ``cfg`` and trains on ``device``. ``cfg.max_steps`` (optional) stops
    training after that many steps."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.save_path = cfg.save_path
        os.makedirs(os.path.join(self.save_path, "model"), exist_ok=True)
        self.logger = get_root_logger(
            log_file=os.path.join(self.save_path, "train.log"))
        if cfg.get("mix_prob", 0):
            raise NotImplementedError("Mix3D collation (mix_prob) is not ported")
        self.seed = set_seed(cfg.get("seed"))
        self.logger.info(f"Save path: {self.save_path}; device {self.device}")

        self.model = build_model(dict(cfg.model)).to(self.device)
        self.criteria = build_criteria(cfg.model.get("criteria", []))
        # stochastic depth draws on the device, from one seeded generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        for m in self.model.modules():
            if isinstance(m, DropPath):
                m.generator = self.generator
        self.logger.info(
            f"Num params: {sum(p.numel() for p in self.model.parameters())}")

        self.train_loader = self.build_train_loader()
        self.max_epoch = cfg.eval_epoch
        self.total_steps = len(self.train_loader) * self.max_epoch
        self.max_steps = min(cfg.get("max_steps") or self.total_steps,
                             self.total_steps)
        self.optimizer = build_optimizer(cfg.optimizer, self.model)
        self.scheduler = build_scheduler(cfg.scheduler, self.optimizer,
                                         self.total_steps)
        self.epoch = 0
        self.step = 0
        self.history: List[Dict[str, float]] = []
        if cfg.get("resume"):
            self.resume(os.path.join(self.save_path, "model", "model_last.pt"))

    def build_train_loader(self):
        cfg = self.cfg
        dataset = build_dataset(cfg.data.train)
        g = torch.Generator()
        g.manual_seed(self.seed)
        collate = functools.partial(
            collate_fn, pad_multiple=cfg.get("pad_multiple", 4096),
            max_points=cfg.get("max_points"),
            ignore_index=cfg.data.get("ignore_index", -1))
        workers = min(cfg.get("num_worker", 0), os.cpu_count() or 1)
        return torch.utils.data.DataLoader(
            dataset, batch_size=cfg.batch_size, shuffle=True, generator=g,
            drop_last=True, num_workers=workers, collate_fn=collate,
            pin_memory=self.device.type == "cuda")

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a collated batch; returns the metrics as
        device tensors."""
        self.model.train()
        dev = self.device
        coord, feat, mask, segment = (
            batch[k].to(dev, non_blocking=True)
            for k in ("coord", "feat", "mask", "segment"))
        logits = self.model(coord, feat, mask)
        loss = self.criteria(logits, segment.long(), mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in self.model.parameters() if p.grad is not None])
        self.optimizer.step()
        self.scheduler.step()
        return dict(loss=loss.detach(), grad_norm=grad_norm,
                    pool_overflow=self.model.backbone.pool_overflow)

    def run_epoch(self) -> bool:
        """One pass over the loader; False once ``max_steps`` is reached."""
        n = len(self.train_loader)
        timer = Timer()  # the data wait, then the step
        for i, batch in enumerate(self.train_loader):
            data_s = timer.seconds()
            timer.reset()
            lr = self.optimizer.param_groups[0]["lr"]
            metrics = self.train_step(batch)
            rec = {k: float(v) for k, v in metrics.items()}  # waits for the step
            rec.update(step_seconds=timer.seconds(), data_seconds=data_s,
                       lr=lr, points=int(batch["mask"].sum()))
            self.history.append(rec)
            self.step += 1
            self.logger.info(
                f"Train: [{self.epoch + 1}/{self.max_epoch}][{i + 1}/{n}] "
                f"loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4g} "
                f"pool_overflow {rec['pool_overflow']:.0f} lr {lr:.5g} "
                f"step {rec['step_seconds']:.3f}s data {rec['data_seconds']:.3f}s")
            timer.reset()
            if self.step >= self.max_steps:
                return False
        return True

    def train(self):
        while self.epoch < self.max_epoch:
            go_on = self.run_epoch()
            self.epoch += 1
            if not go_on:
                break
        self.save(os.path.join(self.save_path, "model", "model_last.pt"))
        return self.history

    def save(self, path):
        save_checkpoint(path, dict(
            model=self.model.state_dict(),
            optimizer=self.optimizer.state_dict(),
            scheduler=self.scheduler.state_dict(),
            epoch=self.epoch, step=self.step))
        self.logger.info(f"Saved checkpoint: {path}")

    def resume(self, path):
        state = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.epoch, self.step = state["epoch"], state["step"]
        self.logger.info(f"Resumed from {path} at epoch {self.epoch}, "
                         f"step {self.step}")
