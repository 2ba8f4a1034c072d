"""Standard hooks (port of ao_tpu/engines/hooks/misc.py; reference:
pointcept/engines/hooks/misc.py).

IterationTimer, InformationWriter, CheckpointSaver and CheckpointLoader:
the hooks of configs/_base_/default_runtime.py. Not ported yet:
PreciseEvaluator, the profiler hooks and DataCacheOperator.
"""

from __future__ import annotations

import os
import shutil
import time

from ...utils.checkpoint import filter_state_dict
from .builder import HOOKS
from .default import HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    def __init__(self, warmup_iter=2):
        # warmup_iter: accepted for the configs' sake; the remaining-time
        # estimate averages the last 50 steps, as in the JAX package
        self._iter_timer = time.perf_counter()
        self._remain_iter = 0

    def before_train(self):
        self._remain_iter = self.trainer.max_epoch * len(self.trainer.train_loader)

    def before_epoch(self):
        self._iter_timer = time.perf_counter()

    def before_step(self):
        data_time = time.perf_counter() - self._iter_timer
        self.trainer.storage.put_scalar("data_time", data_time)

    def after_step(self):
        storage = self.trainer.storage
        batch_time = time.perf_counter() - self._iter_timer
        self._iter_timer = time.perf_counter()
        storage.put_scalar("batch_time", batch_time)
        self._remain_iter -= 1
        remain_time = self._remain_iter * storage.history("batch_time").avg(50)
        t_m, t_s = divmod(remain_time, 60)
        t_h, t_m = divmod(t_m, 60)
        self.trainer.comm_info["iter_info"] += (
            f"Data {storage.history('data_time').latest():.3f} "
            f"({storage.history('data_time').avg(50):.3f}) "
            f"Batch {batch_time:.3f} "
            f"({storage.history('batch_time').avg(50):.3f}) "
            f"Remain {int(t_h):02d}:{int(t_m):02d}:{int(t_s):02d} ")


@HOOKS.register_module()
class InformationWriter(HookBase):
    def __init__(self):
        self.curr_iter = 0

    def before_train(self):
        self.trainer.comm_info["iter_info"] = ""
        self.curr_iter = self.trainer.start_epoch * len(self.trainer.train_loader)

    def before_step(self):
        self.curr_iter += 1
        self.trainer.comm_info["iter_info"] += (
            f"Train: [{self.trainer.epoch + 1}/{self.trainer.max_epoch}]"
            f"[{self.trainer.comm_info['iter'] + 1}/"
            f"{len(self.trainer.train_loader)}] ")

    def after_step(self):
        trainer = self.trainer
        losses = trainer.comm_info.get("loss_dict", {})
        for key, value in losses.items():
            trainer.storage.put_scalar(key, value)
            trainer.comm_info["iter_info"] += f"{key}: {value:.4f} "
        lr = trainer.current_lr()
        trainer.comm_info["iter_info"] += f"Lr: {lr:.5f}"
        trainer.logger.info(trainer.comm_info["iter_info"])
        trainer.comm_info["iter_info"] = ""
        if trainer.writer is not None:
            trainer.writer.add_scalar("lr", lr, self.curr_iter)
            for key, value in losses.items():
                trainer.writer.add_scalar("train_batch/" + key, value,
                                          self.curr_iter)

    def after_epoch(self):
        trainer = self.trainer
        epoch_info = "Train result: "
        for key in trainer.comm_info.get("loss_dict", {}):
            avg = trainer.storage.history(key).avg(len(trainer.train_loader))
            epoch_info += f"{key}: {avg:.4f} "
            if trainer.writer is not None:
                trainer.writer.add_scalar("train/" + key, avg, trainer.epoch + 1)
        trainer.logger.info(epoch_info)


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """``model_last.pt`` written atomically after every epoch, then copied
    to ``model_best.pt`` when the current metric improves and to
    ``epoch_<n>.pt`` every ``save_freq`` epochs."""

    def __init__(self, save_freq=None):
        self.save_freq = save_freq

    def after_epoch(self):
        trainer = self.trainer
        is_best = False
        value = trainer.comm_info.get("current_metric_value", 0.0)
        name = trainer.comm_info.get("current_metric_name", "metric")
        if value > trainer.best_metric_value:
            trainer.best_metric_value = value
            is_best = True
            trainer.logger.info(f"Best validation {name} updated to {value:.4f}")
        trainer.logger.info(
            f"Currently Best {name}: {trainer.best_metric_value:.4f}")
        model_dir = os.path.join(trainer.save_path, "model")
        path = os.path.join(model_dir, "model_last.pt")
        trainer.save(path, epoch=trainer.epoch + 1)
        if is_best:
            shutil.copyfile(path, os.path.join(model_dir, "model_best.pt"))
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            shutil.copyfile(path, os.path.join(
                model_dir, f"epoch_{trainer.epoch + 1}.pt"))


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Loads ``cfg.weight`` before training. With ``cfg.resume`` it restores
    the port's own ``.pt`` (model, optimizer, scheduler, epoch, step, best
    metric; without ``cfg.weight`` the run's own ``model/model_last.pt``);
    otherwise it loads the model weights only (fine-tune) from a port
    ``.pt``, a JAX package ``.ckpt`` (flax msgpack) or ``.npz``, with the
    keys renamed by ``keywords`` -> ``replacement``."""

    def __init__(self, keywords="", replacement=None, strict=False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        from ..test import load_weights

        trainer = self.trainer
        weight = trainer.cfg.get("weight")
        if not weight and trainer.cfg.get("resume"):
            weight = os.path.join(trainer.save_path, "model", "model_last.pt")
        if not weight:
            return
        if not os.path.isfile(weight):
            raise FileNotFoundError(f"checkpoint not found: {weight}")
        trainer.logger.info(f"Loading checkpoint {weight}")
        if trainer.cfg.get("resume"):
            trainer.resume(weight)
            return
        state_dict = filter_state_dict(load_weights(weight),
                                       {self.keywords: self.replacement})
        missing, unexpected = trainer.model.load_state_dict(
            state_dict, strict=self.strict)
        trainer.logger.info(
            f"Loaded model weights (no optimizer state); missing keys "
            f"{missing}, unexpected keys {unexpected}")
