"""Standard hooks (port of ao_tpu/engines/hooks/misc.py; reference:
pointcept/engines/hooks/misc.py).

IterationTimer, InformationWriter, CheckpointSaver and CheckpointLoader:
the hooks of configs/_base_/default_runtime.py; PreciseEvaluator,
RuntimeProfiler and RuntimeProfilerV2, which some configs add;
DataCacheOperator, which fills the shared-memory scene cache. Under a
process group only process 0 writes files (checkpoints, the profilers'
traces); the others wait for it at the end of CheckpointSaver's epoch.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ...utils import comm
from ...utils.checkpoint import copy_best, filter_state_dict
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
        if comm.is_main_process():
            if is_best:
                copy_best(path, os.path.join(model_dir, "model_best.pt"))
            if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
                copy_best(path, os.path.join(
                    model_dir, f"epoch_{trainer.epoch + 1}.pt"))
        comm.synchronize()


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


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """After training, the config's tester (``cfg.test``: whole-scene TTA
    testing of ``data.test``) on the trainer's model, with the weights of
    ``model/model_best.pt`` unless ``test_last`` (reference
    hooks/misc.py:255-296)."""

    def __init__(self, test_last=False):
        self.test_last = test_last

    def after_train(self):
        from ..test import TEST, load_weights

        trainer = self.trainer
        trainer.logger.info(">>>>>>>>>>>>>>>> Start Precise Evaluation >>>>>>>>>>>>>>>>")
        best = os.path.join(trainer.save_path, "model", "model_best.pt")
        if not self.test_last and os.path.isfile(best):
            trainer.logger.info(f"Loading {best}")
            trainer.model.load_state_dict(load_weights(best))
        tester = TEST.build(dict(trainer.cfg.test, cfg=trainer.cfg,
                                 device=trainer.device, model=trainer.model))
        trainer.comm_info["precise_result"] = tester()


@HOOKS.register_module()
class RuntimeProfiler(HookBase):
    """torch.profiler over ``profile_steps`` train steps from iteration
    ``warm_up`` of an epoch (host, and the card's kernels on a card); the
    trace is written to ``<save_path>/profile/trace.json`` (reference
    torch.profiler hooks: misc.py:333-482)."""

    def __init__(self, warm_up=2, profile_steps=3):
        self.warm_up = warm_up
        self.profile_steps = profile_steps
        self._prof = None

    def before_step(self):
        trainer = self.trainer
        if self._prof is None and trainer.comm_info["iter"] == self.warm_up:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            trainer.logger.info(f"Profiling {self.profile_steps} steps")

    def after_step(self):
        if (self._prof is not None and self.trainer.comm_info["iter"]
                >= self.warm_up + self.profile_steps - 1):
            self._stop()

    def after_train(self):
        if self._prof is not None:  # training ended inside the window
            self._stop()

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if not comm.is_main_process():
            return
        trace_dir = os.path.join(self.trainer.save_path, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.trainer.logger.info(f"Profile written to {path}")


def _profile_activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@HOOKS.register_module()
class RuntimeProfilerV2(HookBase):
    """torch.profiler on its schedule (``torch.profiler.schedule(wait,
    warmup, active, repeat)``), stepped once a train step from the start of
    training: each of the ``repeat`` cycles waits ``wait`` steps, warms up
    ``warmup`` and records ``active``, whose trace is written under
    ``<save_path>/profile_v2`` as ``trace_<n>.json`` (process 0 only). With
    ``interrupt`` the run exits (``sys.exit(0)``) once the last cycle is
    written, as the JAX package's hook does (reference torch.profiler
    schedule hook: hooks/misc.py:412-482)."""

    def __init__(self, wait=1, warmup=1, active=2, repeat=1, interrupt=False):
        self.wait, self.warmup, self.active = wait, warmup, active
        self.repeat = repeat
        self.interrupt = interrupt
        self.traces = []
        self._prof = None

    def before_train(self):
        self._prof = torch.profiler.profile(
            activities=_profile_activities(self.trainer.device),
            schedule=torch.profiler.schedule(wait=self.wait, warmup=self.warmup,
                                             active=self.active,
                                             repeat=self.repeat),
            on_trace_ready=self._write)
        self._prof.__enter__()

    def after_step(self):
        if self._prof is not None:
            self._prof.step()
        if self.interrupt and len(self.traces) >= self.repeat:
            self.trainer.logger.info("RuntimeProfilerV2: interrupt, exiting")
            self._close()
            sys.exit(0)

    def after_train(self):
        self._close()

    def _close(self):
        prof, self._prof = self._prof, None
        if prof is not None:
            prof.__exit__(None, None, None)

    def _write(self, prof):
        """The profiler's ``on_trace_ready``: one trace file a cycle (None
        in ``traces`` on the processes that write none)."""
        n, path = len(self.traces) + 1, None
        if comm.is_main_process():
            trace_dir = os.path.join(self.trainer.save_path, "profile_v2")
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"trace_{n}.json")
            prof.export_chrome_trace(path)
        self.traces.append(path)
        self.trainer.logger.info(
            f"RuntimeProfilerV2: trace {n}/{self.repeat} done")


@HOOKS.register_module()
class DataCacheOperator(HookBase):
    """Fills the shared-memory scene cache (utils/cache.py) with every
    scene of the train set before training, one entry a scene under the
    name ``"ao-" + <path>``, stopping at ``mem_size_limit_gb`` of arrays
    (reference: hooks/misc.py:299-330). As in the JAX package the datasets
    take ``cache=`` and read their scenes from disk all the same, and a
    train set whose ``data_list`` does not hold paths (a ConcatDataset's
    holds (dataset, item) pairs) is left uncached. Every process runs it;
    an entry that another process filled first is read, not written
    again."""

    def __init__(self, data_root=None, mem_size_limit_gb=None):
        self.data_root = data_root
        self.mem_size_limit_gb = mem_size_limit_gb
        self.cached = []

    def before_train(self):
        from ...datasets.defaults import load_scene
        from ...utils.cache import shared_dict

        trainer = self.trainer
        data_list = getattr(trainer.train_loader.dataset, "data_list", [])
        if not data_list or not isinstance(data_list[0], str):
            return
        trainer.logger.info(f"=> Caching {len(data_list)} scenes to shm ...")
        total = 0
        for path in data_list:
            try:
                data = load_scene(path)
            except (OSError, ValueError, RuntimeError) as e:
                trainer.logger.warning(f"not cached: {path}: {e}")
                continue
            total += sum(getattr(v, "nbytes", 0) for v in data.values())
            if (self.mem_size_limit_gb
                    and total > self.mem_size_limit_gb * 1024**3):
                trainer.logger.warning("shm cache size limit reached")
                break
            shared_dict("ao-" + path, data)
            self.cached.append(path)
        trainer.logger.info("=> Done.")
