"""Training cells: the port's Trainer on the trainer's own batches.

Set-up writes the traffic's rooms, builds ``ao_tpu_torch.engines.Trainer``
from the configuration's file (its DataLoader with the configuration's
transforms, workers and collation, its optimizer and schedule), loads the
weights made from the seed, and takes the first steps through
``Trainer.train_step`` on the loader's batches: they warm every kernel up
and are the steps the reference follows. The window then times
``train_step`` on the loader's next batches, each step ending in its loss's
read-back, until ``--seconds`` have passed:

* the traffic's ``rate_metric`` (``train_points_per_s``): valid points of
  the window's steps over the time from the window's start to the last
  step's read-back;
* ``peak_mem_gib``: the card's allocated peak over the window.

After the window the program is freed, and the reference steps the same
weights over the same first batches in float32 (see reference/steps.py).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

from gpubench.counts.ptv2m2 import forward_shape
from gpubench.harness.rooms import write_rooms
from gpubench.harness.trace import Spans, Trace
from gpubench.harness.weights import load_weights, make_weights
from gpubench.reference.steps import FirstOutput, reference_train, train_checks

GIB = 2**30


def config_seed(seed):
    """The configuration's seed (loader order, augmentation, the trainer's
    generator of stochastic depth) from the run's."""
    return int(np.random.SeedSequence([seed, 3]).generate_state(1)[0] % 2**31)


def build(run, workdir, device, overrides):
    """(trainer, the number of train steps its schedule spans: the rooms
    times the loop over the batch, times the configuration's epochs)."""
    from ao_tpu_torch.engines import Trainer, default_config_parser

    traffic = run.cell.traffic
    root, _ = write_rooms(os.path.join(workdir, "rooms"), traffic,
                          run.args.seed)
    options = {"save_path": os.path.join(workdir, "exp"),
               "data.train.data_root": root,
               "seed": config_seed(run.args.seed),
               "evaluate": False, "enable_tensorboard": False}
    options.update(traffic.get("options", {}))
    options.update(overrides)
    cfg = default_config_parser(run.cell.config_file, options)
    # one epoch outlasts set-up and the window, so that no epoch boundary
    # (the loader's workers starting again) falls inside it
    cfg.data.train.loop = int(traffic["loop"])
    trainer = Trainer(cfg, device=str(device))
    steps = (traffic["rooms"]["count"] * cfg.data.train.loop // cfg.batch_size
             * cfg.eval_epoch)
    return trainer, steps


def _adam_first_grads(trainer):
    """Each leaf's first gradient as the optimizer got it: AdamW's first
    moment after step 1 over 1 - beta1 (on the host)."""
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    return {n: trainer.optimizer.state[p]["exp_avg"].detach().float().cpu()
            / (1 - beta1)
            for n, p in trainer.model.named_parameters()
            if p in trainer.optimizer.state}


class Setup:
    """The trainer after its first steps, and what the check needs of them."""

    def __init__(self, run, workdir, device, overrides):
        traffic = run.cell.traffic
        self.trainer, self.total_steps = build(run, workdir, device, overrides)
        weights = make_weights(self.trainer.model, run.args.seed, device)
        load_weights(self.trainer.model, weights)
        self.weights = {n: w.cpu() for n, w in weights.items()}
        del weights
        self.cfg = self.trainer.cfg
        # the trainer seeds its generator of stochastic depth so (one
        # process: rank 0)
        self.drop_seed = config_seed(run.args.seed)
        self.loader = iter(self.trainer.train_loader)
        self.prog = dict(losses=[], grads={}, change={})
        self.batches = []  # the first steps' batches, as the loader made them
        for k in range(int(traffic["check_steps"])):
            batch = next(self.loader)
            self.batches.append(batch)
            if k == 0:
                model = self.trainer.model
                hooks = dict(
                    logits=FirstOutput(model, lambda out: out["seg_logits"]
                                       if isinstance(out, dict) else out),
                    embed=FirstOutput(model.backbone.patch_embed.blocks,
                                      lambda out: out[0]))
            self.prog["losses"].append(
                float(self.trainer.train_step(batch)["loss"]))
            if k == 0:
                for key, hook in hooks.items():
                    hook.remove()
                    self.prog[key] = hook.value
                self.prog["grads"] = _adam_first_grads(self.trainer)
        self.prog["change"] = {
            n: float((p.detach().cpu() - self.weights[n]).norm())
            for n, p in self.trainer.model.named_parameters()}

    def free_program(self, device):
        self.loader = self.trainer = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, device, lowp=None, half=False):
        return reference_train(self.cfg.model.backbone, self.cfg.optimizer,
                               self.cfg.scheduler, self.total_steps,
                               self.weights, self.batches, self.drop_seed,
                               device, on_card=device.type == "cuda",
                               lowp=lowp, half=half)


def run(run, workdir, device, t_start, overrides):
    st = Setup(run, workdir, device, overrides)
    trainer, loader = st.trainer, st.loader
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.end_to_end["setup_s"] = time.perf_counter() - t_start

    spans = Spans(tracing=bool(run.args.trace))
    kept = []  # (coord, mask) of each step, for the traced run's counts
    points = steps = failed = 0
    with Trace(bool(run.args.trace)) as tr:
        t0 = time.perf_counter()
        while True:
            with spans.span("data_wait"):
                batch = next(loader)
            with spans.span("train_step"):
                loss = float(trainer.train_step(batch)["loss"])
            steps += 1
            failed += not np.isfinite(loss)
            points += int(batch["mask"].sum())
            if run.args.trace:
                kept.append((batch["coord"], batch["mask"]))
            if time.perf_counter() - t0 >= run.args.seconds:
                break
        t1 = time.perf_counter()
    window = t1 - t0
    run.window_s = window
    run.attempted, run.failed = steps, failed
    run.end_to_end[run.cell.traffic["rate_metric"]] = points / window
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    run.memory_peak_bytes = peak
    run.end_to_end["peak_mem_gib"] = peak / GIB
    run.spans, run.trace = spans, tr.result
    backbone = dict(st.cfg.model.backbone)
    run.counts.update(backbone=backbone, precision=st.cfg.bench["precision"],
                      tf32=torch.backends.cuda.matmul.allow_tf32, train=True,
                      forwards=[forward_shape(c, m, backbone, device)
                                for c, m in kept])
    del trainer, loader, batch
    st.free_program(device)  # before the reference runs
    t_check = time.perf_counter()
    limits = run.cell.limits()
    run.checks = [(name, value, limits[name]["limit"])
                  for name, value in train_checks(st.prog, st.reference(device))
                  if name in limits]
    print(f"gpubench: set-up {run.end_to_end['setup_s']:.1f} s, window "
          f"{window:.1f} s, check {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)


def readings(run, workdir, device, overrides, control=None, faults=False):
    """The numbers compared on one seed without a window: the program's
    (sound), the control's (the reference in ``control``'s precision in
    the program's place) and, with ``faults``, the reference with half of
    each batch left out in the program's place; each against the float32
    reference."""
    st = Setup(run, workdir, device, overrides)
    st.free_program(device)
    ref = st.reference(device)
    out = dict(sound=dict(train_checks(st.prog, ref)))
    if control:
        out["control"] = dict(train_checks(st.reference(device, lowp=control), ref))
    if faults:
        out["half_batch"] = dict(train_checks(st.reference(device, half=True), ref))
    return out
