"""Training entry point.

    python -m ao_tpu_torch.tools.train --config-file configs/s3dis/semseg-pt-v2m2-0-base.py \
        --options save_path=<dir> [max_steps=<n>] [--device cpu]

Runs on the card unless ``--device cpu`` is given. The trainer registers
the config's ``hooks`` (configs/_base_/default_runtime.py: CheckpointLoader,
IterationTimer, InformationWriter, SemSegEvaluator, CheckpointSaver), so
``weight=<.pt | JAX .ckpt>`` fine-tunes, ``resume=True`` continues from
``weight`` or from the run's own ``model/model_last.pt``, and every epoch
ends with an evaluation on ``data.val``. ``main`` returns the trainer,
whose ``history`` holds the per-step records.

``--num-devices N`` trains on N cards, one process a card (spawned by
``engines.launch``; NCCL, gloo with ``--device cpu``), the config's
``batch_size`` being the global batch; under ``torchrun`` each process
joins the group its environment describes. ``main`` then returns None in
the launching process.
"""

from __future__ import annotations

import numpy as np

from ..engines import (Trainer, default_argument_parser, default_config_parser,
                       launch, launch_args, local_device)


def run(trainer_cls, description, argv=None):
    """Parse the command line and train with ``trainer_cls`` through the
    launcher; returns the trainer (None after spawning processes)."""
    args = default_argument_parser(description).parse_args(argv)
    cfg = default_config_parser(args.config_file, args.options)
    return launch(train_worker, cfg=(trainer_cls, cfg, args.device),
                  **launch_args(args))


def train_worker(trainer_cls, cfg, device):
    """One process's training: build ``trainer_cls`` on this process's
    device, train, and log the median step seconds and data wait; returns
    the trainer."""
    trainer = trainer_cls(cfg, device=local_device(device))
    trainer.train()
    hist = trainer.history[1:]  # the first step pays the warm-up
    if hist:
        trainer.logger.info(
            f"{len(trainer.history)} steps on {trainer.device}: median of "
            f"steps 2-{len(trainer.history)} "
            f"{np.median([r['step_seconds'] for r in hist]):.4f} s a step, "
            f"data wait {np.median([r['data_seconds'] for r in hist]):.4f} s")
    return trainer


def main(argv=None):
    return run(Trainer, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
