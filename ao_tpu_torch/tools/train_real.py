"""REAL training entry point (port of tools/train_real.py; reference:
tools/train_sam_real.py).

    python -m ao_tpu_torch.tools.train_real \
        --config-file configs/s3dis/semseg-pt-v2m2-1-proxy-real.py \
        --options save_path=<dir> weight=<stage B model_best.pt> \
        real.initial_labels=<dir> real.basket=<file> ...

Runs on the card unless ``--device cpu`` is given: the train step with
its six CUDA kernels, and the neural SAM's decodes when ``real.sam_oracle``
is off. Every epoch ends with the config's hooks, then one refinement
round (``RealTrainer.after_epoch``). ``main`` returns the trainer, whose
``history`` holds the per-step records (``basket_seconds``: the basket
fill's share of ``step_seconds``) and ``refine_history`` the rounds.
"""

from __future__ import annotations

import numpy as np

from ..engines import default_argument_parser, default_config_parser
from ..engines.train_real import RealTrainer


def main(argv=None):
    args = default_argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    cfg = default_config_parser(args.config_file, args.options)
    trainer = RealTrainer(cfg, device=args.device)
    trainer.train()
    hist = trainer.history[1:]  # the first step pays the warm-up
    if hist:
        trainer.logger.info(
            f"{len(trainer.history)} steps on {trainer.device}: median of "
            f"steps 2-{len(trainer.history)} "
            f"{np.median([r['step_seconds'] for r in hist]):.4f} s a step, "
            f"basket fill {np.median([r['basket_seconds'] for r in hist]):.4f}"
            f" s of it")
    return trainer


if __name__ == "__main__":
    main()
