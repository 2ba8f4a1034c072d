"""Training entry point.

    python -m ao_tpu_torch.tools.train --config-file configs/s3dis/semseg-pt-v2m2-0-base.py \
        --options save_path=<dir> [max_steps=<n>] [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``main`` returns the
trainer, whose ``history`` holds the per-step records.
"""

from __future__ import annotations

from ..engines import Trainer, default_argument_parser, default_config_parser


def main(argv=None):
    args = default_argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    cfg = default_config_parser(args.config_file, args.options)
    trainer = Trainer(cfg, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
