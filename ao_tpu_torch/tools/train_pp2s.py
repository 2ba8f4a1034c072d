"""PP2S-label supervised training entry point (port of tools/train_pp2s.py;
reference: tools/train_sam_pp2s.py — a standard trainer whose train
dataset runs in weak mode over the PP2S pseudo-labels).

    python -m ao_tpu_torch.tools.train_pp2s \
        --config-file configs/s3dis/semseg-pt-v2m2-1-proxy-pp2s.py \
        --options save_path=<dir> data.train.weak_path=<labels> ...

Runs on the card unless ``--device cpu`` is given; ``main`` returns the
trainer. ``--num-devices`` / ``torchrun`` as for ``tools.train``.
"""

from __future__ import annotations

from ..engines import (Trainer, default_argument_parser, default_config_parser,
                       launch, launch_args)
from .train import train_worker


def main(argv=None):
    args = default_argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    cfg = default_config_parser(args.config_file, args.options)
    cfg.data.train.weak = True
    cfg.data.train.setdefault("mode", "pp2s")
    cfg.data.train.setdefault("weak_path", "data/sam_labels")
    return launch(train_worker, cfg=(Trainer, cfg, args.device),
                  **launch_args(args))


if __name__ == "__main__":
    main()
