"""Whole-scene testing entry point.

    python -m ao_tpu_torch.tools.test --config-file configs/s3dis/semseg-pt-v2m2-0-base.py \
        --options weight=<model.pt | jax_variables.npz> save_path=<dir>

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..engines import TEST
from ..utils import Config, DictAction


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--options", nargs="+", action=DictAction,
                        help="KEY=VALUE config overrides")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    if args.options:
        cfg.merge_from_dict(args.options)
    if cfg.get("seed") is not None:
        torch.manual_seed(cfg.seed)
    os.makedirs(cfg.save_path, exist_ok=True)
    tester = TEST.build(dict(cfg.test, cfg=cfg, device=args.device))
    return tester()


if __name__ == "__main__":
    main()
