"""Whole-scene testing entry point.

    python -m ao_tpu_torch.tools.test --config-file configs/s3dis/semseg-pt-v2m2-0-base.py \
        --options weight=<model.pt | jax_variables.npz> save_path=<dir>

Runs on the card unless ``--device cpu`` is given. The config's ``test``
names the tester; a config without one (the CAC configs, which inherit
no default_runtime.py) gets that file's SemSegTester. ``--num-devices`` /
``torchrun`` as for ``tools.train``: the SemSegTester's processes each
test their share of the scenes.
"""

from __future__ import annotations

import os

import torch

from ..engines import TEST, default_argument_parser, launch, launch_args, local_device
from ..utils import Config

DEFAULT_TEST = dict(type="SemSegTester", verbose=True)


def main(argv=None):
    args = default_argument_parser(__doc__.splitlines()[0]).parse_args(argv)
    cfg = Config.fromfile(args.config_file)
    if args.options:
        cfg.merge_from_dict(args.options)
    os.makedirs(cfg.save_path, exist_ok=True)
    return launch(test_worker, cfg=(cfg, args.device), **launch_args(args))


def test_worker(cfg, device):
    """One process's test run; returns the tester's result."""
    if cfg.get("seed") is not None:
        torch.manual_seed(cfg.seed)
    tester = TEST.build(dict(cfg.get("test", DEFAULT_TEST), cfg=cfg,
                             device=local_device(device)))
    return tester()


if __name__ == "__main__":
    main()
