"""Command-line and config defaults (port of ao_tpu/engines/defaults.py).

``default_config_parser`` follows the reference's config protocol: the
train dataset loops ``epoch // eval_epoch`` times per (mega-)epoch, and
the resolved config is written to the experiment directory.
``default_argument_parser`` takes the launcher's arguments
(``--num-devices``, ``--num-machines``, ``--machine-rank``,
``--dist-url``; :func:`launch_args` hands them to
``engines.launch.launch``, whose group runs NCCL on the card and gloo on
the CPU).
"""

from __future__ import annotations

import argparse
import os

from ..utils import Config, DictAction
from ..utils.env import get_random_seed


def default_argument_parser(description=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config-file", required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--options", nargs="+", action=DictAction, default={},
                        help="config overrides: key=value (nested keys with dots)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    parser.add_argument("--num-devices", type=int, default=1,
                        help="processes (cards) on this machine, one a rank")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0,
                        help="this machine's index among --num-machines")
    parser.add_argument("--dist-url", default="auto",
                        help="the group's tcp://<host>:<port> (machine 0's); "
                             "auto: a free localhost port (one machine)")
    return parser


def launch_args(args) -> dict:
    """The keyword arguments of ``engines.launch.launch`` from the parsed
    command line."""
    return dict(num_devices_per_machine=args.num_devices,
                num_machines=args.num_machines, machine_rank=args.machine_rank,
                dist_url=args.dist_url, device=args.device)


def default_config_parser(file_path: str, options: dict) -> Config:
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"config not found: {file_path}")
    cfg = Config.fromfile(file_path)
    if options:
        cfg.merge_from_dict(options)
    if cfg.get("seed") is None:
        cfg.seed = get_random_seed()
    cfg.setdefault("data", {})
    cfg.data.setdefault("train", {})
    if cfg.get("epoch") and cfg.get("eval_epoch"):
        cfg.data.train.loop = max(cfg.epoch // cfg.eval_epoch, 1)
    else:
        cfg.setdefault("eval_epoch", cfg.get("epoch", 1))
    os.makedirs(cfg.save_path, exist_ok=True)
    if not cfg.get("resume", False):
        cfg.dump(os.path.join(cfg.save_path, "config.py"))
    return cfg
