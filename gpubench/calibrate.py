"""Readings that the limits of a cell's correctness check are set from.

    python3 gpubench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control] [--faults]

For each seed, without a measured window: the numbers the cell compares,
read from the program's first steps against the float32
reference ("sound"); with ``--control``, from the reference computed one
precision below the configuration's (the configuration's
``bench["control"]``) in the program's place; with ``--faults``, from the
faults a cell of the kind can have, planted in the reference put in the
program's place. One JSON line a seed on standard output. Needs the card,
as the runs do.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

from gpubench.harness import core  # noqa: E402


def main(argv=None, device="cuda", overrides=None, traffic=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    a = p.parse_args(argv)
    import torch

    from ao_tpu_torch.utils import Config

    cell = core.Cell(core.load_bench(), a.workload)
    cell.traffic.update(traffic or {})
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA card")
    dev = torch.device(device)
    control = Config.fromfile(cell.config_file).bench["control"] if a.control else None
    driver = core.load_module(cell.driver_file, "gpubench_driver")
    lines = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        run = core.Run(cell, core.parse(["--workload", a.workload, "--seed",
                                         str(seed), "--seconds", "0"]))
        workdir = tempfile.mkdtemp(prefix="gpubench_cal_")
        try:
            r = driver.readings(run, workdir, dev, overrides or {},
                                control=control, faults=a.faults)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line = json.dumps(dict(workload=a.workload, seed=seed, precision=control,
                               seconds=time.perf_counter() - t0, **r))
        print(line, flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
