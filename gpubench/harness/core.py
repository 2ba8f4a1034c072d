"""One run of one cell of the benchmark.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name in BENCHMARK.json leads to everything else by name: its
configuration's file, its traffic file ``gpubench/traffic/<traffic>.json``
(whose ``driver`` names ``gpubench/drivers/<driver>.py``), the limits of
its correctness check ``gpubench/limits/<cell>.json`` and, with
``--trace 1``, a reader ``gpubench/metrics/<metric>.py`` for each of its
per-layer metrics. The driver sets the program up from the seed, warms it
up, runs the measured window and checks what the window produced against
the plain reference. The last line of standard output is the result; the
numbers compared, each beside its limit, close standard error and the
result's line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# the program's caches at fixed paths inside the checkout, so that only the
# first run of a checkout builds (the kernels' own build directory,
# ao_tpu_torch/_build/, is inside it already)
CACHE_DIR = os.path.join(ROOT, ".gpubench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ao_tpu")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with everything its name leads to."""

    def __init__(self, bench, name):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = configs[self.spec["config"]]
        self.config_file = os.path.join(ROOT, self.config["file"])
        self.traffic_file = os.path.join(BENCH_DIR, "traffic",
                                         self.spec["traffic"] + ".json")
        with open(self.traffic_file) as f:
            self.traffic = json.load(f)
        self.driver_file = os.path.join(BENCH_DIR, "drivers",
                                        self.traffic["driver"] + ".py")
        self.limits_file = os.path.join(BENCH_DIR, "limits", name + ".json")
        self.chips = int(self.spec["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric):
        return os.path.join(BENCH_DIR, "metrics", metric + ".py")

    def limits(self):
        with open(self.limits_file) as f:
            return json.load(f)["checks"]


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a driver hands back: the end-to-end values by name, the host
    spans, the device trace, the counts its metric readers need, and the
    correctness check."""

    def __init__(self, cell, args):
        self.cell = cell
        self.args = args
        self.end_to_end = {}
        self.counts = {}
        self.spans = None
        self.trace = None
        self.window_s = None
        self.attempted = 0
        self.failed = 0
        self.checks = []  # (name, value, limit)
        self.memory_peak_bytes = 0

    def correct(self):
        """No step or scene failed, and every number compared is finite and
        within its limit."""
        return not self.failed and bool(self.checks) and all(
            value is not None and math.isfinite(value) and value <= limit
            for _, value, limit in self.checks)


def device_info(chips):
    import torch

    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips)


def main(argv=None, t_start=None, require_card=True, device=None,
         overrides=None, traffic=None):
    """Run a cell once; returns the process's exit code. ``require_card``,
    ``device``, ``overrides`` (config options) and ``traffic`` (keys of the
    traffic file replaced) exist for the tests, which run the harness on the
    CPU at a tiny size."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    os.makedirs(CACHE_DIR, exist_ok=True)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    import torch

    cell = Cell(load_bench(), args.workload)
    cell.traffic.update(traffic or {})
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda")
    device = torch.device(device or "cpu")
    driver = load_module(cell.driver_file, "gpubench_driver")
    workdir = tempfile.mkdtemp(prefix="gpubench_")
    run = Run(cell, args)
    try:
        driver.run(run, workdir=workdir, device=device, t_start=t_start,
                   overrides=overrides or {})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 3
    result = finish(run, device)
    print(json.dumps(result), flush=True)
    return 0


def finish(run, device):
    cell = run.cell
    metrics = {}
    if run.args.trace:
        for m in cell.per_layer:
            value = load_module(cell.reader(m["name"]), "gpubench_metric").read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in cell.end_to_end:
            if m["name"] not in run.end_to_end:
                raise KeyError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = dict(value=run.end_to_end[m["name"]],
                                      unit=m["unit"])
    dev = (device_info(cell.chips) if device.type == "cuda"
           else dict(platform="cpu", kind="cpu", count=1))
    dev["memory_peak_bytes"] = int(run.memory_peak_bytes)
    if run.args.trace:
        dev["busy_s"] = run.trace.busy_s if run.trace else 0.0
        dev["window_s"] = run.window_s
    checks = {name: dict(value=v, limit=lim) for name, v, lim in run.checks}
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    correct = run.correct()
    print(f"correct = {correct}", file=sys.stderr, flush=True)
    out = dict(correct=correct, attempted=run.attempted, failed=run.failed,
               metrics=metrics, device=dev)
    if run.args.trace and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def entry(argv=None, t_start=None):
    try:
        code = main(argv, t_start)
    except Exception:  # report the failure, print no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
