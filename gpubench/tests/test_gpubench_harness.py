"""BENCHMARK.json, the files its names lead to, and what the benchmark may
import."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

from gpubench.harness import core
from gpubench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_gpubench_every_name_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        cell = core.Cell(bench, w["name"])
        for path in (cell.config_file, cell.traffic_file, cell.driver_file,
                     cell.limits_file):
            assert os.path.isfile(path), path
        driver = core.load_module(cell.driver_file, "d")
        assert callable(driver.run) and callable(driver.readings)
        assert cell.limits(), w["name"]
        assert [m for m in cell.end_to_end if m["name"] == "setup_s"]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            reader = core.load_module(cell.reader(m["name"]), "r")
            assert callable(reader.read), m["name"]


def test_gpubench_contract_shapes():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(names)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for c in bench["configs"]:
        assert c["file"].startswith("gpubench/") and len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert 1 <= bench["run_seconds"] <= 51


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_gpubench_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(ROOT, "gpubench", "reference", "*.py"))
    assert files
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"ao_tpu_torch", "ao_tpu", "jax", "jaxlib", "flax"}, path


def test_gpubench_run_loads_no_jax():
    """What run.py and every driver, reader and reference module load has
    no top-level name jax, jaxlib, flax or ao_tpu (compared whole:
    ao_tpu_torch is the port)."""
    code = (
        "import sys, glob, importlib, os; sys.path.insert(0, %r)\n"
        "from gpubench.harness import core\n"
        "import ao_tpu_torch.engines\n"
        "import gpubench.calibrate\n"
        "for d in ('harness', 'reference', 'counts'):\n"
        "    for p in glob.glob(os.path.join(%r, 'gpubench', d, '*.py')):\n"
        "        importlib.import_module('gpubench.%%s.%%s' %% (d, os.path.basename(p)[:-3]))\n"
        "for d in ('drivers', 'metrics'):\n"
        "    for p in glob.glob(os.path.join(%r, 'gpubench', d, '*.py')):\n"
        "        core.load_module(p, 'm')\n"
        "print(core.forbidden_modules())\n" % (ROOT, ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_gpubench_refuses_without_the_port(tmp_path):
    """In a directory with only BENCHMARK.json and gpubench/, a run exits
    with a failure and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "s3dis-ptv2m2.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.card
def test_gpubench_cell_runs_on_the_card():
    """A short run of the first cell on the card: exit 0, a result with
    every end-to-end metric, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on the card")
    bench = _bench()
    cell = bench["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed", "5",
         "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
