"""The readers of the program's spans (harness/program_spans.py) on
hand-made gaps and records, and a tiny traced CPU run that reports them."""

import sys
from types import SimpleNamespace

import pytest
import torch

import ao_tpu_torch.utils
from ao_tpu_torch.utils import tracing
from gpubench.harness import program_spans
from gpubench.tests import tiny

MS = 1_000_000  # ns

# two steps: forward 0-10 ms, backward 10-40, optimizer 40-45; then
# forward 100-110, backward 110-140, optimizer 140-145
RECORDS = [(name, base + s * MS, base + e * MS)
           for base in (0, 100 * MS)
           for name, s, e in (("step/forward", 0, 10), ("step/backward", 10, 40),
                              ("step/optimizer", 40, 45))]


def _run(gaps, attempted=2):
    return SimpleNamespace(trace=SimpleNamespace(gaps=gaps), attempted=attempted)


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))


def test_gpubench_idle_split_by_overlap(records):
    """A gap across the forward's end and the backward's start is split
    between them by overlap; a gap inside the optimizer goes to it alone;
    a gap between the steps (50-100 ms) is counted nowhere. Per step: the
    sum over the two steps over 2."""
    run = _run([(5 * MS, 25 * MS), (41 * MS, 43 * MS), (50 * MS, 100 * MS),
                (112 * MS, 113 * MS)])
    got = {ph: program_spans.idle_ms_per_step(run, f"step/{ph}")
           for ph in ("forward", "backward", "optimizer")}
    assert got == pytest.approx(dict(forward=2.5, backward=8.0, optimizer=1.0))
    assert sum(got.values()) == pytest.approx((20 + 2 + 1) / 2)


def test_gpubench_idle_zero_without_gaps(records):
    assert program_spans.idle_ms_per_step(_run([]), "step/forward") == 0.0


def test_gpubench_idle_none_without_trace_or_records(monkeypatch):
    run = _run([(5 * MS, 25 * MS)])
    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))
    assert program_spans.idle_ms_per_step(_run([], 0), "step/forward") is None
    no_trace = SimpleNamespace(trace=None, attempted=2)
    assert program_spans.idle_ms_per_step(no_trace, "step/forward") is None
    assert program_spans.idle_ms_per_step(run, "step/elsewhere") is None
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert program_spans.idle_ms_per_step(run, "step/forward") is None
    # a program without the spans (an older checkout): the import fails
    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))
    assert program_spans.idle_ms_per_step(run, "step/forward") == 2.5
    monkeypatch.delattr(ao_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "ao_tpu_torch.utils.tracing", None)
    assert program_spans.idle_ms_per_step(run, "step/forward") is None


def test_gpubench_traced_tiny_run_reports_the_phases(monkeypatch):
    """A traced run of the tiny s3dis cell on the CPU reports the three
    phases' idle ms (0: no device activity on the CPU, so no gap); the
    program recorded its spans over the window alone."""
    torch.set_num_threads(2)
    cell = "s3dis-ptv2m2.train"
    over, t = tiny.CELLS[cell]
    monkeypatch.setitem(tiny.CELLS, cell, (
        dict(over, **{"model.backbone.compute_dtype": None}), t))
    tracing.clear()
    code, result = tiny.run_cell(cell, trace=1)
    assert code == 0
    for ph in ("forward", "backward", "optimizer"):
        assert result["metrics"][f"{ph}_idle_ms.train"]["value"] == 0.0
    names = [r[0] for r in tracing.records() if r[0].startswith("step/")]
    assert names == ["step/forward", "step/backward",
                     "step/optimizer"] * result["attempted"]
    tracing.clear()
