"""The port's spans (ao_tpu_torch/utils/tracing.py) on the tiny CPU trainer:
nothing recorded and no range opened without a profiler; under one, the
train step's three phases in order, PT-v2m2's stage spans inside the
forward, each record bracketing kineto's event of its range, and a bounded
record."""

import collections

import pytest
import torch

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu_torch.utils import tracing

PHASES = ("step/forward", "step/backward", "step/optimizer")
STAGES = ("ptv2m2/embed", "ptv2m2/enc0", "ptv2m2/enc1", "ptv2m2/dec1",
          "ptv2m2/dec0")


def _trainer(tmp_path, checkpoint=False):
    """The tiny PT-v2m2 of __graft_entry__ in f32 on three small synthetic
    S3DIS rooms, and its first two batches."""
    rooms = [chip_smoke.make_room(s, (0.9, 0.8, 0.6)) for s in (1, 2, 3)]
    _, options = chip_smoke.train_setup(rooms, str(tmp_path), batch_size=2,
                                        max_steps=2, workers=0, seed=3)
    backbone = _flagship_cfg(tiny=True)["backbone"]
    backbone.update(compute_dtype=None, enable_checkpoint=checkpoint)
    trainer = chip_smoke.build_trainer(
        options + [f"model.backbone={backbone!r}", "pad_multiple=1024"], "cpu")
    loader = iter(trainer.train_loader)
    return trainer, [next(loader), next(loader)]


def _traced_steps(trainer, batches):
    """(the records, kineto's ``ao/`` events as {name: [(start, end)]}) of
    the steps under a CPU torch.profiler."""
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for batch in batches:
            trainer.train_step(batch)
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(tracing.PREFIX):
            events[ev.name()[len(tracing.PREFIX):]].append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    records = tracing.records()
    tracing.clear()
    return records, {n: sorted(v) for n, v in events.items()}


def test_tracing_off_records_nothing(tmp_path, monkeypatch):
    """Without a profiler two train steps record nothing, and no range is
    opened: every span is the one shared null context."""
    trainer, batches = _trainer(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.clear()
    for batch in batches:
        trainer.train_step(batch)
    assert tracing.records() == []
    assert tracing.span("step/forward") is tracing.span("ptv2m2/enc0")


@pytest.mark.parametrize("checkpoint", [False, True])
def test_tracing_phases_in_order(tmp_path, checkpoint):
    """Under a profiler each step records its three phases once, in order,
    without overlap; PT-v2m2's stage spans lie inside the step's forward.
    Under recompute (enable_checkpoint) the blocks run again inside
    step/backward, and no stage span opens there: the checkpoint reruns
    each block, not the stage around it."""
    trainer, batches = _trainer(tmp_path, checkpoint)
    records, _ = _traced_steps(trainer, batches)
    phases = [r for r in records if r[0].startswith("step/")]
    assert [r[0] for r in phases] == list(PHASES) * len(batches)
    for (_, s0, e0), (_, s1, e1) in zip(phases, phases[1:]):
        assert s0 <= e0 <= s1 <= e1
    forwards = [r for r in phases if r[0] == "step/forward"]
    stages = [r for r in records if r[0].startswith("ptv2m2/")]
    assert [r[0] for r in stages] == list(STAGES) * len(batches)
    for name, s, e in stages:
        assert any(fs <= s <= e <= fe for _, fs, fe in forwards), name


def test_tracing_records_bracket_kineto_events(tmp_path):
    """Each record brackets kineto's event of the same range (the same name
    and occurrence), and lies within 1 ms of it at each end."""
    trainer, batches = _trainer(tmp_path)
    records, events = _traced_steps(trainer, batches)
    assert records and set(events) == set(PHASES + STAGES)
    seen = collections.Counter()
    for name, start, end in records:
        ev_start, ev_end = events[name][seen[name]]
        seen[name] += 1
        assert 0 <= ev_start - start < 1_000_000, name
        assert 0 <= end - ev_end < 1_000_000, name
    assert all(seen[n] == len(v) for n, v in events.items())


def test_tracing_record_is_bounded(monkeypatch):
    """The record keeps at most its limit, 2**20, dropping the oldest: a
    record of four keeps the last four of six spans."""
    assert tracing.LIMIT == 2**20 and tracing._records.maxlen == tracing.LIMIT
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=4))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(6):
            with tracing.span(f"s{i}"):
                pass
    assert [r[0] for r in tracing.records()] == ["s2", "s3", "s4", "s5"]
    with tracing.span("after"):  # the profiler has stopped
        pass
    assert len(tracing.records()) == 4
