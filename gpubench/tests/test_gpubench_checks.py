"""The correctness check end to end on the CPU at a tiny width, with the
cells' own limits: a sound run comes out correct, and a run whose timed
path is broken underneath comes out not correct, once for each fault a
cell of its kind can have. The card's look is skipped; the rest of a run
is the harness's. The tiny cells compute in float32 (the configurations'
bf16 blocks on the CPU would round more than the card's kernels do)."""

import pytest
import torch

from ao_tpu_torch.engines.train import Trainer
from gpubench.tests import tiny


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    torch.set_num_threads(2)
    for cell, (over, t) in list(tiny.CELLS.items()):
        monkeypatch.setitem(tiny.CELLS, cell, (
            dict(over, **{"model.backbone.compute_dtype": None}), t))


def _unchanged_state(monkeypatch):
    """A train step that returns its state unchanged: the optimizer never
    steps."""
    orig = Trainer.train_step

    def step(self, batch):
        self.optimizer.step, keep = (lambda *a, **k: None), self.optimizer.step
        try:
            return orig(self, batch)
        finally:
            self.optimizer.step = keep

    monkeypatch.setattr(Trainer, "train_step", step)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    orig = Trainer.train_step

    def step(self, batch):
        B = batch["mask"].shape[0]
        half = {k: (v[:B // 2] if torch.is_tensor(v) and v.dim() and
                    v.shape[0] == B else v) for k, v in batch.items()}
        return orig(self, half)

    monkeypatch.setattr(Trainer, "train_step", step)


TRAIN_FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch}
CASES = [(c, f) for c in ("s3dis-ptv2m2.train", "scannet-ptv2m2.train")
         for f in [None, *TRAIN_FAULTS]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_gpubench_faults_come_out_not_correct(cell, fault, monkeypatch):
    if fault is not None:
        TRAIN_FAULTS[fault](monkeypatch)
    code, result = tiny.run_cell(cell, seed=11)
    assert code == 0 and result is not None
    assert result["correct"] is (fault is None), result["checks"]


def _readings(cell, tmp_path, **kw):
    from gpubench.harness import core

    over, t = tiny.CELLS[cell]
    c = core.Cell(core.load_bench(), cell)
    c.traffic.update(t)
    run = core.Run(c, core.parse(["--workload", cell, "--seed", "13",
                                  "--seconds", "0"]))
    driver = core.load_module(c.driver_file, "d")
    return c, driver.readings(run, str(tmp_path), torch.device("cpu"), over,
                              **kw)


@pytest.mark.parametrize("cell,control", [("s3dis-ptv2m2.train", "fp8"),
                                          ("scannet-ptv2m2.train", "tf32")])
def test_gpubench_control_comes_out_not_correct(cell, control, tmp_path):
    """A train cell's control, the reference one precision below the
    configuration's in the program's place, fails one of the cell's limits
    while the program passes them all, as on the card (PERF.md)."""
    c, r = _readings(cell, tmp_path, control=control)
    limits = c.limits()
    assert all(r["sound"][n] <= lim["limit"] for n, lim in limits.items()), r
    assert any(r["control"][n] > lim["limit"] for n, lim in limits.items()), r


def test_gpubench_output_gaps_hand_worked():
    """Three valid points of norm 5; a program that gave logits for the
    first row only reads the other two as 0: gaps 0, 5, 5."""
    from gpubench.reference.steps import output_gaps

    ref = torch.tensor([[[3.0, 4.0]], [[0.0, 5.0]], [[5.0, 0.0]]])
    mask = torch.ones(3, 1, dtype=torch.bool)
    assert output_gaps(ref.clone(), ref, mask) == (0.0, 0.0)
    whole, point = output_gaps(ref[:1], ref, mask)
    assert whole == pytest.approx((50 / 75) ** 0.5)
    assert point == pytest.approx(1.0)
