"""The hook-driven trainer of ao_tpu_torch against ao_tpu's: the hook
lifecycle's call order, ``eval_batch`` on one validation batch (the
histogram path and the origin-coord path) with the same weights, and the
SemSegEvaluator's metrics on fixed histograms; the collation of the
origin keys."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.datasets import collate_fn as jax_collate_fn
from ao_tpu.engines import hooks as jax_hooks
from ao_tpu.engines.train import Trainer as JaxTrainer
from ao_tpu.engines.train import TrainerBase as JaxTrainerBase
from ao_tpu.engines.train import TrainState
from ao_tpu.models import build_criteria as jax_build_criteria
from ao_tpu.models import build_model as jax_build_model
from ao_tpu_torch.datasets import build_dataset, collate_fn
from ao_tpu_torch.engines import hooks as port_hooks
from ao_tpu_torch.engines.train import Trainer, TrainerBase
from ao_tpu_torch.models import build_criteria, build_model
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.utils import Config

_METHODS = ("before_train", "before_epoch", "before_step", "after_step",
            "after_epoch", "after_train")


def _recording_hook(base):
    class RecordingHook(base):
        def __init__(self):
            self.calls = []

        def _rec(self, name):
            t = self.trainer
            self.calls.append((name, t.epoch, t.comm_info.get("iter"),
                               t.storage.iter))

    for name in _METHODS:
        setattr(RecordingHook, name,
                lambda self, _n=name: self._rec(_n))
    # a metric per epoch, so that after_train's best-value update runs
    RecordingHook.after_epoch = lambda self: (
        self._rec("after_epoch"),
        self.trainer.comm_info.update(current_metric_value=self.trainer.epoch))
    return RecordingHook


def _loop(base, steps=3):
    class Loop(base):
        def run_epoch(self):
            for i in range(steps):
                self.comm_info["iter"] = i
                self.before_step()
                self.after_step()
                self.storage.step()

    return Loop


@pytest.mark.parametrize("start_epoch", [0, 2])
def test_hook_lifecycle_call_order_matches_jax(start_epoch):
    """A recording hook, registered through each package's HOOKS registry,
    sees the same calls (with the trainer's epoch, iteration and storage
    step at each) under both TrainerBases, and both end with the same best
    metric."""
    records = []
    for base, hooks in ((JaxTrainerBase, jax_hooks), (TrainerBase, port_hooks)):
        hooks.HOOKS.register_module(name="RecordingHook",
                                    module=_recording_hook(hooks.HookBase),
                                    force=True)
        trainer = _loop(base)()
        trainer.start_epoch, trainer.max_epoch = start_epoch, 4
        trainer.best_metric_value = -1e9
        trainer.register_hooks([dict(type="RecordingHook")])
        trainer.train()
        records.append((trainer.hooks[0].calls, trainer.best_metric_value))
    assert records[0] == records[1]
    assert len(records[1][0]) == 2 + (4 - start_epoch) * (2 + 2 * 3)


def test_collate_keeps_origin_keys_in_extras():
    """origin_coord / origin_segment are not padded per-point keys: both
    packages hand them over unpadded, per sample, under ``extras``."""
    rng = np.random.default_rng(0)
    samples = [dict(coord=rng.normal(size=(n, 3)).astype(np.float32),
                    segment=rng.integers(0, 13, n),
                    origin_coord=rng.normal(size=(m, 3)).astype(np.float32),
                    origin_segment=rng.integers(0, 13, m))
               for n, m in ((70, 100), (90, 130))]
    out = collate_fn(samples, pad_multiple=64)
    ref = jax_collate_fn(samples, pad_multiple=64)
    assert tuple(out["coord"].shape) == (2, 128, 3)
    for key in ("origin_coord", "origin_segment"):
        assert key not in out and key in out["extras"]
        for a, b, s in zip(out["extras"][key], ref["extras"][key], samples):
            np.testing.assert_array_equal(np.asarray(a), s[key])
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _val_cfg(root):
    """The base config's validation pipeline with the origin keys collected,
    on the tiny PT-v2m2 in f32."""
    base = Config.fromfile(chip_smoke.BASE_CONFIG)
    transform = [dict(t) for t in base.data.val.transform]
    collect = next(t for t in transform if t["type"] == "Collect")
    collect["keys"] = tuple(collect["keys"]) + ("origin_coord", "origin_segment")
    model = _flagship_cfg(tiny=True)
    model["criteria"] = [dict(type="CrossEntropyLoss", loss_weight=1.0,
                              ignore_index=-1)]
    return Config(dict(
        model=model,
        data=dict(num_classes=13, ignore_index=-1, val=dict(
            type="S3DISDataset", split="Area_5", data_root=str(root),
            transform=transform, test_mode=False))))


def _eval_trainers(cfg, batch):
    """ao_tpu's and the port's trainers reduced to what eval_batch reads,
    with the same weights (JAX initialisation, random running
    statistics)."""
    jmodel = jax_build_model(dict(cfg.model))
    arrays = [jnp.asarray(batch[k].numpy()) for k in ("coord", "feat", "mask")]
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *arrays)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            (rng.uniform(0.5, 1.5, v.shape) if "var" in str(p[-1])
             else rng.normal(0, 0.1, v.shape)).astype(np.float32)),
        var["batch_stats"])
    jtr = object.__new__(JaxTrainer)
    jtr.cfg, jtr.model = cfg, jmodel
    jtr.criteria = jax_build_criteria(list(cfg.model.criteria))
    jtr.mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jtr.state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=var["params"], batch_stats=stats,
                           opt_state=None)
    jtr._eval_step = jtr.make_eval_step()
    ttr = object.__new__(Trainer)
    ttr.cfg, ttr.device = cfg, torch.device("cpu")
    ttr.model = build_model(dict(cfg.model))
    ttr.model.load_state_dict(convert.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, var["params"]),
        jax.tree_util.tree_map(np.asarray, stats)), strict=True)
    ttr.criteria = build_criteria(cfg.model.criteria)
    return jtr, ttr


@pytest.mark.parametrize("origin", [False, True])
def test_eval_batch_matches_jax(tmp_path, origin):
    """One validation batch of a synthetic room through the base config's
    validation pipeline: the port's eval_batch against ao_tpu's (its jitted
    eval step, f32) on the same weights. Equal intersection / union /
    target histograms on the grid-sampled points and, with the origin
    keys, on the full-resolution points (the exact 1-NN re-projection);
    loss within 1e-5."""
    room = chip_smoke.make_room(4, (1.0, 0.8, 0.5))
    (tmp_path / "Area_5").mkdir()
    np.savez(tmp_path / "Area_5" / "office_1.npz", **room)
    cfg = _val_cfg(tmp_path)
    torch.manual_seed(0)  # GridSample's picks
    sample = build_dataset(cfg.data.val)[0]
    batch = collate_fn([sample], pad_multiple=512)
    n_full, n_sampled = len(room["coord"]), int(batch["mask"].sum())
    assert n_sampled < n_full
    if not origin:
        del batch["extras"]
    jtr, ttr = _eval_trainers(cfg, batch)
    jbatch = {k: (v.numpy() if torch.is_tensor(v) else v)
              for k, v in batch.items()}
    jres = jtr.eval_batch(jbatch)
    tres = ttr.eval_batch(batch)
    for a, b in zip(tres[1:], jres[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert abs(tres[0] - float(jres[0])) <= 1e-5 * max(abs(float(jres[0])), 1)
    # the histograms count the points of the path's own resolution
    assert tres[3].sum() == (n_full if origin else n_sampled)


class _FakeTrainer:
    """What an evaluator reads of a trainer, with fixed histograms."""

    def __init__(self, hists):
        self.cfg = Config(dict(data=dict(num_classes=4,
                                         names=["a", "b", "c", "d"])))
        self.val_loader = list(range(len(hists)))
        self.hists = hists
        self.logger = logging.getLogger("evaluator-test")
        self.epoch = 2
        self.comm_info = {}
        self.best_metric_value = -1e9
        self.scalars = {}
        self.writer = self

    def add_scalar(self, name, value, step):
        self.scalars[name] = (value, step)

    def eval_batch(self, i):
        return self.hists[i]


def test_semseg_evaluator_matches_jax():
    """mIoU, mAcc, allAcc and the mean loss of the port's SemSegEvaluator
    against ao_tpu's on fixed histograms (a class never predicted, one
    never present), to 1e-12."""
    rng = np.random.default_rng(0)
    hists = []
    for loss in (0.9, 1.3, 0.4):
        inter = rng.integers(0, 50, 4).astype(float)
        target = inter + rng.integers(0, 30, 4)
        union = target + rng.integers(0, 30, 4)
        inter[3] = target[3] = 0
        hists.append((loss, inter, union, target))
    fakes = [_FakeTrainer(hists) for _ in range(2)]
    for fake, hooks in zip(fakes, (jax_hooks, port_hooks)):
        ev = hooks.evaluator.SemSegEvaluator()
        ev.trainer = fake
        ev.eval()
    ref, got = fakes
    assert got.comm_info["current_metric_name"] == "mIoU"
    assert set(got.scalars) == set(ref.scalars) == {
        "val/loss", "val/mIoU", "val/mAcc", "val/allAcc"}
    for name, (value, step) in ref.scalars.items():
        assert got.scalars[name][1] == step == 3
        assert abs(got.scalars[name][0] - value) <= 1e-12
    assert abs(got.comm_info["current_metric_value"]
               - ref.comm_info["current_metric_value"]) <= 1e-12
