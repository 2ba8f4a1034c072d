"""Checkpoints and weak labels of ao_tpu_torch against ao_tpu: the port's
flax-msgpack reader against flax's on an ao_tpu checkpoint, a tiny PT-v2m2
saved by ao_tpu and loaded by the port's CheckpointLoader (fine-tune),
``filter_state_dict``, a resume from the port's own checkpoint through the
train entry point, and S3DISDataset's weak-label modes."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.datasets.s3dis import S3DISDataset as JaxS3DIS
from ao_tpu.engines.train import TrainState
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.utils.checkpoint import filter_state_dict as jax_filter_state_dict
from ao_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ao_tpu_torch.datasets.s3dis import S3DISDataset
from ao_tpu_torch.engines.hooks.misc import CheckpointLoader
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.tools.train import main as train_main
from ao_tpu_torch.utils.checkpoint import filter_state_dict, msgpack_restore

ROOM = (0.9, 0.8, 0.6)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = r"""
import sys
for name in ("jax", "ao_tpu", "flax", "msgpack", "optax"):
    sys.modules[name] = None
import torch
from ao_tpu_torch.engines.test import load_weights
torch.save(load_weights(sys.argv[1]), sys.argv[2])
"""


def _options(root, steps, **extra):
    """Three small synthetic rooms as S3DIS train scenes and the base
    config's overrides for the tiny PT-v2m2 of __graft_entry__ in f32
    without stochastic depth."""
    rooms = [chip_smoke.make_room(s, ROOM) for s in (1, 2, 3)]
    _, options = chip_smoke.train_setup(rooms, str(root), batch_size=2,
                                        max_steps=steps, workers=0, seed=3)
    backbone = _flagship_cfg(tiny=True)["backbone"]
    backbone.update(drop_path_rate=0.0, compute_dtype=None)
    return options + [f"model.backbone={backbone!r}", "pad_multiple=1024"] + [
        f"{k}={v!r}" for k, v in extra.items()]


def _assert_same_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        ref = np.asarray(ref)
        got = np.asarray(got)
        assert got.shape == ref.shape, path
        if ref.dtype == jnp.bfloat16:  # read as float32, value for value
            assert got.dtype == np.float32, path
            np.testing.assert_array_equal(got, ref.astype(np.float32))
        else:
            assert got.dtype == ref.dtype, path
            np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref, path


def test_msgpack_reader_matches_flax(tmp_path):
    """The pure-Python reader against flax.serialization.msgpack_restore on
    an ao_tpu save_checkpoint payload: its state's f32 / bf16 / int / bool
    arrays (0-d included; save_checkpoint makes every leaf an array) and
    its meta's Python ints of every width, floats, strings, booleans,
    None, lists and nested dicts; and a chunked array."""
    rng = np.random.default_rng(0)
    state = dict(
        params=dict(dense=dict(kernel=rng.normal(size=(5, 7)).astype(np.float32),
                               bias=np.zeros(7, np.float32)),
                    half=jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)),
        step=np.asarray(17, np.int32), counts=rng.integers(-2**40, 2**40, (4,)),
        flags=rng.random((2, 3)) < 0.5, scalar=np.float64(2.5),
        small=np.int8(-3), nested=dict(deeper=dict(leaf=np.arange(6.0))))
    meta = dict(
        epoch=3, best_metric_value=0.25, real=0.1,
        nums=[0, 1, -1, 127, 128, -33, 255, 256, 65536, 2**33, -2**33, 2**63 - 1],
        text="héllo" * 40, longtext="x" * 70000, ok=True, nothing=None,
        empty={}, scalar=np.float32(1.5), nested=dict(deeper=[1, "a", 2.0]))
    path = str(tmp_path / "payload.ckpt")
    jax_save_checkpoint(path, state, meta=meta)
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))
    chunked = serialization._chunk(np.arange(10, dtype=np.int16))
    blob = serialization.msgpack_serialize(dict(a=chunked))
    _assert_same_tree(msgpack_restore(blob), serialization.msgpack_restore(blob))
    with pytest.raises(ValueError):
        msgpack_restore(data[:-3])


def test_checkpoint_loader_reads_ao_tpu_ckpt(tmp_path):
    """A tiny PT-v2m2 train state saved by ao_tpu (params, random running
    statistics, AdamW state) and loaded into the port's trainer by its
    CheckpointLoader in fine-tune mode: every weight arrives, and the
    eval logits agree with ao_tpu's within 1e-4 x max(1, |logit|)."""
    trainer = chip_smoke.build_trainer(
        _options(tmp_path, 1, weight=str(tmp_path / "jax.ckpt")), "cpu")
    batch = next(iter(trainer.train_loader))
    jmodel = jax_build_model(trainer.cfg.to_dict()["model"])
    arrays = tuple(jnp.asarray(batch[k].numpy())
                   for k in ("coord", "feat", "mask"))
    var = jax.jit(jmodel.init)(jax.random.PRNGKey(1), *arrays)
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            (rng.uniform(0.5, 1.5, v.shape) if "var" in str(p[-1])
             else rng.normal(0, 0.2, v.shape)).astype(np.float32)),
        var["batch_stats"])
    state = TrainState(step=jnp.asarray(5, jnp.int32), params=var["params"],
                       batch_stats=stats,
                       opt_state=optax.adamw(1e-3).init(var["params"]))
    jax_save_checkpoint(trainer.cfg.weight, state,
                        meta=dict(epoch=2, best_metric_value=0.5))

    # the port reads it with flax, msgpack, JAX and ao_tpu unimportable
    child = subprocess.run(
        [sys.executable, "-c", _CHILD, trainer.cfg.weight, str(tmp_path / "sd.pt")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert child.returncode == 0, child.stderr[-3000:]
    from_child = torch.load(tmp_path / "sd.pt", weights_only=True)

    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loader = CheckpointLoader()
    loader.trainer = trainer
    loader.before_train()
    want = convert.from_jax_variables(jax.tree_util.tree_map(np.asarray, var["params"]),
                                      jax.tree_util.tree_map(np.asarray, stats))
    got = trainer.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
        assert torch.equal(from_child[k], want[k]), k
    assert not all(torch.equal(before[k], got[k]) for k in got)
    assert trainer.step == 0 and trainer.start_epoch == 0  # weights only

    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(*(batch[k] for k in ("coord", "feat", "mask")))
    jlogits = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, True, True))(
        {"params": var["params"], "batch_stats": stats}, *arrays))
    m = batch["mask"].numpy()
    err = np.abs(logits.numpy()[m] - jlogits[m]).max()
    assert err <= 1e-4 * max(1.0, np.abs(jlogits[m]).max()), err


def test_filter_state_dict_matches_jax():
    sd = {"backbone.enc.0.w": 1, "backbone.dec.0.w": 2, "seg_head.w": 3,
          "module.backbone.x": 4}
    for kw in ({"": ""}, {"module.": ""}, {"backbone.": "net."},
               {"enc": "encoder", "dec": "decoder"}):
        assert filter_state_dict(sd, kw) == jax_filter_state_dict(sd, kw)


def test_resume_continues_epoch_step_and_lr(tmp_path):
    """The entry point stops on max_steps inside its first epoch, whose end
    still runs the CheckpointSaver (model_last.pt, model_best.pt and, with
    save_freq=1, epoch_1.pt); a run with resume=True and weight set to
    model_last.pt starts at the saved epoch and step with the saved
    optimizer, scheduler and best metric, so its first step takes the lr
    the first run would have taken next."""
    hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer"),
             dict(type="InformationWriter"), dict(type="SemSegEvaluator"),
             dict(type="CheckpointSaver", save_freq=1)]
    # decays after step 1 of 4500 (45 steps an epoch, 100 epochs)
    opts = _options(tmp_path, 2, hooks=hooks,
                    scheduler=dict(type="MultiStepLR", milestones=[0.0003, 0.5],
                                   gamma=0.1))
    argv = ["--config-file", chip_smoke.BASE_CONFIG, "--device", "cpu",
            "--options", *opts]
    first = train_main(argv)
    assert first.step == 2 and [r["epoch"] for r in first.history] == [0, 0]
    assert [r["lr"] for r in first.history] == pytest.approx([6e-3, 6e-4],
                                                             rel=1e-12)
    model_dir = tmp_path / "exp" / "model"
    for name in ("model_last.pt", "model_best.pt", "epoch_1.pt"):
        assert (model_dir / name).is_file(), name
    saved = torch.load(model_dir / "model_last.pt", weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 2
    assert saved["best_metric_value"] == first.best_metric_value == 0.0
    next_lr = first.optimizer.param_groups[0]["lr"]

    resumed = train_main(argv[:-len(opts)] + opts + [
        "max_steps=3", "resume=True", f"weight={model_dir / 'model_last.pt'}"])
    assert resumed.start_epoch == 1 and resumed.step == 3
    assert [(r["epoch"], r["lr"]) for r in resumed.history] == [(1, next_lr)]
    assert resumed.best_metric_value == 0.0
    state = resumed.optimizer.state_dict()["state"]
    assert int(next(iter(state.values()))["step"]) == 3


def _assert_same_sample(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("weak,mode", [(True, "pp2s"), (True, "real"),
                                       (False, "pp2s")])
def test_s3dis_weak_modes_match_jax(tmp_path, weak, mode):
    """The port's S3DISDataset returns ao_tpu's dict on a room under
    tmp_path: in the weak modes segment from <weak_path>/<area>/<room>.npy
    (read again on every __getitem__) and instance the original row."""
    room = chip_smoke.make_room(5, (1.0, 0.8, 0.5))
    n = len(room["coord"])
    rng = np.random.default_rng(0)
    room["instance_gt"] = rng.integers(0, 9, n)
    room["normal"] = rng.normal(size=(n, 3)).astype(np.float32)
    os.makedirs(tmp_path / "s3dis" / "Area_2")
    np.savez(tmp_path / "s3dis" / "Area_2" / "office_3.npz", **room)
    os.makedirs(tmp_path / "weak" / "Area_2")
    label_path = tmp_path / "weak" / "Area_2" / "office_3.npy"
    np.save(label_path, rng.integers(-1, 13, n).astype(np.int32))
    kw = dict(split="Area_2", data_root=str(tmp_path / "s3dis"), weak=weak,
              weak_path=str(tmp_path / "weak"), mode=mode, cache=True)
    got, ref = S3DISDataset(**kw), JaxS3DIS(**kw)
    _assert_same_sample(got[0], ref[0])
    if weak:
        np.testing.assert_array_equal(got[0]["segment"], np.load(label_path))
        np.testing.assert_array_equal(got[0]["instance"], np.arange(n))
    # labels rewritten on disk show in the next read
    np.save(label_path, rng.integers(-1, 13, n).astype(np.int32))
    _assert_same_sample(got[0], ref[0])
    if weak:
        np.testing.assert_array_equal(got[0]["segment"], np.load(label_path))
