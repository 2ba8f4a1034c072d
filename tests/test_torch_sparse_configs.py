"""The sparse-convolution configs on the port, on the CPU at tiny widths:
SGD and Adam against optax step by step, Structured3DDataset against
ao_tpu's, the trainer handing the batch's discrete_coord to the backbone,
two (three) train steps of seven SpUNet / MinkUNet / SPVCNN configs
through the train entry point (the precise-eval config then runs its
tester, the profiler config writes its trace) and whole-scene testing of
the ScanNet SpUNet config through the test entry point."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ao_tpu_torch.datasets import build_dataset
from ao_tpu_torch.models.sparse_unet.spunet import voxel_coords
from ao_tpu_torch.utils.optimizer import build_optimizer
from ao_tpu_torch.utils.scheduler import onecycle_lr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANNET = os.path.join(ROOT, "configs", "scannet", "semseg-spunet-v1m1-0-base.py")
# every sparse backbone at a tiny width
_TINY = ["model.backbone.base_channels=8",
         "model.backbone.channels=(8, 8, 16, 16, 16, 8, 8, 8)",
         "model.backbone.layers=(1, 1, 1, 1, 1, 1, 1, 1)",
         "pad_multiple=512", "max_points=4096"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny sparse models run thousands of small ops: one intra-op
    thread each (restored after the module), so that the test workers'
    thread pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cfg,chain", [
    (dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=True),
     lambda c: optax.chain(optax.add_decayed_weights(c["weight_decay"]),
                           optax.sgd(c["lr"], momentum=c["momentum"],
                                     nesterov=True))),
    (dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.0),
     lambda c: optax.sgd(c["lr"], momentum=c["momentum"])),
    (dict(type="Adam", lr=0.002, weight_decay=0.005),
     lambda c: optax.chain(optax.add_decayed_weights(c["weight_decay"]),
                           optax.adam(c["lr"]))),
], ids=["sgd-nesterov-wd", "sgd", "adam-wd"])
def test_sgd_and_adam_match_optax(cfg, chain):
    """The port's SGD and Adam as built from a config against the JAX
    package's optax chains (ao_tpu/utils/optimizer.py: the weight decay
    added to the gradient, then sgd / adam), over four steps of random
    gradients of three scales: the parameters within 1e-6 (measured up to
    2.4e-7) after every step."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    grads = [rng.normal(size=(4, 6)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 0.5)]
    tx = chain(cfg)
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    model = torch.nn.Linear(6, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = build_optimizer(dict(cfg), model)
    assert type(opt).__name__ == cfg["type"]
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        model.weight.grad = torch.from_numpy(g.copy())
        opt.step()
        assert np.abs(model.weight.detach().numpy() - np.asarray(jp["w"])).max() < 1e-6


def _structured3d_tree(root):
    """Rooms in Structured3D's layout, <root>/<split>/<scene>/<room>.pth
    (and one .npz), from synthetic ScanNet rooms relabelled to 25 classes;
    returns the rooms."""
    rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.06)
             for s in (1, 2, 3)]
    layout = [("train", "scene_00000", "room_1", ".pth"),
              ("train", "scene_00007", "room_0", ".npz"),
              ("val", "scene_03250", "room_2", ".pth")]
    for room, (split, scene, name, ext) in zip(rooms, layout):
        d = os.path.join(root, split, scene)
        os.makedirs(d, exist_ok=True)
        data = dict(coord=room["coord"], color=room["color"],
                    normal=room["normal"],
                    semantic_gt=np.where(room["semantic_gt20"] < 0, -1,
                                         room["semantic_gt20"] + 3))
        if ext == ".pth":
            torch.save(data, os.path.join(d, name + ext))
        else:
            np.savez(os.path.join(d, name + ext), **data)
    return rooms


@pytest.mark.parametrize("split", ["train", "val", ("train", "val")])
def test_structured3d_dataset_matches_jax(tmp_path, split):
    """Structured3DDataset's scene list (one directory deeper than
    DefaultDataset's, .pth and .npz) and names (<scene>_<room>) equal
    ao_tpu's on a written tree."""
    from ao_tpu.datasets.misc_datasets import Structured3DDataset as JS3D

    _structured3d_tree(str(tmp_path))
    ds = build_dataset(dict(type="Structured3DDataset", split=split,
                            data_root=str(tmp_path)))
    jds = JS3D(split=split, data_root=str(tmp_path))
    assert ds.data_list == jds.data_list and len(ds) == {
        "train": 2, "val": 1}.get(split, 3)
    names = [ds.get_data_name(i) for i in range(len(ds))]
    assert names == [jds.get_data_name(i) for i in range(len(jds))]
    assert "scene_00000_room_1" in names or split == "val"


def _scannet_rooms(n=4):
    return [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.05)
            for s in range(1, n + 1)]


def test_trainer_feeds_discrete_coord_to_the_backbone(tmp_path):
    """A train step of the ScanNet SpUNet config reaches the backbone with
    the batch's discrete_coord: the step's logits equal the backbone's
    (in train mode, from the weights before the step) called with it, and
    differ from the backbone's without it, which voxelises at one
    coordinate unit (the fallback the JAX package's engine takes); the
    evaluator's eval_batch feeds it as well."""
    rooms = _scannet_rooms(2)
    _, options = chip_smoke.scannet_setup(rooms, workdir=str(tmp_path),
                                          batch_size=2, max_steps=1, workers=0)
    trainer = chip_smoke.build_trainer(options + _TINY + ["mix_prob=0"], "cpu",
                                       SCANNET)
    batch = next(iter(trainer.train_loader))
    assert "discrete_coord" in batch
    with_dc, without = (copy.deepcopy(trainer.model.backbone).train()
                        for _ in range(2))
    _, logits = trainer._step(batch)
    inputs = {k: batch[k] for k in ("coord", "feat", "mask")}
    mask = batch["mask"]
    with torch.no_grad():
        with_dc = with_dc(**inputs, discrete_coord=batch["discrete_coord"])
        without = without(**inputs)
    assert torch.equal(logits[mask], with_dc[mask])
    assert (logits[mask] - without[mask]).abs().max() > 1e-2
    # GridSample's sites are the points; the fallback's 1-unit cells hold
    # the whole scene in a few
    for b in range(2):
        m = mask[b]
        assert len(torch.unique(batch["discrete_coord"][b][m], dim=0)) == int(m.sum())
        assert len(torch.unique(voxel_coords(*(inputs[k][b:b + 1] for k in (
            "coord", "mask")))[0][m], dim=0)) < 10
    trainer.model.eval()
    calls = []
    handle = trainer.model.backbone.register_forward_pre_hook(
        lambda m, a, kw: calls.append(kw.get("discrete_coord")), with_kwargs=True)
    trainer.eval_batch(batch)
    handle.remove()
    assert torch.equal(calls[0], batch["discrete_coord"])


def _check_lr(trainer):
    s = trainer.cfg.scheduler
    for k, rec in enumerate(trainer.history):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        if s.type == "OneCycleLR":
            lr = onecycle_lr(k, trainer.total_steps, s.max_lr, s.pct_start,
                             s.div_factor, s.final_div_factor)
        else:  # PolyLR
            lr = trainer.cfg.optimizer.lr * (1 - k / (trainer.total_steps + 1)) ** s.power
        assert abs(rec["lr"] - lr) <= 1e-12 * lr, (k, rec["lr"], lr)


_CONFIGS = ["scannet/semseg-spunet-v1m1-0-base.py",
            "s3dis/semseg-minkunet34c-0-base.py",
            "s3dis/semseg-spunet-v1m2-0-base.py",
            "semantic_kitti/semseg-spvcnn-v1m1-0-base.py",
            "structured3d/semseg-spunet-v1m1-0-base.py",
            "scannet/semseg-spunet-v1m1-1-precise-eval.py",
            "scannet/semseg-spunet-v1m1-3-enable-profiler.py"]


_CLASS = {"SpUNet-v1m1": "SpUNet", "SpUNet-v1m2": "SpUNet",
          "MinkUNet34C": "SpUNet", "SPVCNN": "SPVCNN"}


@pytest.mark.parametrize("config", _CONFIGS)
def test_sparse_config_trains_on_the_cpu(tmp_path, config):
    """Each config takes two train steps (the profiler config three, so
    that its window opens at iteration 2) through the train entry point on
    the CPU at tiny widths on synthetic scenes in its dataset's layout:
    the backbone and optimizer the config names, finite losses and
    gradient norms, each step's lr the config's schedule (OneCycle, or
    PolyLR for MinkUNet34C). ScanNet merges a batch by Mix3D within three
    draws of its 0.8; the precise-eval config then tests the val scene
    from model_best.pt with the config's 10 views; the profiler config
    writes its trace."""
    from ao_tpu_torch.tools.train import main as train_main

    steps = 3 if "profiler" in config else 2
    path = os.path.join(ROOT, "configs", config)
    work = str(tmp_path)
    extra = []
    if config.startswith("s3dis"):
        rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2)]
        _, options = chip_smoke.train_setup(rooms, work, batch_size=2,
                                            max_steps=steps, workers=0)
    elif config.startswith("semantic_kitti"):
        scans = [chip_smoke.make_scan(30 + i, beams=16, steps=256) for i in range(2)]
        chip_smoke.outdoor_setup(scans, workdir=work)
        options = chip_smoke.kitti_options(work, 2, 2, steps, workers=0)
    elif config.startswith("structured3d"):
        _structured3d_tree(os.path.join(work, "s3d"))
        options = [f"save_path={os.path.join(work, 'exp')}",
                   f"data.train.data_root={os.path.join(work, 's3d')}",
                   "batch_size=2", f"max_steps={steps}", "num_worker=0",
                   "evaluate=False", "enable_tensorboard=False", "mix_prob=0"]
    else:
        _, options = chip_smoke.scannet_setup(
            _scannet_rooms(4), _scannet_rooms(1)[0], workdir=work, batch_size=2,
            max_steps=steps, workers=0)
        extra = [f"data.test.data_root={os.path.join(work, 'scannet')}"]
    trainer = train_main(["--config-file", path, "--device", "cpu",
                          "--options", *options, *_TINY, *extra])
    backbone = trainer.model.backbone
    assert type(backbone).__name__ == _CLASS[trainer.cfg.model.backbone.type]
    assert type(trainer.optimizer).__name__ == trainer.cfg.optimizer.type
    assert len(trainer.history) == steps
    _check_lr(trainer)
    assert backbone.stage_overflow.shape == (4,)
    if config == "scannet/semseg-spunet-v1m1-0-base.py":
        assert trainer.cfg.mix_prob == 0.8
        assert any(r["scenes"] < 2 for r in trainer.history)  # a Mix3D pair
    if "precise" in config:
        res = trainer.comm_info["precise_result"]
        assert np.isfinite(res["mIoU"]) and len(res["scenes"]) == 1
        votes = np.load(os.path.join(work, "exp", "result", "scene0000_00_pred.npy"))
        chip_smoke.check_votes(votes, 10, num_classes=20)
    if "profiler" in config:
        trace = os.path.join(work, "exp", "profile", "trace.json")
        assert os.path.getsize(trace) > 0


def test_minkunet34c_scheduler_takes_its_bases_onecycle_keys():
    """configs/s3dis/semseg-minkunet34c-0-base.py replaces its base's
    OneCycleLR by PolyLR without ``_delete_``, so the merged scheduler
    carries OneCycle's keys: the JAX package's PolyLR raises on them (the
    config cannot train there); the port's takes and ignores them, and its
    lr is PolyLR's."""
    from ao_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
    from ao_tpu_torch.utils import Config
    from ao_tpu_torch.utils.scheduler import build_scheduler

    cfg = Config.fromfile(os.path.join(ROOT, "configs", "s3dis",
                                       "semseg-minkunet34c-0-base.py"))
    assert cfg.scheduler.type == "PolyLR" and "max_lr" in cfg.scheduler
    with pytest.raises(TypeError, match="max_lr"):
        jax_build_scheduler(dict(cfg.scheduler), 0.1, 100)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    sched = build_scheduler(dict(cfg.scheduler), opt, 100)
    for k in range(3):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            0.1 * (1 - k / 101) ** 0.9, rel=1e-12)
        opt.step()
        sched.step()


def test_scannet_spunet_whole_scene_test(tmp_path):
    """Whole-scene testing of a synthetic ScanNet room through the test
    entry point with the ScanNet SpUNet config's test_cfg (10 views,
    GridSample at 0.02 m in test mode, discrete_coord collected) on tiny
    random weights: every point gets a whole softmax row from every view,
    and the fragments reach the backbone with their discrete_coord."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.models.sparse_unet import SpUNet
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config, DictAction

    room = _scannet_rooms(1)[0]
    workdir, _ = chip_smoke.scannet_setup([room], room, workdir=str(tmp_path))
    cfg = Config.fromfile(SCANNET)
    cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in
                         (o.partition("=")[::2] for o in _TINY)})
    torch.manual_seed(0)
    torch.save(build_model(dict(cfg.model)).state_dict(), tmp_path / "model.pt")
    seen = []
    orig = SpUNet.forward

    def forward(self, *args, discrete_coord=None):
        seen.append(discrete_coord is not None)
        return orig(self, *args, discrete_coord=discrete_coord)

    SpUNet.forward = forward
    try:
        result = test_main([
            "--config-file", SCANNET, "--device", "cpu", "--options",
            f"weight={tmp_path / 'model.pt'}", f"save_path={tmp_path / 'test'}",
            f"data.test.data_root={os.path.join(workdir, 'scannet')}", *_TINY])
    finally:
        SpUNet.forward = orig
    votes = np.load(tmp_path / "test" / "result" / "scene0000_00_pred.npy")
    assert votes.shape[0] == len(room["coord"])
    chip_smoke.check_votes(votes, 10, num_classes=20)
    assert seen and all(seen) and np.isfinite(result["mIoU"])
