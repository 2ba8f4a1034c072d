"""The Swin3D configs on the port, on the CPU: keyword parameter groups
(``param_dicts``) with their schedules against ao_tpu's optax
multi_transform step by step, the top-level ``param_dicts`` of the
configs (dropped by ao_tpu's Trainer, taken by the port's, with the same
lr for every parameter under the ScanNet config's OneCycle), and train
steps of the six Swin3D configs through the train entry point at a
reduced size."""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.swin3d.convert import flax_to_torch_state_dict
from ao_tpu_torch.utils import Config
from ao_tpu_torch.utils.optimizer import build_optimizer
from ao_tpu_torch.utils.scheduler import build_scheduler, onecycle_lr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANNET = os.path.join(ROOT, "configs", "scannet", "semseg-swin3d-v1m1-0-small.py")
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
# every Swin3D config at a reduced size: five stages, shifted windows at
# the first two, narrow, 16 slots a window (a 64-slot window's 4096 pairs
# make a CPU step 5x slower)
_TINY = ["model.backbone.channels=(8, 8, 16, 16, 16)",
         "model.backbone.num_heads=(2, 2, 2, 2, 2)",
         "model.backbone.depths=(2, 2, 1, 1, 1)",
         "model.backbone.window_capacity=16",
         "pad_multiple=512", "max_points=4096"]
TINY = dict(type="Swin3D-v1m1", in_channels=9, num_classes=5,
            base_grid_size=0.1, channels=(8, 16), num_heads=(2, 2),
            depths=(2, 1), window_sizes=(3, 3), stage_cap_ratios=(0.6,),
            signal_modes=("xyz", "rgb", "norm"), color_channels=(3, 6),
            normal_channels=(6, 9))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops a step: one intra-op thread (restored after
    the module), so that the test workers' pools do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_GROUPS = {
    # optimizer (with param_dicts), scheduler
    "adamw-multistep-group-lr-and-decay": (
        dict(type="AdamW", lr=0.006, weight_decay=0.05, param_dicts=[
            dict(keyword="table", lr=0.0006),
            dict(keyword="proj", weight_decay=0.0),
            dict(keyword="xyz", lr=0.5)]),  # never wins: "table" matches first
        dict(type="MultiStepLR", milestones=[0.4, 0.8], gamma=0.1)),
    "adamw-onecycle-scalar-max-lr": (
        dict(type="AdamW", lr=0.006, weight_decay=0.05,
             param_dicts=[dict(keyword="table", lr=0.0006)]),
        dict(type="OneCycleLR", max_lr=0.006, pct_start=0.3,
             anneal_strategy="cos", div_factor=10.0, final_div_factor=1000.0)),
}


@pytest.mark.parametrize("case", list(_GROUPS))
def test_param_groups_match_optax(case):
    """The port's parameter groups and per-group schedules against ao_tpu's
    build_optimizer (optax.multi_transform over flax paths, first keyword
    match wins, each group's lr its schedule's base): a tiny Swin3D's
    parameters (ao_tpu's tree, carried across by the converter) after each
    of 5 steps of random gradients, every tensor within 1e-6 of its scale
    (AdamW's f32 arithmetic; the parameters are normal, up to about 4). MultiStepLR takes each group's own lr; OneCycle's scalar
    max_lr peaks every group at 0.006, the table group's lr=0.0006 included.
    The keyword "table" catches the 9 cRSE tables a block in both."""
    opt_cfg, sched_cfg = _GROUPS[case]
    total = 5
    args = [jnp.zeros((1, 64, 3)), jnp.zeros((1, 64, 9)), jnp.ones((1, 64), bool)]
    shapes = jax.eval_shape(jax_build_model(dict(TINY)).init,
                            jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    tx = jax_build_optimizer(dict(opt_cfg), None, dict(sched_cfg), total)
    state = tx.init(params)
    update = jax.jit(tx.update)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    model = build_model(dict(TINY))
    model.load_state_dict(flax_to_torch_state_dict(params), strict=False)
    cfg = dict(opt_cfg)
    opt = build_optimizer(cfg, model, cfg.pop("param_dicts"))
    sched = build_scheduler(dict(sched_cfg), opt, total)
    names = {p: n for n, p in model.named_parameters()}
    assert [len(g["params"]) for g in opt.param_groups][1] == 27
    assert all("table" in names[p] for p in opt.param_groups[1]["params"])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert sum("table" in jax.tree_util.keystr(k) for k, _ in flat) == 27
    for step in range(total):
        grads = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32), shapes)
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = flax_to_torch_state_dict(grads)
        for n, p in model.named_parameters():
            p.grad = tg[n]
        opt.step()
        sched.step()
        want = flax_to_torch_state_dict(_np(jp))
        for n, p in model.named_parameters():
            err = float((p.detach() - want[n]).abs().max())
            assert err <= 1e-6 * max(float(want[n].abs().max()), 1.0), (step, n)
    if "onecycle" in case:
        lrs = {g["lr"] for g in opt.param_groups}
        assert len(lrs) == 1


def test_jax_trainer_drops_top_level_param_dicts(tmp_path, monkeypatch):
    """The Swin3D configs set ``param_dicts`` beside ``optimizer``; ao_tpu's
    Trainer hands only ``cfg.optimizer`` to build_optimizer, so its groups
    are dropped (the optimizer it builds sees no param_dicts), while the
    port's Trainer passes them (two groups, the 54 tables of the six
    blocks of two stages in the second). Under the ScanNet config's
    OneCycle with its scalar max_lr, every parameter's lr is the same in
    both at every step: ao_tpu's single schedule, the port's two groups."""
    import ao_tpu.engines.train as jax_train
    from ao_tpu.utils.config import Config as JaxConfig
    from ao_tpu.utils.optimizer import lr_at_step

    seen = []
    real = jax_train.build_optimizer
    monkeypatch.setattr(jax_train, "build_optimizer",
                        lambda cfg, **kw: seen.append(dict(cfg)) or real(cfg, **kw))
    for name in ("make_train_step", "make_eval_step", "register_hooks"):
        monkeypatch.setattr(jax_train.Trainer, name, lambda self, *a: None)
    monkeypatch.setattr(jax_train.Trainer, "build_state",
                        lambda self: types.SimpleNamespace(params={}))
    monkeypatch.setattr(jax_train.Trainer, "build_train_loader",
                        lambda self: [None] * 40)
    monkeypatch.setattr(jax_train.Trainer, "build_val_loader", lambda self: None)
    monkeypatch.setattr(jax_train, "TensorboardWriter", lambda path: None)
    jcfg = JaxConfig.fromfile(SCANNET)
    jcfg.save_path = str(tmp_path)
    jcfg.eval_epoch = 1
    trainer = jax_train.Trainer(jcfg)
    assert jcfg.param_dicts == [dict(keyword="table", lr=0.0006)]
    assert seen and "param_dicts" not in seen[0]

    cfg = Config.fromfile(SCANNET)
    cfg.model.backbone.depths = (2, 4)
    cfg.model.backbone.channels = (8, 8)
    cfg.model.backbone.num_heads = (2, 2)
    model = build_model(dict(cfg.model))
    opt = build_optimizer(cfg.optimizer, model, cfg.get("param_dicts"))
    sched = build_scheduler(cfg.scheduler, opt, trainer.total_steps)
    assert len(opt.param_groups) == 2 and opt.param_groups[1]["lr"] != 0.006
    assert len(opt.param_groups[1]["params"]) == 54
    s = cfg.scheduler
    for k in range(trainer.total_steps):
        want = lr_at_step(dict(jcfg.scheduler), jcfg.optimizer.lr,
                          trainer.total_steps, k)
        got = [g["lr"] for g in opt.param_groups]
        assert got[0] == pytest.approx(got[1], rel=1e-12)
        assert got[0] == pytest.approx(onecycle_lr(
            k, trainer.total_steps, s.max_lr, s.pct_start, s.div_factor,
            s.final_div_factor), rel=1e-12)
        assert abs(got[0] - want) <= 1e-5 * want  # optax evaluates in f32
        opt.step()
        sched.step()


_CONFIGS = ["scannet/semseg-swin3d-v1m1-0-small.py",
            "scannet/semseg-swin3d-v1m1-1-large.py",
            "s3dis/semseg-swin3d-v1m1-0-small.py",
            "s3dis/semseg-swin3d-v1m1-1-large.py",
            "structured3d/semseg-swin3d-v1m1-0-small.py",
            "structured3d/semseg-swin3d-v1m1-1-large.py"]


def _structured3d_tree(root):
    """Two train rooms in Structured3D's layout, <root>/train/<scene>/
    <room>.pth."""
    for i, seed in enumerate((1, 2)):
        room = chip_smoke.make_scannet_room(seed, (1.0, 0.9, 0.6), 0.05)
        d = os.path.join(root, "train", f"scene_0000{i}")
        os.makedirs(d, exist_ok=True)
        torch.save(dict(coord=room["coord"], color=room["color"],
                        normal=room["normal"],
                        semantic_gt=np.where(room["semantic_gt20"] < 0, -1,
                                             room["semantic_gt20"] + 3)),
                   os.path.join(d, "room_0.pth"))


@pytest.mark.parametrize("config", _CONFIGS)
def test_swin3d_config_trains_on_the_cpu(tmp_path, config):
    """Each Swin3D config takes two train steps through the train entry
    point on the CPU at a reduced size (channels 8-16, 2 heads, depths 2,
    2, 1, 1, 1, 16 slots a window) on synthetic scenes with normals in its
    dataset's layout: in_channels 9 with (coord, color, normal) features
    for S3DIS, 6 with (color, normal) for ScanNet and Structured3D; finite
    losses and gradient norms, each step's lr the config's OneCycle; the
    parameter groups the config's top-level param_dicts give (the tables
    apart for ScanNet and Structured3D, stepped twice)."""
    from ao_tpu_torch.tools.train import main as train_main

    path = os.path.join(ROOT, "configs", config)
    work = str(tmp_path)
    if config.startswith("s3dis"):
        rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2)]
        for r in rooms:
            r["normal"] = chip_smoke.scannet_normals(r["coord"])
        _, options = chip_smoke.train_setup(rooms, work, batch_size=2,
                                            max_steps=2, workers=0)
    elif config.startswith("structured3d"):
        _structured3d_tree(os.path.join(work, "s3d"))
        options = [f"save_path={os.path.join(work, 'exp')}",
                   f"data.train.data_root={os.path.join(work, 's3d')}",
                   "batch_size=2", "max_steps=2", "num_worker=0",
                   "evaluate=False", "enable_tensorboard=False", "mix_prob=0"]
    else:
        rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.05)
                 for s in (1, 2)]
        _, options = chip_smoke.scannet_setup(rooms, workdir=work, batch_size=2,
                                              max_steps=2, workers=0)
    cfg = Config.fromfile(path)
    trainer = train_main(["--config-file", path, "--device", "cpu",
                          "--options", *options, *_TINY])
    backbone = trainer.model.backbone
    assert type(backbone).__name__ == "Swin3D"
    assert backbone.stem_kernel.shape[1] == (9 if "s3dis" in config else 6)
    assert len(trainer.history) == 2
    s = cfg.scheduler
    for k, rec in enumerate(trainer.history):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        lr = onecycle_lr(k, trainer.total_steps, s.max_lr, s.pct_start,
                         s.div_factor, s.final_div_factor)
        assert abs(rec["lr"] - lr) <= 1e-12 * lr
    groups = trainer.optimizer.param_groups
    assert len(groups) == (1 if "s3dis" in config else 2)
    if len(groups) == 2:
        assert len(groups[1]["params"]) == 9 * 7 and groups[1]["lr"] == groups[0]["lr"]
        assert all(trainer.optimizer.state[p]["step"] == 2
                   for p in groups[1]["params"])
    assert [st[:2] for st in backbone.window_stats] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (3, 0), (4, 0)]
