"""The Stratified Transformer and OctFormer configs through the port's train
entry point on the CPU at a reduced size: two train steps of each of the
four configs on synthetic ScanNet rooms, their schedules' lr, parameter
groups and window statistics."""

import os

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# narrow and shallow, 16 slots a window, a few thousand points a scene
_TINY = {
    "st": ["model.backbone.channels=(8, 8, 16, 16, 16)",
           "model.backbone.num_heads=(2, 2, 2, 2, 2)",
           "model.backbone.depths=(2, 1, 1, 1, 1)",
           "model.backbone.window_capacity=16"],
    "st-v1m2": ["model.backbone.channels=(8, 8, 16, 16)",
                "model.backbone.num_heads=(2, 2, 2, 2)",
                "model.backbone.depths=(2, 1, 1, 1)",
                "model.backbone.window_capacity=16",
                "model.backbone.in_channels=6"],
    "octformer": ["model.backbone.channels=(8, 8, 16, 16)",
                  "model.backbone.num_heads=(2, 2, 2, 2)",
                  "model.backbone.depths=(2, 2, 2, 2)"],
}
_CONFIGS = {"scannet/semseg-st-v1m1-0-origin.py": "st",
            "scannet/semseg-st-v1m2-0-refined.py": "st-v1m2",
            "scannet200/semseg-stv1m2-0-refined.py": "st-v1m2",
            "scannet/semseg-octformer-v1m1-0-base.py": "octformer"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops a step: one intra-op thread (restored after the
    module), so that the test workers' pools do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", list(_CONFIGS))
def test_config_trains_on_the_cpu(tmp_path, config):
    """Each config takes two train steps (B=2, Mix3D as written) through the
    train entry point on the CPU at a reduced size (channels 8-16, 2 heads,
    shallow, 4096 points a scene) on synthetic ScanNet rooms (ScanNet200's
    labels for its config): finite losses and gradient norms, each step's
    lr the config's schedule (MultiStepLR; OctFormer's warmup), the
    parameter groups the configs give (OctFormer's "blocks" group empty),
    every block's window statistics after a Stratified step."""
    from ao_tpu_torch.tools.train import main as train_main

    kind = _CONFIGS[config]
    rooms = [chip_smoke.make_scannet_room(s, (1.2, 1.0, 0.8), 0.05) for s in (1, 2)]
    if "scannet200" in config:
        for r in rooms:
            r["semantic_gt200"] = np.where(r["semantic_gt20"] < 0, -1,
                                           r["semantic_gt20"] * 7)
    _, options = chip_smoke.scannet_setup(rooms, workdir=str(tmp_path),
                                          batch_size=2, max_steps=2, workers=0)
    path = os.path.join(ROOT, "configs", config)
    trainer = train_main(["--config-file", path, "--device", "cpu", "--options",
                          *options, "pad_multiple=512", "max_points=4096",
                          *_TINY[kind]])
    backbone = trainer.model.backbone
    assert len(trainer.history) == 2
    if kind == "octformer":
        lr_of = chip_smoke.warmup_multistep_of(trainer)
    else:
        lr_of = chip_smoke.multistep_of(trainer)
    for k, rec in enumerate(trainer.history):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
        assert abs(rec["lr"] - lr_of(k)) <= 1e-12 * lr_of(k)
    groups = trainer.optimizer.param_groups
    if kind == "octformer":
        assert type(backbone).__name__ == "OctFormer"
        assert [len(g["params"]) for g in groups] == [
            len(list(trainer.model.parameters())), 0]
        assert groups[1]["lr"] / groups[0]["lr"] == pytest.approx(0.1)
    else:
        assert type(backbone).__name__ == "StratifiedTransformer"
        assert len(groups) == 1
        assert [s[:2] for s in backbone.window_stats] == [
            (s, d) for s, n in enumerate(backbone.depths) for d in range(n)]
        assert all(0 < int(s[2]) <= int(s[3]) for s in backbone.window_stats)
