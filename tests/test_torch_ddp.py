"""Data parallelism of ao_tpu_torch on the CPU: two gloo processes started
by the port's launcher (engines/launch.py), each in a child process with
its own timeout (tests/torch_ddp_jobs.py), one intra-op thread each.

* comm under an initialised two-process group, the train sampler's shards
  (disjoint, together each epoch) and REAL's basket gather;
* the BatchNorm statistics over the global batch: train-mode GVA through
  K4 / K5 / K3 / K6's plain versions (float64) and through the unfused
  reference, PointBatchNorm and every per-point loss, and the Lovasz loss
  over the global batch, one scene a process, against one process on both
  scenes;
* a PT-v2m2 train step over two processes (one scene each) against
  ao_tpu's jitted step on the same two scenes over its mesh of the 8 CPU
  devices of tests/conftest.py, and the port's two-process trainer (its
  loader, steps, SemSegEvaluator, checkpoint) against its own one-process
  run on the same global batch, for PT-v2m2 and for SpUNet; a doubled and
  an unreduced gradient (chip_smoke.plant_fault) outside the band that
  chip_smoke.py phase 17 holds the card's runs in;
* the train and test entry points with ``--num-devices 2``.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.engines.train import Trainer as JaxTrainer
from ao_tpu.engines.train import TrainState
from ao_tpu.models import build_criteria as jax_build_criteria
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.utils.optimizer import build_optimizer as jax_build_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, "tests", "torch_ddp_jobs.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_ddp_jobs as jobs  # noqa: E402

ROOM = (0.9, 0.8, 0.6)
SGD = {"type": "SGD", "lr": 0.1, "momentum": 0.9, "weight_decay": 0.0}
# no random augmentation, so that a scene is the same batch row whichever
# process loads it (chip_smoke.SeededItems seeds the rest)
PLAIN_TRANSFORM = [
    dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor"),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "segment"), feat_keys=["coord", "color"])]
LOVASZ_CONFIG = os.path.join(ROOT, "configs", "scannet",
                             "semseg-pt-v2m2-3-lovasz.py")
SPUNET = dict(type="DefaultSegmentor", backbone=dict(
    _delete_=True, type="SpUNet-v1m1", in_channels=6, num_classes=13, base_channels=8,
    channels=(8, 8, 16, 16, 16, 8, 8, 8), layers=(1,) * 8),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _job(args, seconds):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(["timeout", "-k", "5", str(seconds), sys.executable,
                          JOBS, *args], cwd=ROOT, env=env, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-4000:]


# ------------------------------------------------------------------ units


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("units"))
    _job(["units", out], 120)
    return [torch.load(os.path.join(out, f"units{r}.pt"), weights_only=False)
            for r in range(2)]


def test_comm_under_a_two_process_group(units):
    """Every helper of utils/comm.py with a gloo group of two: world, rank,
    local rank; object gathers in rank order (gather on process 0 only);
    one shared seed; reduce_dict's mean and sum; all_reduce; all_reduce_grad
    and its backward (each process's gradient is the sum of both processes'
    upstream gradients); broadcast_ of two dtypes from process 0."""
    for r, u in enumerate(units):
        assert (u["world"], u["rank"], u["local_rank"], u["main"]) == (2, r, r, r == 0)
        assert u["all_gather"] == [{"rank": 0, "s": ""}, {"rank": 1, "s": "x"}]
        assert u["gather"] == ([0, 10] if r == 0 else [])
        assert u["reduce_mean"] == {"a": 0.5, "b": 2.0}
        assert u["reduce_sum"] == {"a": 1.0}
        assert u["all_reduce"] == [2.0, 1.0]
        assert u["all_reduce_grad"] == ([3.0, 4.0], [2.0, 7.0])
        assert u["broadcast"] == ([0.0] * 3, [0, 0])
    assert units[0]["seed"] == units[1]["seed"]


def test_train_sampler_shards_are_disjoint_and_cover_each_epoch(units):
    """engines/train.py's train_sampler over 11 items and two processes:
    each epoch the shards are disjoint, of equal length, together the
    epoch's permutation less its odd item, and the permutation changes with
    the epoch."""
    epochs = []
    for e in range(3):
        a, b = (u["sampler"][e] for u in units)
        assert len(a) == len(b) == 5 and not set(a) & set(b)
        assert set(a) | set(b) <= set(range(11))
        epochs.append(a + b)
    assert epochs[0] != epochs[1]


def test_real_basket_gather(units):
    """REAL's basket merge on process 0 after the gather: each scene's rows
    filled by either process, -100 where neither filled one."""
    b = units[0]["basket"]
    np.testing.assert_array_equal(b["a/r0"][:, 0], [1, 2, 1, 2, 1, 2])
    np.testing.assert_array_equal(b["b/r1"][:, 0], [5, 6, -100, -100, -100, -100])
    assert units[1]["basket"] is None


@pytest.mark.parametrize("path,tol", [("kernels", 1e-10), ("reference", 1e-5)])
def test_gva_statistics_over_two_processes(units, path, tol):
    """Train-mode GVA with one scene a process against one process on both:
    ``kernels`` is gva_train (K4's position moments and K5's weight-BN sums
    all-reduced before the folds, K6's statistic gradient summed before the
    input correction) on the plain versions in float64, where they evaluate
    the exact algebra, within 1e-10 of scale; ``reference`` is the unfused
    gva_reference (differentiable all-reduces of the masked moments) in
    float32 within 1e-5. Outputs, both BatchNorms' statistics, the
    k / v / q gradients of each scene, and the parameter gradients summed
    over the processes (the step's reduction). Collectives a process: three
    on the kernel path (K4's moments, K5's sums, the statistics' gradient),
    five on the reference (the position moments, [sum | count] and the
    squared deviations, the last two also in the backward)."""
    c = jobs.gva_case()
    ref = jobs.gva_grads(c, [0, 1])[path]
    got = [u["gva"][path] for u in units]
    for key in ("mu", "var", "mu_p", "var_p"):
        for g in got:
            torch.testing.assert_close(g[key], ref[key], rtol=tol, atol=tol)
    assert all(g["n"] == ref["n"] for g in got)
    out = torch.cat([g["out"] for g in got])
    torch.testing.assert_close(out, ref["out"], rtol=tol, atol=tol)
    for i, r in enumerate(ref["grads"]):
        g = (torch.cat([x["grads"][i] for x in got]) if i < 3
             else sum(x["grads"][i] for x in got))
        scale = max(float(r.abs().max()), 1.0)
        assert float((g - r).abs().max()) < tol * scale, (path, i)
    assert units[0]["gva_collectives"] == 3 + 5


def test_batchnorm_and_losses_over_two_processes(units):
    """PointBatchNorm in train mode on one masked scene a process against
    one process on both (it computes in float32): output, running mean and
    (unbiased) variance, the input gradient and the affine gradients
    (summed over the processes) within 1e-5; every per-point loss (CE,
    class-weighted CE, SmoothCE, Focal) and Dice: the sum of the processes'
    values within 1e-6 of the one-process loss (measured up to 3.0e-7), the
    logits gradients within 1e-6 (measured up to 9.3e-10)."""
    c = jobs.gva_case()
    ref = jobs.bn_and_losses(c, [0, 1])
    got = [u["bn"] for u in units]
    for key in ("y", "gx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]), ref[key],
                                   rtol=1e-5, atol=1e-5)
    for key in ("gw", "gb"):
        torch.testing.assert_close(sum(g[key] for g in got), ref[key],
                                   rtol=1e-5, atol=1e-5)
    for key in ("running_mean", "running_var"):
        for g in got:
            torch.testing.assert_close(g[key], ref[key], rtol=1e-5, atol=1e-5)
    for key in [k for k in ref if k.startswith("{")]:
        value, grad = ref[key]
        assert abs(sum(g[key][0] for g in got) - value) < 1e-6, key
        torch.testing.assert_close(torch.cat([g[key][1] for g in got]), grad,
                                   rtol=1e-5, atol=1e-6)


def test_lovasz_over_two_processes(units):
    """LovaszLoss in a train step's global batch over two gloo processes,
    40 and 33 points (the shorter one padded in the gather), against one
    process on the 73 points: the sum of the processes' values within
    1e-6 of the one-process loss and the concatenated logits gradients
    within 1e-5 of their scale; two collectives a process (the lengths,
    then the errors and foreground)."""
    c = jobs.gva_case()
    value, grad = jobs.lovasz(c, [0, 1])
    got = [u["lovasz"] for u in units]
    assert abs(sum(v for v, _ in got) - value) < 1e-6
    g = torch.cat([x for _, x in got])
    assert g.shape == grad.shape == (sum(jobs.LOVASZ_POINTS), 5)
    assert float((g - grad).abs().max()) < 1e-5 * float(grad.abs().max())
    assert all(u["lovasz_collectives"] == 2 for u in units)


# ------------------------------------------------------------------- runs


def _backbone(**kw):
    """The tiny PT-v2m2 of __graft_entry__ in f32 without stochastic depth
    (so that no process draws), with the widths ``kw``."""
    backbone = _flagship_cfg(tiny=True)["backbone"]
    backbone.update(drop_path_rate=0.0, compute_dtype=None, **kw)
    return f"model.backbone={backbone!r}"


def _ptv2_options(root, save, steps=2):
    """Two small rooms as the train split and a third as the validation
    split, both without random transforms, the tiny PT-v2m2, SGD, one step
    an epoch (a global batch of both scenes), ``steps`` steps."""
    rooms = [chip_smoke.make_room(s, ROOM) for s in (1, 2)]
    val = chip_smoke.make_room(5, ROOM)
    _, options = chip_smoke.train_setup(rooms, root, batch_size=2,
                                        max_steps=steps, workers=0, seed=3,
                                        val_room=val)
    return options + [
        _backbone(), "pad_multiple=4096", "epoch=2",
        "eval_epoch=2", f"optimizer={SGD!r}",
        f"data.train.transform={PLAIN_TRANSFORM!r}",
        f"data.val.transform={PLAIN_TRANSFORM!r}", f"save_path={save}"]


# the ScanNet scenes' transform without random augmentation: the config's
# nine input channels (coord, colour, normal)
SCANNET_TRANSFORM = PLAIN_TRANSFORM[:3] + [dict(
    type="Collect", keys=("coord", "segment"),
    feat_keys=["coord", "color", "normal"])]


def _lovasz_options(root, save, steps=2):
    """Two small ScanNet rooms as the train split of
    configs/scannet/semseg-pt-v2m2-3-lovasz.py (CE + Lovasz criteria) and a
    third as its validation split, without random transforms or Mix3D, the
    tiny PT-v2m2 at the config's 9 input channels and 20 classes, SGD, one
    step an epoch (a global batch of both scenes), ``steps`` steps."""
    rooms = [chip_smoke.make_scannet_room(s, ROOM, 0.05) for s in (1, 2, 5)]
    _, options = chip_smoke.scannet_setup(rooms[:2], rooms[2], root,
                                          batch_size=2, max_steps=steps,
                                          workers=0, seed=3)
    return options + [
        _backbone(in_channels=9, num_classes=20), "pad_multiple=4096",
        "max_points=102400", "mix_prob=0.0", "data.train.loop=1", "epoch=2",
        "eval_epoch=2", "evaluate=True", f"optimizer={SGD!r}",
        f"data.val.data_root={os.path.join(root, 'scannet')}",
        f"data.train.transform={SCANNET_TRANSFORM!r}",
        f"data.val.transform={SCANNET_TRANSFORM!r}", f"save_path={save}"]


def _jax_init(cfg):
    """The JAX model initialised on the two train scenes collated as one
    batch (as the port's dataset and collate make them): (model, params,
    batch_stats)."""
    from ao_tpu_torch.datasets import build_dataset, point_collate_fn

    ds = build_dataset(cfg.data.train)
    batch = point_collate_fn([ds[0], ds[1]], pad_multiple=4096)
    jmodel = jax_build_model(cfg.to_dict()["model"])
    arrays = [jnp.asarray(batch[k].numpy()) for k in ("coord", "feat", "mask")]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *arrays)
    return jmodel, variables["params"], variables["batch_stats"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The recorded runs: PT-v2m2 (starting from the JAX model's initial
    weights) and SpUNet over two processes and one, then tools.train and
    tools.test with --num-devices 2."""
    from ao_tpu_torch.engines import default_config_parser
    from ao_tpu_torch.models.point_transformer_v2 import convert
    from ao_tpu_torch.utils import DictAction

    root = str(tmp_path_factory.mktemp("runs"))
    base = _ptv2_options(os.path.join(root, "data"), os.path.join(root, "init"))
    models = {}
    for name, config, opts in (
            ("ptv2", chip_smoke.BASE_CONFIG, base),
            ("lovasz", LOVASZ_CONFIG, _lovasz_options(
                os.path.join(root, "scannet"), os.path.join(root, "init")))):
        cfg = default_config_parser(config, {
            k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in opts)})
        jmodel, params, stats = _jax_init(cfg)
        weight = os.path.join(root, f"init_{name}.pt")
        torch.save(convert.from_jax_variables(_np(params), _np(stats)), weight)
        models[name] = dict(cfg=cfg, jmodel=jmodel, params=params,
                            stats=stats, weight=weight, config=config,
                            options=opts)
    weight = models["ptv2"]["weight"]
    spec = []
    for name, config, opts in (
            ("ptv2", chip_smoke.BASE_CONFIG,
             base + [f"weight={weight}", "record_batches=True"]),
            ("spunet", chip_smoke.BASE_CONFIG, base + [f"model={SPUNET!r}"]),
            ("lovasz", LOVASZ_CONFIG, models["lovasz"]["options"] + [
                f"weight={models['lovasz']['weight']}", "record_batches=True"])):
        for world in (2, 1):
            spec.append(dict(kind="recorded", name=f"{name}{world}", world=world,
                             config=config,
                             options=opts + [f"save_path={root}/{name}{world}"]))
    for fault in chip_smoke.DDP_FAULTS:
        spec.append(dict(kind="recorded", name=f"fault_{fault}2", world=2,
                         config=chip_smoke.BASE_CONFIG, options=base + [
                             f"weight={weight}", f"record_fault={fault}",
                             f"save_path={root}/fault_{fault}2"]))
    test_data = os.path.join(root, "data", "s3dis_val")
    chip_smoke.np.savez(os.path.join(test_data, "Area_5", "office_w.npz"),
                        **chip_smoke.make_room(6, ROOM))
    cli = ["--config-file", chip_smoke.BASE_CONFIG, "--device", "cpu",
           "--num-devices", "2"]
    spec.append(dict(kind="train", argv=cli + ["--options", *base[:-1],
                                               "max_steps=1",
                                               f"save_path={root}/cli"]))
    spec.append(dict(kind="test", argv=cli + [
        "--options", f"save_path={root}/cli", f"data.test.data_root={test_data}",
        "data.test.test_cfg.aug_transform=[[]]", _backbone(),
        "pad_multiple=4096"]))
    with open(os.path.join(root, "runs.json"), "w") as f:
        json.dump(spec, f)
    _job(["runs", root, os.path.join(root, "runs.json")], 300)

    def load(name):
        return [torch.load(os.path.join(root, name, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(int(name[-1]))]

    return dict(root=root, models=models,
                **{n: load(n) for n in ("ptv2" + "2", "ptv2" + "1",
                                        "spunet2", "spunet1", "lovasz2",
                                        "lovasz1")},
                faults={f: load(f"fault_{f}2") for f in chip_smoke.DDP_FAULTS})


def _hold_to_jax_mesh(runs, name):
    """Step 1 of the two-process run ``name`` against ao_tpu's jitted train
    step on the same two scenes over its mesh of 8 CPU devices, from the
    same weights: the loss within 1e-5 relative, the running statistics
    within 1e-5 of their scale, the parameters within 2e-2 of the step's
    change (compare_records)."""
    from ao_tpu_torch.models.point_transformer_v2 import convert

    m = runs["models"][name]
    cfg = m["cfg"].to_dict()
    r0, r1 = (r["steps"][0] for r in runs[name + "2"])
    keys = ("coord", "feat", "mask", "segment")
    n = max(r0["batch"]["mask"].shape[1], r1["batch"]["mask"].shape[1])

    def pad(x):
        return np.pad(x.numpy(), [(0, 0), (0, n - x.shape[1])]
                      + [(0, 0)] * (x.dim() - 2),
                      constant_values=-1 if x.dtype != torch.bool and
                      x.dim() == 2 and x.dtype != torch.float32 else 0)

    batch = {k: np.concatenate([pad(r0["batch"][k]), pad(r1["batch"][k])])
             for k in keys}
    jt = object.__new__(JaxTrainer)
    jt.model = m["jmodel"]
    jt.criteria = jax_build_criteria(cfg["model"]["criteria"])
    jt.tx = jax_build_optimizer(dict(cfg["optimizer"]), None,
                                dict(cfg["scheduler"]), 2)
    jt.mesh = jt.build_mesh()
    assert jt.mesh.devices.size == 8
    jt.cfg = m["cfg"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=m["params"],
                       batch_stats=m["stats"], opt_state=jt.tx.init(m["params"]))
    state, metrics = jt.make_train_step()(state, jt.put_batch(batch),
                                          jax.random.PRNGKey(0))
    assert abs(r0["loss"] - float(metrics["loss"])) < 1e-5 * abs(r0["loss"])
    sd = convert.from_jax_variables(_np(state.params), _np(state.batch_stats))
    jax_rec = dict(init=runs[name + "2"][0]["init"], steps=[dict(
        loss=float(metrics["loss"]),
        params={k: torch.from_numpy(np.asarray(sd[k])) for k in r0["params"]},
        stats={k: torch.from_numpy(np.asarray(sd[k])) for k in r0["stats"]})])
    row = chip_smoke.compare_records(runs[name + "2"][0], jax_rec)[0]
    assert row["params"] < 2e-2, row
    for k, v in r0["stats"].items():
        ref = np.asarray(sd[k])
        assert np.abs(v.numpy() - ref).max() < 1e-5 * max(np.abs(ref).max(), 1.0), k
    return row, float(metrics["loss"])


def test_ptv2_step_over_two_processes_matches_jax_mesh(runs):
    """The port's PT-v2m2 train step over two gloo processes, one scene
    each, against ao_tpu's jitted train step on the same two scenes (the
    processes' own batches, stacked) over its data mesh of 8 CPU devices
    (tests/conftest.py; the two scenes padded with six empty ones), from
    the same weights, SGD: the loss within 1e-5 relative (measured
    4.9e-7), the running statistics of every PointBatchNorm and GVA
    BatchNorm within 1e-5 of their scale (measured 8.4e-7), and the
    parameters after the step within 2e-2 of the step's own change of each
    tensor in Frobenius norm (compare_records, floored for tensors that
    barely move; measured 2.1e-3): the jitted JAX gradients move by up to
    ~1e-2 of their norm with f32 rounding (test_torch_train_step.py)."""
    _hold_to_jax_mesh(runs, "ptv2")


def test_lovasz_step_over_two_processes_matches_jax_mesh(runs):
    """configs/scannet/semseg-pt-v2m2-3-lovasz.py's step (cross-entropy +
    Lovasz, the Lovasz term over the global batch: each process's errors
    sorted with the other's) over two gloo processes at a tiny width
    against ao_tpu's jitted step on its 8-device mesh, in the band of
    test_ptv2_step_over_two_processes_matches_jax_mesh."""
    row, loss = _hold_to_jax_mesh(runs, "lovasz")
    assert loss > 0 and np.isfinite(loss)


@pytest.mark.parametrize("name", ["ptv2", "spunet"])
def test_two_processes_equal_one(runs, name):
    """The port's trainer over two gloo processes (DistributedSampler
    shards, one scene a process) against one process on the same global
    batch of two scenes, 2 steps (one an epoch, each ending with the
    SemSegEvaluator on the two validation scenes and the CheckpointSaver), for
    the tiny PT-v2m2 and a tiny SpUNet (its sparse convolutions'
    PointBatchNorms): per step the loss within 1e-5 relative (measured 0
    and 2.8e-7), the parameters within 2e-3 of the step's own change
    (compare_records; measured 1.9e-4 and 1.7e-5) and the running
    statistics within 1e-4 (measured 3.5e-6 and 2.0e-6); both processes
    equal after every step; every step of a process makes collectives and
    the one-process run none; the validation metrics (the evaluator sums
    both processes' histograms) within 2e-3 (measured equal)."""
    two, one = runs[name + "2"], runs[name + "1"]
    assert len(one[0]["steps"]) == 2 == len(two[0]["steps"])
    for rec in two:
        for row in chip_smoke.compare_records(rec, one[0]):
            assert row["loss_rel"] < 1e-5, row
            assert row["params"] < 2e-3 and row["stats"] < 1e-4, row
        assert all(s["collectives"] > 0 for s in rec["steps"])
    for a, b in zip(*(r["steps"] for r in two)):
        assert a["loss"] == b["loss"]
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), k
    assert all(s["collectives"] == 0 for s in one[0]["steps"])
    va, vb = two[0]["val"], one[0]["val"]
    assert va["batches"] == vb["batches"] == 2
    assert {k: v for k, v in two[1]["val"].items() if k != "seconds"} == {
        k: v for k, v in va.items() if k != "seconds"}
    for k in ("mIoU", "mAcc", "allAcc"):
        assert abs(va[k] - vb[k]) < 2e-3, (name, k, va, vb)


def test_lovasz_two_processes_equal_one(runs):
    """The ScanNet Lovasz config's tiny PT-v2m2 over two gloo processes
    against one process on the same global batch, 2 steps (one an epoch,
    each ending with the SemSegEvaluator): per step the loss within 1e-5
    relative (measured 6.0e-8), the parameters with every tensor together
    within 2e-3 of the step's change (measured 4.1e-4 and 4.3e-4), the worst
    tensor within 2e-2 (measured 8.0e-3: BatchNorm weights that move by
    1e-5 at step 1, on the floor of compare_records; the same run with the
    cross-entropy alone measures 6.8e-3, so the ScanNet scenes set it, not
    the Lovasz term) and the running statistics within 1e-4; both
    processes equal after every step; the validation metrics within 2e-3."""
    two, one = runs["lovasz2"], runs["lovasz1"]
    assert len(one[0]["steps"]) == 2 == len(two[0]["steps"])
    for rec in two:
        for row in chip_smoke.compare_records(rec, one[0]):
            assert row["loss_rel"] < 1e-5, row
            assert row["params_all"] < 2e-3 and row["params"] < 2e-2, row
            assert row["stats"] < 1e-4, row
        assert all(s["collectives"] > 0 for s in rec["steps"])
    for a, b in zip(*(r["steps"] for r in two)):
        assert a["loss"] == b["loss"]
        for k, v in a["params"].items():
            assert torch.equal(v, b["params"][k]), k
    va, vb = two[0]["val"], one[0]["val"]
    for k in ("mIoU", "mAcc", "allAcc"):
        assert abs(va[k] - vb[k]) < 2e-3, (k, va, vb)


@pytest.mark.parametrize("fault", chip_smoke.DDP_FAULTS)
def test_planted_gradient_fault_falls_outside_the_band(runs, fault):
    """chip_smoke.plant_fault in the two-process PT-v2m2 run (the summed
    gradients doubled, or each process left with its own share): against
    the one-process run, the parameters after step 1 (all tensors
    together) and the loss of step 2 fall outside the floors of
    chip_smoke.py phase 17's band (DDP_FLOOR; measured 0.93-1.0 of the
    step's change and 1e-2 relative), which the fault-free run keeps well
    inside (test_two_processes_equal_one)."""
    floor = chip_smoke.DDP_FLOOR
    for rec in runs["faults"][fault]:
        rows = chip_smoke.compare_records(rec, runs["ptv2" + "1"][0])
        assert rows[0]["params_all"] > 2 * floor["params_all"], rows[0]
        assert rows[1]["loss_rel"] > 10 * floor["loss_rel"], rows[1]
    clean = chip_smoke.compare_records(runs["ptv2" + "2"][0], runs["ptv2" + "1"][0])
    assert all(r["params_all"] < floor["params_all"] / 10 for r in clean), clean


def test_checkpoint_and_log_written_by_process_zero(runs):
    """After the two-process PT-v2m2 run: model_last.pt holds process 0's
    parameters under the reference's names (no ``module.`` prefix) and
    the log holds process 0's lines only."""
    path = os.path.join(runs["root"], "ptv2" + "2", "model", "model_last.pt")
    state = torch.load(path, weights_only=False)["model"]
    last = runs["ptv2" + "2"][0]["steps"][-1]["params"]
    assert set(last) <= set(state) and not any(k.startswith("module.") for k in state)
    for k, v in last.items():
        assert torch.equal(state[k].float(), v), k
    with open(os.path.join(runs["root"], "ptv2" + "2", "train.log")) as f:
        log = f.read()
    assert log.count("Train: [1/") == 1 and "2 process(es)" in log


def test_entry_points_with_two_devices(runs):
    """tools.train --num-devices 2 --device cpu (spawned gloo processes):
    one step, its evaluation and checkpoint; then tools.test --num-devices
    2 on two test scenes (one TTA view): each process tests one (its votes
    cached by scene) and process 0 logs the split's result."""
    cli = os.path.join(runs["root"], "cli")
    assert os.path.isfile(os.path.join(cli, "model", "model_last.pt"))
    for scene in ("office_v", "office_w"):
        assert os.path.isfile(os.path.join(cli, "result", f"{scene}_pred.npy"))
    with open(os.path.join(cli, "test.log")) as f:
        log = f.read()
    assert log.count("Val result") == 1 and log.count("[1/1]") == 1
