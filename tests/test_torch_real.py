"""REAL of the port against ao_tpu's: prompt mining (grid, query ablation,
radius), mask voting, the basket fill, one oracle refinement round of a
scene (label files, update count, prompt accuracy), all bit for bit, and
one tiny RealTrainer epoch on the CPU through the port's entry point
(basket filled at exactly the sampled rows, labels rewritten by oracle
masks, basket reset), plus the single-process comm. The refinement's fork
pool runs in test_torch_isolation.py's child, a process without JAX's
threads."""

import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.engines import train_real as jax_real
from ao_tpu.models.sam.oracle import OracleSamPredictor as JaxOracle
from ao_tpu_torch.engines import train_real
from ao_tpu_torch.models.sam import OracleSamPredictor
from ao_tpu_torch.utils import comm

ROOM = (1.6, 1.4, 1.0)
SIZE = 64


def _rooms():
    return [chip_smoke.make_room(s, ROOM, 0.05) for s in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """PP2S outputs (oracle mode) of three small rooms through the port's
    CLI, a fourth room for validation, and the REAL overrides."""
    rooms = _rooms()
    root = str(tmp_path_factory.mktemp("real"))
    backbone = _flagship_cfg(tiny=True)["backbone"]
    backbone.update(drop_path_rate=0.0, compute_dtype=None)
    workdir, options, seconds, labels = chip_smoke.real_setup(
        rooms[:3], rooms[3], root, size=SIZE, views=2, batch_size=2,
        max_steps=2, workers=0, seed=5, device="cpu")
    options += [f"model.backbone={backbone!r}", "pad_multiple=1024",
                "real.refine_workers=1", "real.oracle_quality=0.9"]
    return workdir, options, labels


def _mining_inputs(seed, n=3000, classes=6):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    seg_pred = rng.integers(-1, classes, n)
    conf = rng.uniform(0, 1, n)
    conf[::7] = conf[1::7][: len(conf[::7])]  # ties
    sam_label = rng.integers(-1, classes, n)
    return coord, seg_pred, conf, sam_label, np.arange(1, classes)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["grid", "grid_query_abl", "radius"])
def test_prompt_mining_equal(seed, mode):
    coord, seg_pred, conf, sam_label, present = _mining_inputs(seed)
    if mode == "radius":
        args = (coord, seg_pred, conf, sam_label, present, 0.33, 0.9)
        got = train_real.radius_prompt_search(*args)
        want = jax_real.radius_prompt_search(*args)
    else:
        kw = dict(grid_scale=0.5, conf_thresh=0.8,
                  require_disagreement=mode == "grid")
        got = train_real.grid_prompt_search(coord, seg_pred, conf, sam_label,
                                            present, **kw)
        want = jax_real.grid_prompt_search(coord, seg_pred, conf, sam_label,
                                           present, **kw)
    assert want[0].size > 10
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_vote_masks_equal():
    rng = np.random.default_rng(3)
    n, C, P = 4000, 6, 24
    bridge = np.zeros((n, 3), np.uint16)
    bridge[:, :2] = rng.integers(1, 49, (n, 2))
    bridge[:, 2] = rng.random(n) < 0.7
    masks = rng.random((P, 48, 48)) < 0.3
    prompt_cls = rng.integers(0, C, P)
    seg_pred = rng.integers(0, C, n)
    seg_pred[rng.random(n) < 0.5] = 2
    conf = rng.random(n)
    votes = [np.zeros((n, C), np.int32) for _ in range(2)]
    train_real.vote_masks_for_frame(masks, prompt_cls, bridge, seg_pred, conf,
                                    votes[0], 0.3)
    jax_real.vote_masks_for_frame(masks, prompt_cls, bridge, seg_pred, conf,
                                  votes[1], 0.3)
    assert votes[1].sum() > 0 and np.array_equal(votes[0], votes[1])


def test_basket_fill_equal():
    """The same logits and collated batch fill the same basket (the port's
    fill_basket against ao_tpu's run_step with its step stubbed out)."""
    rng = np.random.default_rng(4)
    B, N, C = 3, 512, 13
    sizes = {"Area_1/office_0": 700, "Area_2/office_0": 600}
    logits = rng.standard_normal((B, N, C)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    instance = -np.ones((B, N), np.int32)
    keys = ["Area_1/office_0", "Area_2/office_0", "Area_1/office_0"]
    names = [f"/d/s3dis/{k}.npz" for k in keys]
    for b, n in enumerate((500, 420, 512)):
        mask[b, :n] = True
        instance[b, :n] = rng.choice(sizes[keys[b]], n, replace=False)
    batch_np = dict(mask=mask, instance=instance,
                    extras=dict(scene_id=names, name=["office_0"] * B))

    def basket():
        return {k: np.full((n, C), -100.0, np.float32) for k, n in sizes.items()}

    ref = object.__new__(jax_real.RealTrainer)
    ref.basket, ref.comm_info, ref.state, ref.rng_key = basket(), {}, None, None
    ref.put_batch = lambda b: b
    ref._train_step = lambda state, b, rng: (state, {"loss": 0.0}, logits)
    ref.run_step(batch_np)

    port = object.__new__(train_real.RealTrainer)
    port.basket = basket()
    port.fill_basket(dict(mask=torch.from_numpy(mask),
                          instance=torch.from_numpy(instance),
                          extras=batch_np["extras"]), torch.from_numpy(logits))
    assert set(port.basket) == set(ref.basket)
    for k in ref.basket:
        assert (ref.basket[k][:, 0] != -100).sum() > 0
        assert np.array_equal(port.basket[k], ref.basket[k])


def test_refine_one_scene_equal(workspace, tmp_path):
    """One oracle refinement round of each scene: identical label files,
    update counts and prompt accuracies."""
    workdir, _, _ = workspace
    results = {}
    for side, mod, oracle in (("jax", jax_real, JaxOracle),
                              ("port", train_real, OracleSamPredictor)):
        labels_dir = str(tmp_path / side)
        shutil.copytree(os.path.join(workdir, "sam_labels"), labels_dir)
        cfg = dict(labels_dir=labels_dir,
                   data_root=os.path.join(workdir, "s3dis"),
                   bridge_root=os.path.join(workdir, "bridge"),
                   embedding_root=os.path.join(workdir, "embeddings"),
                   frame_size=(SIZE, SIZE), grid_scale=0.5,
                   prompt_search="grid", conf_thresh=0.3, radius_scale=0.33,
                   sam_frame_batch=2, num_classes=13, vote_min_fill=1,
                   vote_min_overwrite=1)
        results[side] = []
        for i in range(3):
            key = f"Area_{i + 1}/office_{i}"
            with np.load(os.path.join(workdir, "s3dis", f"Area_{i + 1}",
                                      f"office_{i}.npz")) as z:
                gt = z["semantic_gt"].reshape(-1)
            r = np.random.default_rng(100 + i)
            logits = (4.0 * np.eye(13, dtype=np.float32)[gt]
                      + r.standard_normal((len(gt), 13)).astype(np.float32))
            logits[r.random(len(gt)) < 0.2] = -100.0  # rows never sampled
            results[side].append(mod._refine_one_scene(
                (cfg, oracle(quality=0.9), key, logits)))
    port = [r[:2] for r in results["port"]]
    assert port == results["jax"]
    assert sum(r[0] for r in port) > 0 and all(r[2] > 0 and r[3] > 0
                                               for r in results["port"])
    for d, _, names in os.walk(tmp_path / "jax"):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), tmp_path / "jax")
            a = np.load(os.path.join(d, n))
            b = np.load(tmp_path / "port" / rel)
            assert a.dtype == b.dtype and np.array_equal(a, b), rel


def test_real_trainer_epoch(workspace):
    """Two steps of a tiny PT-v2m2 through the port's REAL entry point on
    the CPU; the cut epoch ends with the evaluation of the fourth room and
    one refinement round over oracle masks."""
    workdir, options, labels = workspace
    trainer, record = chip_smoke.run_real("cpu", options)
    r = chip_smoke.check_real(trainer, record, os.path.join(workdir, "sam_labels"))
    assert len(trainer.history) == 2
    assert all(h["basket_seconds"] < h["step_seconds"] for h in trainer.history)
    assert 0.0 <= r["prompt_accuracy"] <= 1.0 and r["seconds"] > 0
    assert trainer.comm_info["val_result"]["batches"] == 1
    assert "REAL refinement" in open(os.path.join(trainer.save_path,
                                                  "train.log")).read()


def test_comm_single_process(monkeypatch):
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.is_main_process()
    assert comm.gather({"a": 1}) == [{"a": 1}]
    assert comm.all_gather(3) == [3]
    comm.synchronize()
    monkeypatch.setenv("WORLD_SIZE", "2")
    # WORLD_SIZE > 1 with no initialised process group: an error that
    # names the launcher, never a silent single-process run
    for fn in (comm.get_world_size, comm.synchronize,
               lambda: comm.gather(1), lambda: comm.all_gather(1)):
        with pytest.raises(RuntimeError, match="engines.launch"):
            fn()
