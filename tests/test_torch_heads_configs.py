"""The SpUNet task heads' configs on the port, on the CPU at tiny widths:
two train steps of the base and lovasz CAC configs through the train
entry point (the model's four-term loss, the evaluator's CAC loss, the
base config's scene test), of the ScanNet PointGroup config through
train_insseg (its InsSegEvaluator, and the same hook on the room's own
labels), of configs/synthetic/pretrain-msc-smoke.py and the two ScanNet
MSC configs through train_pretrain; the per-view collate against the JAX
package's; a semantic model's train step unchanged by the trainer's
owned-loss branch; the optimizers taking a base config's other keys; and
the CAC PT-v2m2 config's input width."""

import copy
import functools
import os
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ao_tpu_torch.utils.scheduler import onecycle_lr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny SpUNet and its head
_TINY = ["model.backbone.base_channels=8",
         "model.backbone.channels=(8, 8, 16, 16, 16, 8, 8, 8)",
         "model.backbone.layers=(1, 1, 1, 1, 1, 1, 1, 1)",
         "model.backbone_out_channels=8", "pad_multiple=512", "max_points=4096"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one intra-op thread (restored after), so that the
    test workers' thread pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    return os.path.join(ROOT, "configs", name)


def _scannet(workdir, steps=2, batch_size=2, val_size=(1.6, 1.4, 1.0),
             size=(1.6, 1.4, 1.0)):
    """Three synthetic ScanNet rooms for training, a fourth as the val
    split, and the train entry point's overrides (no workers)."""
    rooms = [chip_smoke.make_scannet_room(s, size, 0.04) for s in (1, 2, 3)]
    val = chip_smoke.make_scannet_room(4, val_size, 0.04)
    return chip_smoke.scannet_setup(rooms, val, workdir=str(workdir),
                                    batch_size=batch_size, max_steps=steps, workers=0)


def _check_onecycle(trainer):
    s = trainer.cfg.scheduler
    for k, rec in enumerate(trainer.history):
        lr = onecycle_lr(k, trainer.total_steps, s.max_lr, s.pct_start,
                         s.get("div_factor", 25.0), s.get("final_div_factor", 1e4))
        assert abs(rec["lr"] - lr) <= 1e-12 * lr


@pytest.mark.parametrize("config", ["semseg-cac-v1m1-0-spunet-base.py",
                                    "semseg-cac-v1m1-1-spunet-lovasz.py"])
def test_cac_config_trains_on_the_cpu(tmp_path, config):
    """Two steps of a ScanNet CAC config through the train entry point:
    the criteria its model owns (the base config names none: CE with
    ignore -1; the lovasz one CE and Lovasz), the four terms finite and
    summing to the loss, OneCycle's lr, a step merged by Mix3D; the
    evaluator's eval_batch scores the refined logits with the model's
    criterion; the base config (which inherits no default_runtime.py, so
    no test dict) tests the val scene through the test entry point with
    its 10 views."""
    from ao_tpu_torch.models.losses.lovasz import LovaszLoss
    from ao_tpu_torch.models.losses.misc import CrossEntropyLoss
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.tools.train import main as train_main

    workdir, options = _scannet(tmp_path, val_size=(0.8, 0.7, 0.5))
    trainer = train_main(["--config-file", _config(f"scannet/{config}"), "--device",
                          "cpu", "--options", *options, *_TINY])
    kinds = [type(c) for c in trainer.model.criteria.criteria]
    assert kinds == ([CrossEntropyLoss] if "base" in config
                     else [CrossEntropyLoss, LovaszLoss])
    assert len(trainer.history) == 2
    for rec in trainer.history:
        terms = [rec[k] for k in chip_smoke.CAC_TERMS]
        assert np.isfinite(terms).all() and np.isfinite(rec["grad_norm"])
        assert rec["loss"] == pytest.approx(sum(terms), rel=1e-5)
    _check_onecycle(trainer)
    assert any(r["scenes"] < 2 for r in trainer.history)
    batch = next(iter(trainer.train_loader))
    loss, inter, union, target = trainer.eval_batch(batch)
    inputs, segment = trainer._to_device(batch)
    with torch.no_grad():
        out = trainer.model(**inputs)
    assert loss == pytest.approx(float(trainer.model.criteria(
        out["seg_logits"], segment.long(), inputs["mask"])), rel=1e-6)
    assert target.sum() > 0
    if "base" in config:
        weight = os.path.join(workdir, "cac.pt")
        torch.save(trainer.model.state_dict(), weight)
        result = test_main([
            "--config-file", _config(f"scannet/{config}"), "--device", "cpu",
            "--options", f"weight={weight}", f"save_path={workdir}/test",
            f"data.test.data_root={workdir}/scannet", *_TINY])
        votes = np.load(os.path.join(workdir, "test", "result", "scene0000_00_pred.npy"))
        chip_smoke.check_votes(votes, 10, num_classes=20)
        assert np.isfinite(result["mIoU"])


def test_pointgroup_config_trains_and_evaluates_on_the_cpu(tmp_path):
    """Two steps of the ScanNet PointGroup config through train_insseg: its
    three terms finite and summing to the loss, PolyLR's lr; the cut
    epoch's InsSegEvaluator scores the val room with finite mAP / AP50 /
    AP25, and the same hook on the room's own labels (chip_smoke's
    check_insseg) makes proposals and scores AP50 1."""
    from ao_tpu_torch.tools.train_insseg import main

    workdir, options = _scannet(tmp_path)
    trainer = main(["--config-file", _config("scannet/insseg-pointgroup-v1m1-0-spunet-base.py"),
                    "--device", "cpu", "--options", *options, *_TINY, "evaluate=True",
                    f"data.val.data_root={workdir}/scannet"])
    assert len(trainer.history) == 2
    for k, rec in enumerate(trainer.history):
        terms = [rec[t] for t in ("seg_loss", "bias_l1_loss", "bias_cosine_loss")]
        assert np.isfinite(terms).all()
        assert rec["loss"] == pytest.approx(sum(terms), rel=1e-5)
        lr = 0.1 * (1 - k / (trainer.total_steps + 1)) ** 0.9
        assert rec["lr"] == pytest.approx(lr, rel=1e-12)
    res, oracle = chip_smoke.check_insseg(trainer, "pointgroup", "cpu")
    assert res["scenes"] == oracle["scenes"] == 1
    assert oracle["proposals"] >= 2 and oracle["all_ap"] == pytest.approx(1.0)
    assert os.path.isfile(os.path.join(workdir, "exp", "model", "model_last.pt"))


def test_msc_smoke_config_trains_on_the_cpu(tmp_path):
    """configs/synthetic/pretrain-msc-smoke.py end to end through
    train_pretrain (SyntheticDataset, the two-view pipeline, the per-view
    collate, MSC-v1m1 on a tiny SpUNet), two steps: NCE and colour losses
    finite and summing to the loss, matched pairs every step, OneCycle's
    lr, model_last.pt written."""
    from ao_tpu_torch.tools.train_pretrain import main

    trainer = main(["--config-file", _config("synthetic/pretrain-msc-smoke.py"),
                    "--device", "cpu", "--options", f"save_path={tmp_path}/exp",
                    "max_steps=2", "num_worker=0", "enable_tensorboard=False"])
    assert len(trainer.history) == 2
    for rec in trainer.history:
        assert np.isfinite([rec["nce_loss"], rec["color_loss"]]).all()
        assert rec["loss"] == pytest.approx(rec["nce_loss"] + rec["color_loss"], rel=1e-5)
        assert rec["pairs"] > 0 and "normal_loss" not in rec
    _check_onecycle(trainer)
    assert trainer.val_loader is None
    assert os.path.isfile(os.path.join(tmp_path, "exp", "model", "model_last.pt"))


@pytest.mark.parametrize("config", ["pretrain-msc-v1m1-0-spunet-base.py",
                                    "pretrain-msc-v1m2-0-spunet-csc.py"])
def test_scannet_msc_config_trains_on_the_cpu(tmp_path, config):
    """One step of each ScanNet MSC config (its view pipeline with
    RandomColorJitter, normals reconstructed, discrete coords per view;
    v1m2 with CSC's partitions) through train_pretrain at a tiny width:
    the three losses finite, pairs matched."""
    from ao_tpu_torch.tools.train_pretrain import main

    _, options = _scannet(tmp_path, steps=1, size=(0.8, 0.7, 0.6), val_size=(0.8, 0.7, 0.6))
    trainer = main(["--config-file", _config(f"scannet/{config}"), "--device", "cpu",
                    "--options", *options, *_TINY, "model.matching_max_pair=256"])
    rec = trainer.history[0]
    assert np.isfinite([rec[k] for k in ("nce_loss", "color_loss", "normal_loss")]).all()
    assert rec["pairs"] > 0
    assert trainer.model.csc == ("v1m2" in config)


def test_view_collate_matches_jax():
    """The per-view collate against ao_tpu's PretrainTrainer._collate on
    samples of different sizes: each view padded to its own multiple of
    pad_multiple, the same masks and values (discrete coords int32 here,
    float32 there)."""
    from ao_tpu.engines.train_pretrain import PretrainTrainer as JaxTrainer
    from ao_tpu_torch.engines.train_pretrain import view_collate_fn

    rng = np.random.default_rng(0)
    samples = []
    for n1, n2 in ((300, 520), (610, 100)):
        s = {}
        for v, n in (("view1", n1), ("view2", n2)):
            s[f"{v}_coord"] = rng.normal(size=(n, 3)).astype(np.float32)
            s[f"{v}_origin_coord"] = rng.normal(size=(n, 3)).astype(np.float32)
            s[f"{v}_feat"] = rng.normal(size=(n, 6)).astype(np.float32)
            s[f"{v}_discrete_coord"] = rng.integers(0, 50, (n, 3))
        s["offset"] = np.array([n1])
        samples.append(s)
    ours = view_collate_fn(samples, pad_multiple=256)
    theirs = JaxTrainer._collate(types.SimpleNamespace(cfg=dict(pad_multiple=256)),
                                 samples)
    assert set(ours) == set(theirs)
    assert ours["view1_mask"].shape == (2, 768) and ours["view2_mask"].shape == (2, 768)
    assert ours["view1_discrete_coord"].dtype == torch.int32
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v).astype(
            ours[k].numpy().dtype), err_msg=k)


def test_semantic_step_unchanged_by_the_owned_loss_branch(tmp_path):
    """A model whose forward takes no ``segment`` (the ScanNet SpUNet's
    DefaultSegmentor) trains as before: the step's loss is the criteria
    of the model's logits, bit for bit, on a copy of the model before the
    step, and the step reports no extra terms."""
    _, options = _scannet(tmp_path, steps=1)
    trainer = chip_smoke.build_trainer(
        options + [o for o in _TINY if "backbone_out" not in o] + ["mix_prob=0"],
        "cpu", _config("scannet/semseg-spunet-v1m1-0-base.py"))
    assert not trainer._takes_segment
    batch = next(iter(trainer.train_loader))
    before = copy.deepcopy(trainer.model).train()
    metrics, logits = trainer._step(batch)
    inputs, segment = trainer._to_device(batch)
    with torch.no_grad():
        ref = before(**inputs)
    assert torch.equal(logits, ref)
    assert torch.equal(metrics["loss"], trainer.criteria(ref, segment.long(),
                                                         inputs["mask"]))
    assert set(metrics) == {"loss", "grad_norm", "pool_overflow"}


def test_optimizers_take_their_bases_other_keys():
    """configs/scannet/semseg-cac-v1m1-2-ptv2-lovasz.py replaces its base's
    SGD by AdamW without _delete_, so the merged dict keeps momentum and
    nesterov: the port's AdamW takes and ignores them, as the JAX
    package's does, and steps as one built without them."""
    from ao_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
    from ao_tpu_torch.utils import Config
    from ao_tpu_torch.utils.optimizer import build_optimizer

    cfg = Config.fromfile(_config("scannet/semseg-cac-v1m1-2-ptv2-lovasz.py"))
    assert cfg.optimizer.type == "AdamW" and cfg.optimizer.nesterov
    jax_build_optimizer(dict(cfg.optimizer), 100)
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    opts = [build_optimizer(dict(cfg.optimizer), torch.nn.ParameterList([p]))
            for p in params[:1]]
    opts.append(torch.optim.AdamW(params[1:], lr=0.005, weight_decay=0.02))
    for _ in range(3):
        for p, opt in zip(params, opts):
            p.grad = torch.tensor([1.0, -2.0, 0.5])
            opt.step()
    assert torch.equal(params[0], params[1])


def test_cac_ptv2_config_takes_the_width_its_data_gives(tmp_path):
    """The CAC PT-v2m2 config names in_channels=9, but its data (the SpUNet
    base's Collect: colour and normal) gives 6 features: the port's model
    built as written refuses them; with in_channels=6 (what the JAX
    package's flax Dense infers) a step trains at a tiny width."""
    from ao_tpu_torch.tools.train import main

    config = _config("scannet/semseg-cac-v1m1-2-ptv2-lovasz.py")
    _, options = _scannet(tmp_path, steps=1)
    tiny = ["model.backbone.patch_embed_channels=16", "model.backbone.patch_embed_groups=2",
            "model.backbone.enc_channels=(16, 32, 32, 64)", "model.backbone.enc_groups=(2, 4, 4, 8)",
            "model.backbone.dec_channels=(16, 16, 32, 32)", "model.backbone.dec_groups=(2, 2, 4, 4)",
            "model.backbone.enc_depths=(1, 1, 1, 1)", "model.backbone_out_channels=16",
            "pad_multiple=512", "max_points=4096", "mix_prob=0"]
    with pytest.raises(RuntimeError, match="cannot be multiplied"):
        main(["--config-file", config, "--device", "cpu", "--options", *options, *tiny,
              f"save_path={tmp_path}/as_written"])
    trainer = main(["--config-file", config, "--device", "cpu", "--options", *options,
                    *tiny, *chip_smoke.CAC_PTV2_IN])
    rec = trainer.history[0]
    assert np.isfinite([rec[k] for k in chip_smoke.CAC_TERMS]).all()


def _jax_options(options):
    from ao_tpu_torch.utils import DictAction

    return {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in options)}


def test_insseg_trainer_step_matches_jax(tmp_path, monkeypatch):
    """One train step of the ScanNet PointGroup config (tiny width, B=2,
    padded rows) in the port's InsSegTrainer against ao_tpu's, on ao_tpu's
    first batch and its initial variables carried across (discrete_coord
    dropped: ao_tpu's engine feeds none, ROADMAP.md section 3): the loss
    and its three terms within 1e-4 of scale (measured up to 2.1e-7), and
    after SGD (nesterov, weight decay) at PolyLR's first lr every
    parameter and running statistic within 1e-4 of its scale (measured up
    to 2.5e-6) but the bias head's last Linear, which ao_tpu's step turns
    to NaN: its bias_pred is exactly 0 on padded rows (the BatchNorm zeroes
    them, the Dense bias starts at 0), jnp.linalg.norm's gradient there is
    NaN, and the mask multiplies it (0 x NaN); torch's norm takes 0 there,
    and the port's stays finite."""
    import ao_tpu.engines.train as jtrain
    from ao_tpu.engines import default_config_parser as jax_parser
    from ao_tpu.engines.train_insseg import InsSegTrainer as JaxInsSeg
    from ao_tpu_torch.engines import InsSegTrainer, default_config_parser
    from ao_tpu_torch.models.sparse_unet import convert

    # no TensorBoard writer for the JAX trainer (its import loads TensorFlow)
    monkeypatch.setattr(jtrain, "TensorboardWriter", lambda *a, **k: None)
    config = _config("scannet/insseg-pointgroup-v1m1-0-spunet-base.py")
    workdir, options = _scannet(tmp_path, steps=1, size=(1.0, 0.9, 0.7))
    options = options + _TINY + ["evaluate=False", "seed=3"]
    jtr = JaxInsSeg(jax_parser(config, _jax_options(options + [f"save_path={workdir}/jax"])))
    batch = next(iter(jtr.train_loader))
    assert not batch["mask"].all()
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    sd = convert.from_jax_variables(to_np(dict(params=jtr.state.params,
                                               batch_stats=jtr.state.batch_stats)))
    ttr = InsSegTrainer(default_config_parser(config, _jax_options(
        options + [f"save_path={workdir}/port"])), device="cpu")
    ttr.model.load_state_dict(sd, strict=True)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
              if k not in ("extras", "discrete_coord")}
    state, jm = jtr._train_step(jtr.state, jtr.put_batch(batch), jtr.rng_key)
    tm, _ = ttr._step(tbatch)
    for k in ("loss", "seg_loss", "bias_l1_loss", "bias_cosine_loss"):
        j = float(np.asarray(jm[k]))
        assert abs(float(tm[k]) - j) <= 1e-4 * max(abs(j), 1.0), k
    after = convert.from_jax_variables(to_np(dict(params=state.params,
                                                  batch_stats=state.batch_stats)))
    port = ttr.model.state_dict()
    for k, v in after.items():
        v, t = v.numpy(), port[k].numpy()
        if k.startswith("bias_head.3."):
            assert np.isnan(v).all() and np.isfinite(t).all(), k
        elif "num_batches" not in k:
            assert np.abs(t - v).max() <= 1e-4 * max(np.abs(v).max(), 1.0), k


def test_jax_pretrain_trainer_cannot_take_a_step():
    """The JAX package's PretrainTrainer cannot train: its put_batch
    (ao_tpu/engines/train_pretrain.py:76-90) re-puts every key of a batch
    that Trainer._device_prefetch (ao_tpu/engines/train.py:418-455) has
    already put and marked with a rank-0 ``_device`` flag, and sharding
    that flag over the data axis raises (the step that run_step takes at
    train.py:470); the base Trainer's put_batch passes such a batch
    through. The port's MSC trainer is held to ao_tpu's pieces instead
    (test_torch_heads.py, test_view_collate_matches_jax)."""
    from jax.sharding import Mesh

    from ao_tpu.engines.train import Trainer as JaxTrainer
    from ao_tpu.engines.train_pretrain import PretrainTrainer as JaxPretrain

    fake = types.SimpleNamespace(mesh=Mesh(np.asarray(jax.devices()[:1]), ("data",)))
    batch = {"view1_mask": np.ones((1, 8), bool), "view1_coord": np.zeros((1, 8, 3))}
    dev = JaxPretrain.put_batch(fake, batch)
    dev["_device"] = True  # what _device_prefetch adds
    assert set(JaxTrainer.put_batch(fake, dict(dev))) == set(batch)
    with pytest.raises(ValueError, match="rank"):
        JaxPretrain.put_batch(fake, dev)
