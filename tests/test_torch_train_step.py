"""One whole train step of ao_tpu_torch's Trainer (forward in train mode,
loss, backward, AdamW step, per-step MultiStepLR) against ao_tpu's on the
same weights and batch, on both packages' CPU path; the lr schedule, AdamW
and the loss against their ao_tpu / optax counterparts; the train entry
point end to end with its checkpoint and a resume."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import chip_smoke
from __graft_entry__ import _flagship_cfg
from ao_tpu.models import build_criteria as jax_build_criteria
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.models.losses.misc import CrossEntropyLoss as JaxCE
from ao_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
from ao_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from ao_tpu_torch.models.losses.misc import CrossEntropyLoss
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.tools.train import main as train_main
from ao_tpu_torch.utils.optimizer import build_optimizer
from ao_tpu_torch.utils.scheduler import build_scheduler

ROOM = (0.9, 0.8, 0.6)
_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _options(root, steps, **extra):
    """Three small synthetic rooms as S3DIS train scenes and the base
    config's overrides for the tiny PT-v2m2 of __graft_entry__ in f32
    without stochastic depth (so both packages draw nothing)."""
    rooms = [chip_smoke.make_room(s, ROOM) for s in (1, 2, 3)]
    _, options = chip_smoke.train_setup(rooms, str(root), batch_size=2,
                                        max_steps=steps, workers=0, seed=3)
    backbone = _flagship_cfg(tiny=True)["backbone"]
    backbone.update(drop_path_rate=0.0, compute_dtype=None)
    return options + [f"model.backbone={backbone!r}", "pad_multiple=1024"] + [
        f"{k}={v!r}" for k, v in extra.items()]


def _by_name(params, stats=None):
    return {k: v.numpy() for k, v in
            convert.from_jax_variables(_np(params), stats and _np(stats)).items()}


# parameters whose gradient is zero up to rounding: Linear biases that feed
# a BatchNorm (which removes their shift; v's and the pe MLP's second layer
# reach one through the softmax-weighted sum and the relation), and b2 (the
# softmax is shift-invariant)
_ZERO_GRAD = ("linear_q.0.bias", "linear_k.0.bias", "linear_v.bias",
              "linear_p_bias.0.bias", "linear_p_bias.3.bias",
              "weight_encoding.0.bias", "weight_encoding.3.bias",
              "proj.0.bias", "proj_skip.0.bias", "seg_head.0.bias")


def _setup(tmp_path, randomise_stats=False):
    """The port's Trainer on the synthetic rooms, its first batch, and the
    JAX model initialised on it with the same weights in both."""
    trainer = chip_smoke.build_trainer(_options(tmp_path, 1), "cpu")
    batch = next(iter(trainer.train_loader))
    cfg = trainer.cfg.to_dict()
    jmodel = jax_build_model(cfg["model"])
    arrays = tuple(jnp.asarray(batch[k].numpy())
                   for k in ("coord", "feat", "mask", "segment"))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *arrays[:3])
    params, stats = variables["params"], variables["batch_stats"]
    if randomise_stats:
        rng = np.random.default_rng(1)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.asarray(
                rng.uniform(0.5, 1.5, x.shape) if "var" in str(path[-1])
                else rng.normal(0, 0.2, x.shape), jnp.float32), stats)
    trainer.model.load_state_dict(
        convert.from_jax_variables(_np(params), _np(stats)), strict=True)
    return trainer, batch, cfg, jmodel, arrays, params, stats


def _jax_grads(cfg, jmodel, arrays, params, stats, train):
    coord, feat, mask, seg = arrays
    criteria = jax_build_criteria(cfg["model"]["criteria"])

    def loss_fn(p):
        logits, mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, coord, feat, mask, not train,
            not train, mutable=["batch_stats", "diagnostics"])
        return criteria(logits, seg, mask), mut

    # op by op: the jitted whole model's own gradients move by up to ~1e-2
    # of their norm when the input features move by 1e-7, so the port is
    # held to the reference's unfused arithmetic
    with jax.disable_jit():
        return jax.value_and_grad(loss_fn, has_aux=True)(params)


def test_train_step_matches_jax(tmp_path):
    """The Trainer's first step against ao_tpu's train step on the same
    collated batch and weights. Tight: the loss (1e-4 relative; measured
    2.7e-5), the pool-overflow count (exact) and the updated running
    statistics (1e-4). The gradients, per parameter tensor as
    |g_port - g_jax| / |g_jax| (Frobenius), against jax.grad run op by op
    (_jax_grads), within 5e-3 (measured median 4.2e-4, largest 1.6e-3: each
    gradient is a nearly cancelling sum over the points, and in train mode
    the batch-statistic BatchNorms amplify the frameworks' f32 differences
    stage by stage towards the input). Gradients that are zero up to
    rounding within 1e-2 of the largest. Each module holds tightly on its
    own (test_torch_train_model.py: a BlockSequence in f32 to 3e-6). After
    the step the parameters equal optax.adamw's update of the initial
    parameters with the port's own gradients at the scheduled lr (1e-6)."""
    trainer, batch, cfg, jmodel, arrays, params, stats = _setup(tmp_path)
    (jloss, mut), jgrads = _jax_grads(cfg, jmodel, arrays, params, stats, True)
    m = trainer.train_step(batch)
    assert abs(float(m["loss"]) - float(jloss)) < 1e-4 * abs(float(jloss))
    overflow = sum(int(np.sum(x)) for x in
                   jax.tree_util.tree_leaves(mut.get("diagnostics", {})))
    assert int(m["pool_overflow"]) == overflow
    sd = trainer.model.state_dict()
    for k, v in _by_name(params, mut["batch_stats"]).items():
        if "running" in k:
            assert np.abs(sd[k].numpy() - v).max() < 1e-4 * max(
                np.abs(v).max(), 1.0), k
    jg = _by_name(jgrads)
    tparams = dict(trainer.model.named_parameters())
    assert set(jg) == set(tparams)
    gmax = max(np.abs(g).max() for g in jg.values())
    for name, p in tparams.items():
        g, tg = jg[name], p.grad.numpy()
        if name.endswith(_ZERO_GRAD):
            assert max(np.abs(g).max(), np.abs(tg).max()) < 1e-2 * gmax, name
        else:
            assert np.linalg.norm(tg - g) < 5e-3 * np.linalg.norm(g), name
    # the optimizer step on the port's own gradients
    tx = jax_build_optimizer(cfg["optimizer"], None, cfg["scheduler"],
                             trainer.total_steps)
    p0 = _by_name(params)
    tgrads = {n: jnp.asarray(p.grad.numpy()) for n, p in tparams.items()}
    upd, _ = tx.update(tgrads, tx.init({n: jnp.asarray(v) for n, v in p0.items()}),
                       {n: jnp.asarray(v) for n, v in p0.items()})
    for name, p in tparams.items():
        assert np.abs(p.detach().numpy() - (p0[name] + np.asarray(upd[name]))
                      ).max() < 1e-6, name


def test_eval_mode_gradients_match_jax(tmp_path):
    """The whole backward (head, decoder, unpooling, grid pools, every
    block's unfused GVA, the patch embedding) with running-statistic
    BatchNorms against jax.grad run op by op (_jax_grads). The loss within
    1e-5 (measured 0). Per parameter tensor, |g_port - g_jax| / |g_jax|
    (Frobenius) within 1e-4 (measured median 2.5e-7, largest 4.0e-5: at
    random weights each gradient is a sum over ~10^4 points of terms that
    nearly cancel, which multiplies the frameworks' ~1e-7 differences in
    every activation); b2, zero up to rounding, within 1e-2 of the largest
    gradient. The running statistics
    are random, so that no pad slot's pe-MLP input sits at exactly 0 (at
    fresh statistics it does, and there ao_tpu's jnp.maximum passes half
    the gradient where torch's relu passes none)."""
    trainer, batch, cfg, jmodel, arrays, params, stats = _setup(
        tmp_path, randomise_stats=True)
    (jloss, _), jgrads = _jax_grads(cfg, jmodel, arrays, params, stats, False)
    model = trainer.model.eval()
    coord, feat, mask, seg = (batch[k] for k in ("coord", "feat", "mask",
                                                 "segment"))
    loss = trainer.criteria(model(coord, feat, mask), seg.long(), mask)
    loss.backward()
    assert abs(float(loss) - float(jloss)) < 1e-5 * abs(float(jloss))
    jg = _by_name(jgrads)
    gmax = max(np.abs(g).max() for g in jg.values())
    for name, p in model.named_parameters():
        g, tg = jg[name], p.grad.numpy()
        if name.endswith("weight_encoding.3.bias"):
            assert max(np.abs(g).max(), np.abs(tg).max()) < 1e-2 * gmax, name
        else:
            assert np.linalg.norm(tg - g) < 1e-4 * np.linalg.norm(g), name


def test_multistep_lr_matches_optax_at_every_step():
    """The per-step MultiStepLR: boundaries int(r * total_steps), gamma per
    boundary passed (the schedule of the base config, lr 0.006, milestones
    0.09 / 0.2, over 120 steps), equal to ao_tpu's optax schedule at
    every step to its f32 precision (1e-7 relative)."""
    cfg = dict(type="MultiStepLR", milestones=[0.09, 0.2], gamma=0.1)
    total, base = 120, 0.006
    sched = jax_build_scheduler(dict(cfg), base_lr=base, total_steps=total)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.AdamW([p], lr=base)
    tsched = build_scheduler(dict(cfg), opt, total)
    for step in range(total):
        lr = opt.param_groups[0]["lr"]
        assert abs(lr - float(sched(step))) < 1e-7 * lr, step
        opt.step()
        tsched.step()


def test_adamw_matches_optax():
    """torch.optim.AdamW as built from the base config against ao_tpu's
    optax.adamw over three steps of random gradients: decoupled decay
    lr * wd * p and eps outside the square root in both (measured 3.6e-7)."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    grads = [rng.normal(size=(4, 6)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    cfg = dict(type="AdamW", lr=0.006, weight_decay=0.05)
    tx = jax_build_optimizer(dict(cfg), None, dict(type="MultiStepLR",
                                                   milestones=[]), 10)
    jp = {"w": jnp.asarray(p0)}
    state = tx.init(jp)
    model = torch.nn.Linear(6, 4, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = build_optimizer(dict(cfg), model)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        model.weight.grad = torch.from_numpy(g.copy())
        opt.step()
    assert np.abs(model.weight.detach().numpy() - np.asarray(jp["w"])).max() < 1e-6


def test_cross_entropy_matches_jax():
    """The masked mean over valid, non-ignored points, with and without
    class weights and label smoothing (measured up to 1.7e-7)."""
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(2, 40, 13)).astype(np.float32) * 3
    target = rng.integers(-1, 13, (2, 40)).astype(np.int32)
    mask = rng.random((2, 40)) < 0.9
    for kw in ({}, dict(weight=list(rng.uniform(0.5, 2, 13))),
               dict(label_smoothing=0.1)):
        jl = JaxCE(ignore_index=-1, **kw)(jnp.asarray(pred), jnp.asarray(target),
                                         jnp.asarray(mask))
        tl = CrossEntropyLoss(ignore_index=-1, **kw)(
            torch.from_numpy(pred), torch.from_numpy(target).long(),
            torch.from_numpy(mask))
        assert abs(float(tl) - float(jl)) < 1e-5 * abs(float(jl)), kw


def test_train_entry_point_checkpoint_and_resume(tmp_path):
    """python -m ao_tpu_torch.tools.train on the CPU: finite losses and
    gradient norms, the lr of the schedule, a checkpoint at the end; a
    resumed run continues at the saved step with the saved optimizer
    state."""
    opts = _options(tmp_path, 2)
    argv = ["--config-file", chip_smoke.BASE_CONFIG, "--device", "cpu",
            "--options", *opts]
    trainer = train_main(argv)
    assert trainer.cfg.data.train.loop == 30  # epoch 3000 // eval_epoch 100
    assert len(trainer.history) == 2 and trainer.step == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in trainer.history)
    assert trainer.history[0]["lr"] == 0.006
    ckpt = tmp_path / "exp" / "model" / "model_last.pt"
    assert ckpt.is_file()
    resumed = train_main(argv[:-len(opts)] + opts[:-1] + [
        "max_steps=3", "resume=True"] + opts[-1:])
    assert resumed.step == 3 and len(resumed.history) == 1
    state = resumed.optimizer.state_dict()["state"]
    assert int(next(iter(state.values()))["step"]) == 3
