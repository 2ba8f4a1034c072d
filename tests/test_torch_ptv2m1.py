"""PT-v2m1 and activation checkpointing in ao_tpu_torch, against ao_tpu:
the legacy attention (the pe-multiplier MLP, the GroupedLinear weight
encoding, the masked softmax) in a whole model's eval and train logits
and running statistics and in a BlockSequence's gradients (jax.grad op by
op), in f32 and bf16; the m1 weight conversion; ``enable_checkpoint`` as
torch.utils.checkpoint (the same step as without it: loss, gradients,
parameters, running statistics updated once, the generator's state; the
fused train path's kernels; the loss of ao_tpu's nn.remat model); and the
three PT-v2m1 configs taking a CPU step through the train entry point."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.models.point_transformer_v2.ptv2m2 as jm
import chip_smoke
from ao_tpu.models import build_model as jax_build_model
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.models.utils import DropPath, Dropout
from ao_tpu_torch.ops import gva as tm_gva

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
_TINY = dict(in_channels=4, num_classes=5, patch_embed_channels=16,
             patch_embed_groups=2, enc_depths=(1, 2), enc_channels=(16, 32),
             enc_groups=(2, 4), enc_neighbours=(8, 8), dec_depths=(1, 1),
             dec_channels=(16, 16), dec_groups=(2, 2), dec_neighbours=(8, 8),
             grid_sizes=(0.1, 0.2), unpool_backend="interp")
# (model type, pe_multiplier): PT-v2m1 as its configs run it, PT-v2m1
# without the multiplier, and PT-v2m2 with it (a Dense weight encoding on
# the legacy attention)
_CASES = [("PT-v2m1", True), ("PT-v2m1", False), ("PT-v2m2", True)]
# bands per compute dtype: (eval logits, train logits, running statistics,
# block gradients), each against its scale
_BANDS = {None: (1e-4, 1e-3, 1e-4, 1e-4), "bfloat16": (1e-4, 5e-2, 1e-2, 5e-2)}
# gradients that are zero up to rounding (a BatchNorm removes the shift of
# the bias before it; the softmax is shift-invariant)
_ZERO_GRAD = ("linear_q.0.bias", "linear_k.0.bias", "linear_v.bias",
              "linear_p_multiplier.0.bias", "linear_p_bias.0.bias",
              "linear_p_bias.3.bias", "weight_encoding.0.bias",
              "weight_encoding.3.bias")


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 1, (2, n, 3)).astype(np.float32)
    feat = rng.normal(size=(2, n, 4)).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n - 50:] = False
    return coord, feat, mask


@functools.lru_cache(maxsize=None)
def _jax_variables(kind, pe):
    """(config, ao_tpu's initial variables, inputs) of the tiny model."""
    cfg = dict(_TINY, type=kind, pe_multiplier=pe)
    arrays = _cloud()
    var = jax.jit(jax_build_model(dict(cfg)).init)(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in arrays))
    return cfg, dict(params=var["params"], batch_stats=var["batch_stats"]), arrays


@pytest.fixture(scope="module", params=_CASES, ids=lambda c: f"{c[0]}-pe{c[1]}")
def jax_model(request):
    return _jax_variables(*request.param)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_ptv2m1_model_matches_jax(jax_model, dtype):
    """A tiny PT-v2m1 / pe-multiplier PT-v2 (two stages, interp unpooling)
    with ao_tpu's weights carried across by from_jax_variables (strict),
    on both packages' CPU path. Eval logits within 1e-4 x scale (measured
    up to 4.2e-7 in f32 and bf16). Train mode (batch statistics): logits
    and the updated running statistics against their scales, within 1e-3
    and 1e-4 in f32 (measured up to 2.9e-6 and 3.2e-7), 5e-2 and 1e-2 in
    bf16 (measured up to 2.1e-2 and 1.4e-3: every bf16 rounding of the two
    frameworks that falls one unit apart is amplified by the batch
    statistics of the blocks after it, as test_torch_scannet.py measures
    for PT-v2m2 at 9.1e-3 within ao_tpu itself)."""
    cfg, var, arrays = jax_model
    cfg = dict(cfg, compute_dtype=dtype)
    t_eval, t_train, t_stats, _ = _BANDS[dtype]
    jmodel = jax_build_model(dict(cfg))
    tmodel = build_model(dict(cfg))
    tmodel.load_state_dict(convert.from_jax_variables(
        _np(var["params"]), _np(var["batch_stats"])), strict=True)
    args = tuple(jnp.asarray(a) for a in arrays)
    targs = tuple(torch.from_numpy(a) for a in arrays)
    mask = arrays[2]

    def rel(t, j):
        j = np.asarray(j, np.float32)
        return np.abs(t.float().numpy() - j)[mask].max() / max(np.abs(j).max(), 1.0)

    # ao_tpu op by op: jit's fusions round the kNN scores otherwise and
    # swap near-tied neighbours
    with torch.no_grad():
        assert rel(tmodel.eval()(*targs), jmodel.apply(var, *args, True, True)) < t_eval
        tout = tmodel.train()(*targs)
    jout, mut = jmodel.apply(var, *args, True, False,
                             mutable=["batch_stats", "diagnostics"])
    assert rel(tout, jout) < t_train
    sd = tmodel.state_dict()
    for k, v in convert.from_jax_variables(
            _np(var["params"]), _np(mut["batch_stats"])).items():
        if "running" in k:
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= t_stats * max(
                np.abs(v.numpy()).max(), 1.0), k


# the legacy BlockSequence of the gradient test: (C, G, S), two blocks
_SEQ = (16, 2, 8)


def _seq_inputs(n=120):
    rng = np.random.default_rng(7)
    coord = rng.uniform(0, 2, (2, n, 3)).astype(np.float32)
    feat = (rng.normal(size=(2, n, _SEQ[0])) * 0.5).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n - 7:] = False
    r = rng.normal(size=(2, n, _SEQ[0])).astype(np.float32)
    return feat, coord, mask, r


def _jax_seq(pe, grouped, dtype):
    C, G, S = _SEQ
    return jm.BlockSequence(depth=2, embed_channels=C, groups=G, neighbours=S,
                            pe_multiplier=pe, grouped_linear=grouped,
                            dtype=None if dtype is None else jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _seq_variables(pe, grouped):
    feat, coord, mask, _ = _seq_inputs()
    return jax.jit(_jax_seq(pe, grouped, None).init)(
        jax.random.PRNGKey(1), feat, coord, mask)


@functools.lru_cache(maxsize=None)
def _jax_seq_grads(pe, grouped, dtype):
    """ao_tpu's train-mode output and parameter gradients (by the port's
    names) of the sequence, jax.grad op by op."""
    feat, coord, mask, r = _seq_inputs()
    seq, var = _jax_seq(pe, grouped, dtype), _seq_variables(pe, grouped)

    def loss(params):
        out, _ = seq.apply({"params": params, "batch_stats": var["batch_stats"]},
                           feat, coord, mask, None, False, False,
                           mutable=["batch_stats"])
        return jnp.sum(out[0] * r), out[0]

    with jax.disable_jit():
        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(var["params"])
    w = convert._Writer(_np(grads), None)
    convert._block_seq(w, "", ())
    return np.asarray(out, np.float32), {k[1:]: v for k, v in w.out.items()}


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("pe,grouped", [(True, True), (False, True), (True, False)],
                         ids=["m1-pe", "m1", "m2-pe"])
def test_legacy_blocksequence_gradients_match_jax(pe, grouped, dtype):
    """A two-block BlockSequence on the legacy attention in train mode
    against ao_tpu's, gradients by jax.grad op by op (as
    test_torch_train_step.py).

    f32: the output within 1e-4 x scale (measured up to 9.4e-7), every
    parameter's gradient within 1e-4 of its scale (measured up to 2.7e-6),
    and the gradients that are zero up to rounding within 1e-2 of the
    largest.

    bf16: the output within 5e-2 x scale of ao_tpu's bf16 output
    (test_torch_train_model.py's bf16 band; measured up to 5.2e-3). Both
    packages' bf16 gradients stand 13-20% (Frobenius, over the parameters
    whose gradient is not zero up to rounding) from the f32 gradients of
    the same weights, and ao_tpu's op-by-op bf16 reductions put its
    zero-up-to-rounding gradients at hundreds of times the port's, so one
    bf16 gradient is no reference for the other: the port's distance to
    the f32 gradients is held to 1.25 times ao_tpu's (measured 0.98-1.00
    times)."""
    C, G, S = _SEQ
    feat, coord, mask, r = _seq_inputs()
    var = _seq_variables(pe, grouped)
    jout, jg = _jax_seq_grads(pe, grouped, dtype)
    w = convert._Writer(_np(var["params"]), _np(var["batch_stats"]))
    convert._block_seq(w, "", ())
    tseq = tm.BlockSequence(2, C, G, S, pe_multiplier=pe, grouped_linear=grouped,
                            dtype=None if dtype is None else torch.bfloat16)
    tseq.load_state_dict({k[1:]: torch.from_numpy(np.array(v))
                          for k, v in w.out.items()}, strict=True)
    tout, cache = tseq.train()(torch.from_numpy(feat), torch.from_numpy(coord),
                               torch.from_numpy(mask))
    assert cache["pos"] is not None and cache["slab"] is None
    (tout.float() * torch.from_numpy(r)).sum().backward()
    tg = {name: p.grad.numpy() for name, p in tseq.named_parameters()}
    assert set(jg) == set(tg)
    band = 1e-4 if dtype is None else 5e-2
    assert np.abs(tout.detach().float().numpy() - jout).max() < band * max(
        np.abs(jout).max(), 1.0)
    if dtype is None:
        gmax = max(np.abs(g).max() for g in jg.values())
        for name, g in jg.items():
            if name.endswith(_ZERO_GRAD):
                assert max(np.abs(g).max(), np.abs(tg[name]).max()) < 1e-2 * gmax, name
            else:
                assert np.abs(tg[name] - g).max() < 1e-4 * max(np.abs(g).max(), 1e-6), name
        return
    _, ref = _jax_seq_grads(pe, grouped, None)  # f32 gradients, same weights
    held = [k for k in ref if not k.endswith(_ZERO_GRAD)]

    def dist(grads):
        return np.sqrt(sum(np.sum((grads[k] - ref[k]) ** 2) for k in held))

    assert dist(tg) <= 1.25 * dist(jg)


def test_ptv2m1_weight_conversion_round_trips(tmp_path):
    """ao_tpu's PT-v2m1 (pe multiplier, GroupedLinear) tree maps onto every
    parameter and buffer of the port's model (strict load) under the
    reference PT-v2m1 names, each flax leaf exactly once; written as an
    .npz of flax paths and read back by load_jax_npz it gives the same
    state dict; the GroupedLinear weight is (1, C)."""
    cfg, var, _ = _jax_variables("PT-v2m1", True)
    params, stats = _np(var["params"]), _np(var["batch_stats"])
    sd = convert.from_jax_variables(params, stats)
    tmodel = build_model(dict(cfg))
    tmodel.load_state_dict(sd, strict=True)
    gl = "patch_embed.blocks.blocks.0.attn.weight_encoding.0.weight"
    assert sd[gl].shape == (1, 16) and "patch_embed.blocks.blocks.0.attn." \
        "linear_p_multiplier.3.weight" in sd
    leaves = {"/".join(str(k.key) for k in path): np.asarray(x) for path, x in
              jax.tree_util.tree_flatten_with_path(
                  {"params": params, "batch_stats": stats})[0]}
    n_tracked = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - n_tracked == len(leaves)
    np.savez(tmp_path / "m1.npz", **leaves)
    back = convert.load_jax_npz(str(tmp_path / "m1.npz"))
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # every value came from one flax leaf, unchanged or transposed
    values = sorted(round(float(np.abs(v).sum()), 3) for v in leaves.values())
    assert values == sorted(round(float(v.abs().sum()), 3) for k, v in sd.items()
                            if not k.endswith("num_batches_tracked"))


def _step_twice(cfg, ckpt, seed=0):
    """Two AdamW steps of a tiny model in train mode on the CPU, its drop
    path and attention dropout drawing from one explicit generator.
    Returns (losses, gradients, state dict, generator state)."""
    torch.manual_seed(seed)
    model = build_model(dict(cfg, enable_checkpoint=ckpt)).train()
    g = torch.Generator().manual_seed(11)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = g
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    coord, feat, mask = (torch.from_numpy(a) for a in _cloud(seed=3))
    losses = []
    for _ in range(2):
        out = model(coord, feat, mask)
        loss = (out[mask] ** 2).mean()
        opt.zero_grad()
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.step()
        losses.append(loss.detach())
    return losses, grads, {k: v.clone() for k, v in model.state_dict().items()}, g.get_state()


@pytest.mark.parametrize("kind,extra", [
    ("PT-v2m2", {}), ("PT-v2m1", dict(pe_multiplier=True, attn_drop_rate=0.1))],
    ids=["m2", "m1-attn-drop"])
def test_enable_checkpoint_gives_the_same_steps(kind, extra):
    """Two train steps with checkpointing on equal the same two steps with
    it off, bit for bit, in f32 with drop path 0.3 (and PT-v2m1's attention
    dropout) drawing from an explicit generator: the losses, the last
    step's gradients and every parameter after it; the running statistics
    were updated once a step (num_batches_tracked 2, their values equal);
    the generator ends in the same state (the recomputation drew the same
    masks and put the generator back)."""
    cfg = dict(_TINY, type=kind, drop_path_rate=0.3, **extra)
    off, on = _step_twice(cfg, False), _step_twice(cfg, True)
    assert all(torch.equal(a, b) for a, b in zip(off[0], on[0]))
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    for k in off[2]:
        assert torch.equal(off[2][k], on[2][k]), k
        if k.endswith("num_batches_tracked"):
            assert int(on[2][k]) == 2, k
    assert torch.equal(off[3], on[3])
    # the masks were drawn: a third run from another generator seed differs
    assert not torch.equal(off[0][0], _step_twice(cfg, False, seed=1)[0][0])


# the scaled-down slab tiling of tests/test_torch_model.py
_GEOM = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)


def test_enable_checkpoint_on_the_fused_train_path(monkeypatch):
    """The card's train path (slab graph, GVATrain on K4, K5, K3 and K6's
    plain versions) under checkpointing: the output and every gradient
    equal the path without it (bit for bit on the CPU); K4's position
    moments are computed once for the stage (the recomputation reuses
    them), K5 and K3 run twice a block (forward and recomputation), K6 once
    a block."""
    n, C, G, S = 256, 48, 6, 8
    rng = np.random.default_rng(0)
    coord = torch.from_numpy(rng.uniform(0, 2, (2, n, 3)).astype(np.float32))
    feat = torch.from_numpy((rng.normal(size=(2, n, C)) * 0.5).astype(np.float32))
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[1, n - 7:] = False
    r = torch.from_numpy(rng.normal(size=(2, n, C)).astype(np.float32))
    calls = {}
    for name in ("gva_pos", "gva_stats", "gva_eval", "gva_bwd"):
        fn = getattr(tm_gva, name)
        monkeypatch.setattr(tm_gva, name, lambda *a, _f=fn, _n=name: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a))[1])
    results = []
    for ckpt in (False, True):
        calls.clear()
        torch.manual_seed(0)
        seq = tm.BlockSequence(2, C, G, S, enable_checkpoint=ckpt,
                               dtype=torch.bfloat16).train()
        out, cache = seq(feat, coord, mask, force=dict(slab=dict(_GEOM), fused=True))
        (out * r).sum().backward()
        results.append((out.detach(), {k: p.grad for k, p in seq.named_parameters()},
                        dict(calls), cache["pos_moments"]))
    (o0, g0, c0, pm0), (o1, g1, c1, pm1) = results
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(pm0, pm1))
    assert c0 == dict(gva_pos=1, gva_stats=2, gva_eval=2, gva_bwd=2)
    assert c1 == dict(gva_pos=1, gva_stats=4, gva_eval=4, gva_bwd=2)


def test_enable_checkpoint_matches_jax_remat():
    """The port's enable_checkpoint model against ao_tpu's (every block
    under nn.remat, its flax names CheckpointBlock_j carried across by
    from_jax_variables), in train mode without drop path (the frameworks'
    random bits differ): the loss of one forward within 1e-5 relative
    (measured 2.2e-6) and the updated running statistics within 1e-4
    (measured 2.8e-7); the port's checkpointed backward runs."""
    cfg, var, _ = _jax_variables("PT-v2m1", True)
    cfg = dict(cfg, enable_checkpoint=True)
    arrays = _cloud(seed=4)
    args = tuple(jnp.asarray(a) for a in arrays)
    jmodel = jax_build_model(dict(cfg))

    def remat_names(tree):  # nn.remat(Block) names its blocks CheckpointBlock_j
        if not isinstance(tree, dict):
            return tree
        return {k.replace("Block_", "CheckpointBlock_") if k.startswith("Block_")
                else k: remat_names(v) for k, v in tree.items()}

    var = jax.tree_util.tree_map(jnp.asarray, remat_names(_np(var)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    assert jax.tree_util.tree_structure(shapes["params"]) == \
        jax.tree_util.tree_structure(var["params"])
    r = np.random.default_rng(5).normal(size=arrays[1].shape[:2] + (5,)).astype(
        np.float32) * arrays[2][..., None]

    def loss(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": var["batch_stats"]},
                                *args, False, False,
                                mutable=["batch_stats", "diagnostics"])
        return jnp.sum(out * r), mut["batch_stats"]

    jloss, jstats = loss(var["params"])
    tmodel = build_model(dict(cfg))
    tmodel.load_state_dict(convert.from_jax_variables(
        _np(var["params"]), _np(var["batch_stats"])), strict=True)
    tloss = (tmodel.train()(*(torch.from_numpy(a) for a in arrays))
             * torch.from_numpy(r)).sum()
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) < 1e-5 * abs(float(jloss))
    sd = tmodel.state_dict()
    for k, v in convert.from_jax_variables(_np(var["params"]), _np(jstats)).items():
        if "running" in k:
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= 1e-4 * max(
                np.abs(v.numpy()).max(), 1.0), k
    assert all(p.grad is not None for p in tmodel.parameters())


@pytest.mark.parametrize("config", ["s3dis/semseg-pt-v2m1-0-base.py",
                                    "scannet/semseg-pt-v2m1-0-origin.py",
                                    "scannet200/semseg-pt-v2m1-0-base.py"])
def test_ptv2m1_config_trains(tmp_path, config):
    """The three PT-v2m1 configs (S3DIS: bf16 compute, interp unpooling,
    MultiStepLR; ScanNet / ScanNet200: f32, Mix3D, OneCycle) build and take
    one train step through the train entry point on the CPU at narrow
    widths, with enable_checkpoint on: a finite loss and gradient norm."""
    from ao_tpu_torch.tools.train import main as train_main

    path = os.path.join(ROOT, "configs", config)
    if config.startswith("s3dis"):
        rooms = [chip_smoke.make_room(s, (0.8, 0.7, 0.5)) for s in (1, 2)]
        _, options = chip_smoke.train_setup(rooms, str(tmp_path), batch_size=2,
                                            max_steps=1, workers=0)
        narrow = dict(enc_channels=(16, 32, 32), enc_groups=(2, 4, 4),
                      dec_channels=(16, 16, 32), dec_groups=(2, 2, 4),
                      enc_depths=(1, 1, 1))
    else:
        rooms = [chip_smoke.make_scannet_room(s, (1.0, 0.9, 0.6), 0.06)
                 for s in (1, 2)]
        if config.startswith("scannet200"):
            for room in rooms:
                room["semantic_gt200"] = np.where(room["semantic_gt20"] < 0, -1,
                                                  room["semantic_gt20"] * 9)
        _, options = chip_smoke.scannet_setup(rooms, workdir=str(tmp_path),
                                              batch_size=2, max_steps=1,
                                              workers=0)
        narrow = dict(enc_channels=(16, 32, 32, 64), enc_groups=(2, 4, 4, 8),
                      dec_channels=(16, 16, 32, 32), dec_groups=(2, 2, 4, 4),
                      enc_depths=(1, 1, 1, 1))
        options.append("max_points=4096")
    narrow.update(patch_embed_channels=16, patch_embed_groups=2,
                  enable_checkpoint=True)
    trainer = train_main(["--config-file", path, "--device", "cpu", "--options",
                          *options, "pad_multiple=512"] + [
        f"model.backbone.{k}={v!r}" for k, v in narrow.items()])
    assert trainer.cfg.model.backbone.type == "PT-v2m1"
    (rec,) = trainer.history
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
