"""PT-v2m2 modules of ao_tpu_torch in train mode against ao_tpu's on the
same weights (carried by convert.from_jax_variables) and inputs: masked
batch-norm statistics and running updates, the BlockSequence on the card's
slab path (K3-K6 plain versions against the Pallas kernels in interpret
mode) and on the CPU path, and the gradients of the grid pool, the
interpolation and the grouping."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.models.point_transformer_v2.ptv2m2 as jm
from ao_tpu.models.utils import PointBatchNorm as JaxPBN
from ao_tpu.ops import grid_pool as jax_grid_pool
from ao_tpu.ops import grouping as jax_grouping
from ao_tpu.ops import interpolation as jax_interpolation
from ao_tpu_torch.models.point_transformer_v2 import convert
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.models.utils import DropPath, PointBatchNorm
from ao_tpu_torch.ops import grid_pool, grouping, interpolation
from ao_tpu_torch.ops import gva as tm_gva

# the scaled-down slab tiling of tests/test_torch_model.py
_GEOM = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def test_point_batchnorm_train_matches_jax():
    """Masked batch statistics, the running update (unbiased variance,
    momentum 0.1) and the gradients w.r.t. input, scale and bias (measured
    1.2e-7 relative; 1e-5 allowed)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 50, 8)) * 2 + 1).astype(np.float32)
    mask = rng.random((2, 50)) < 0.8
    r = rng.normal(size=(2, 50, 8)).astype(np.float32)
    mod = JaxPBN(8)
    var = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}
    stats = {"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, 8), jnp.float32)}

    def loss(p, xx):
        y, mut = mod.apply({"params": p, "batch_stats": stats}, xx,
                           jnp.asarray(mask), False, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = PointBatchNorm(8).train()
    with torch.no_grad():
        bn.norm.weight.copy_(torch.from_numpy(np.asarray(params["scale"])))
        bn.norm.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        bn.norm.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
        bn.norm.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = bn(tx, torch.from_numpy(mask))
    gx, gw, gb = torch.autograd.grad((ty * torch.from_numpy(r)).sum(),
                                     (tx, bn.norm.weight, bn.norm.bias))
    for a, b in ((ty.detach(), jy), (bn.norm.running_mean, jstats["mean"]),
                 (bn.norm.running_var, jstats["var"]), (gx, jgx),
                 (gw, jgp["scale"]), (gb, jgp["bias"])):
        assert _rel(a.detach().numpy(), b) < 1e-5
    assert float(ty[~torch.from_numpy(mask)].abs().max()) == 0.0


def _seq_case(n, C=48, G=6, S=8, seed=0, dtype=None, depth=2):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 2, (2, n, 3)).astype(np.float32)
    feat = (rng.normal(size=(2, n, C)) * 0.5).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n - 7:] = False
    seq = jm.BlockSequence(depth=depth, embed_channels=C, groups=G,
                           neighbours=S, dtype=dtype)
    var = jax.jit(seq.init)(jax.random.PRNGKey(seed), jnp.asarray(feat),
                            jnp.asarray(coord), jnp.asarray(mask))
    r = rng.normal(size=(2, n, C)).astype(np.float32)
    return coord, feat, mask, seq, var, r


def _port_seq(var, C=48, G=6, S=8, dtype=None, depth=2):
    seq = tm.BlockSequence(depth, C, G, S, dtype=dtype)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    w = convert._Writer(to_np(var["params"]), to_np(var["batch_stats"]))
    convert._block_seq(w, "", ())  # the model's mapping of one sequence
    seq.load_state_dict({k[1:]: torch.from_numpy(np.array(v))
                         for k, v in w.out.items()}, strict=True)
    return seq.train()


def _named(tree, stats=None):
    """A JAX sequence's params (and stats) by the port's names."""
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    w = convert._Writer(to_np(tree), None if stats is None else to_np(stats))
    convert._block_seq(w, "", ())
    return {k[1:]: v for k, v in w.out.items()}


def _jax_train(seq, var, feat, coord, mask, r):
    def loss(params):
        out, mut = seq.apply(
            {"params": params, "batch_stats": var["batch_stats"]},
            jnp.asarray(feat), jnp.asarray(coord), jnp.asarray(mask), None,
            False, False, mutable=["batch_stats"])
        return jnp.sum(out[0] * r), (out[0], mut["batch_stats"])

    (_, (out, stats)), grads = jax.value_and_grad(loss, has_aux=True)(
        var["params"])
    return np.asarray(out, np.float32), stats, grads


# parameters whose gradient is zero up to rounding: biases whose shift a
# BatchNorm removes (the q / k / pe / weight-encoding first layers, v's and
# the pe MLP's second, whose constants reach norm2 through the
# softmax-weighted sum and the weight BN through the relation) and b2 (the
# softmax is shift-invariant)
_ZERO_GRAD = ("linear_q.0.bias", "linear_k.0.bias", "linear_v.bias",
              "linear_p_bias.0.bias", "linear_p_bias.3.bias",
              "weight_encoding.0.bias", "weight_encoding.3.bias")


def _compare_train(var, jout, jstats, jgrads, tseq, tout, tol_out, tol_grad):
    """Output against its scale, updated running statistics, and every
    parameter gradient by name against its own scale (the zero-up-to-
    rounding ones against 1e-2 of the largest gradient)."""
    jout_s = max(np.abs(jout).max(), 1.0)
    assert np.abs(tout.detach().float().numpy() - jout).max() < tol_out * jout_s
    js = _named(var["params"], jstats)
    sd = tseq.state_dict()
    for k, v in js.items():
        if "running" in k:  # the updated running statistics
            assert _rel(sd[k].numpy(), v) < 1e-3, k
    jg = _named(jgrads)
    gmax = max(np.abs(x).max() for x in jg.values())
    for name, p in tseq.named_parameters():
        g, tg = jg[name], p.grad.numpy()
        if name.endswith(_ZERO_GRAD):
            assert max(np.abs(g).max(), np.abs(tg).max()) < 1e-2 * gmax, name
            continue
        err = np.abs(tg - g).max() / max(np.abs(g).max(), 1e-6)
        assert err < tol_grad, (name, err)


@pytest.mark.parametrize("depth", [1, 2])
def test_blocksequence_train_slab_path_matches_jax(monkeypatch, depth):
    """The card's train path on both sides: Morton sort, window-restricted
    graph, position moments once per resolution, the fused train GVA (the
    JAX slab kernels in interpret mode; the port's GVATrain on K3-K6's plain
    versions), masked batch statistics; the dense layers in f32. Output
    within 2e-3 x scale (measured 3.3e-5 / 2.6e-4 at depth 1 / 2), running
    statistics within 1e-3 (measured 7e-7 / 2.2e-5). Parameter gradients
    within 0.05 of their scale (measured 8.8e-3 / 8.3e-3): given identical
    inputs the fused GVA's agree to 1e-5 (test_torch_train_kernels.py), but
    q, k and v round to bf16 at the kernel's input, and wherever the two
    frameworks' f32 values differ in the last bit that rounding flips by
    one unit, which the batch-statistic BatchNorms amplify (at n=512 the
    same check measured 2.6e-2 / 9.5e-2)."""
    coord, feat, mask, seq, var, r = _seq_case(n=256, depth=depth)
    monkeypatch.setattr(jm, "_slab_geometry", lambda *a: dict(_GEOM))
    monkeypatch.setattr(jm, "_fused_gva_ok", lambda *a: True)
    core, pos = jm._gvas.gva_slab_core, jm._gvas.compute_pos_moments_slab
    monkeypatch.setattr(jm._gvas, "gva_slab_core", lambda *a: core(*a, True))
    monkeypatch.setattr(jm._gvas, "compute_pos_moments_slab",
                        lambda *a: pos(*a, True))
    jout, jstats, jgrads = _jax_train(seq, var, feat, coord, mask, r)
    tseq = _port_seq(var, depth=depth)
    calls = []
    pos_port = tm_gva.gva_pos
    monkeypatch.setattr(tm_gva, "gva_pos", lambda *a: calls.append(1) or pos_port(*a))
    tout, cache = tseq(torch.from_numpy(feat), torch.from_numpy(coord),
                       torch.from_numpy(mask),
                       force=dict(slab=dict(_GEOM), fused=True))
    assert len(calls) == 1 and cache["pos_moments"] is not None
    (tout.float() * torch.from_numpy(r)).sum().backward()
    _compare_train(var, jout, jstats, jgrads, tseq, tout, 2e-3, 0.05)


def test_blocksequence_train_cpu_path_matches_jax(n=120):
    """Both packages' CPU path in train mode, in f32: the unfused GVA with
    the reference's pad semantics (batch moments over every slot of a valid
    query) differentiated by autograd on both sides. Output within 1e-4 x
    scale (measured 6.1e-7), gradients within 1e-4 of scale (measured
    2.4e-6)."""
    coord, feat, mask, seq, var, r = _seq_case(n=n, seed=n)
    jout, jstats, jgrads = _jax_train(seq, var, feat, coord, mask, r)
    tseq = _port_seq(var)
    tout, cache = tseq(torch.from_numpy(feat), torch.from_numpy(coord),
                       torch.from_numpy(mask))
    assert cache["pos_moments"] is None  # the unfused path takes no moments
    (tout.float() * torch.from_numpy(r)).sum().backward()
    _compare_train(var, jout, jstats, jgrads, tseq, tout, 1e-4, 1e-4)


@pytest.mark.parametrize("ties", [False, True])
def test_grid_pool_gradient_matches_jax(ties):
    """d(pooled features)/d(features). torch's scatter_reduce "amax" splits
    a maximum's gradient evenly among tied maxima, and so does jax.grad of
    the JAX package's segment_max (checked: both give [0, .5, .5, 1] for
    values [1, 3, 3 | 2]); tie-free and tied features agree to 1e-6
    (measured 0 / 6e-8)."""
    rng = np.random.default_rng(3)
    coord = rng.uniform(0, 1, (2, 200, 3)).astype(np.float32)
    feat = rng.normal(size=(2, 200, 5)).astype(np.float32)
    if ties:
        feat = np.round(feat)  # many exact ties per voxel and channel
    mask = rng.random((2, 200)) < 0.9
    r = rng.normal(size=(2, 64, 5)).astype(np.float32)

    def jloss(f):
        _, pf, _, _, _ = jax_grid_pool(jnp.asarray(coord), f, jnp.asarray(mask),
                                       0.25, max_clusters=64)
        return jnp.sum(pf * r)

    jg = jax.grad(jloss)(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    _, pf, _, _, _ = grid_pool(torch.from_numpy(coord), tf,
                               torch.from_numpy(mask), 0.25, 64)
    (tg,) = torch.autograd.grad((pf * torch.from_numpy(r)).sum(), tf)
    assert np.abs(tg.numpy() - np.asarray(jg)).max() < 1e-6


def test_interpolation_and_grouping_gradients_match_jax():
    """Gradients of the 3-NN inverse-distance interpolation and of the
    neighbour grouping w.r.t. their features (measured 2.4e-7 and 0)."""
    rng = np.random.default_rng(4)
    src_c = rng.uniform(0, 1, (2, 60, 3)).astype(np.float32)
    dst_c = rng.uniform(0, 1, (2, 150, 3)).astype(np.float32)
    f = rng.normal(size=(2, 60, 4)).astype(np.float32)
    sm, dm = rng.random((2, 60)) < 0.9, rng.random((2, 150)) < 0.9
    r = rng.normal(size=(2, 150, 4)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jax_interpolation(
        jnp.asarray(src_c), jnp.asarray(dst_c), x, jnp.asarray(sm),
        jnp.asarray(dm), k=3) * r))(jnp.asarray(f))
    tf = torch.from_numpy(f).requires_grad_(True)
    out = interpolation(torch.from_numpy(src_c), torch.from_numpy(dst_c), tf,
                        torch.from_numpy(sm), torch.from_numpy(dm), k=3)
    (tg,) = torch.autograd.grad((out * torch.from_numpy(r)).sum(), tf)
    assert np.abs(tg.numpy() - np.asarray(jg)).max() < 1e-5

    idx = rng.integers(0, 60, (2, 30, 8)).astype(np.int32)
    valid = rng.random((2, 30, 8)) < 0.8
    r2 = rng.normal(size=(2, 30, 8, 4)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jax_grouping(
        x, jnp.asarray(idx), jnp.asarray(valid)) * r2))(jnp.asarray(f))
    tf = torch.from_numpy(f).requires_grad_(True)
    out = grouping(tf, torch.from_numpy(idx), torch.from_numpy(valid))
    (tg,) = torch.autograd.grad((out * torch.from_numpy(r2)).sum(), tf)
    assert np.abs(tg.numpy() - np.asarray(jg)).max() < 1e-6


def test_drop_path_draws_from_its_generator():
    """Train mode keeps each sample with probability 1 - rate, scaled by
    1 / (1 - rate), drawing from the given generator on the tensor's
    device; eval mode is the identity."""
    x = torch.ones(64, 5, 3)
    dp = DropPath(0.25, torch.Generator().manual_seed(1)).train()
    y1 = dp(x)
    dp.generator = torch.Generator().manual_seed(1)
    assert torch.equal(dp(x), y1)
    kept = y1[:, 0, 0] > 0
    assert 0 < int(kept.sum()) < 64
    assert torch.allclose(y1[kept], torch.full_like(y1[kept], 1 / 0.75))
    assert float(y1[~kept].abs().max()) == 0.0
    assert torch.equal(dp.eval()(x), x)
