"""The sparse-convolution family of ao_tpu_torch against ao_tpu on the CPU:
the ops of ops/sparse_conv.py bit for bit (tables, lookups with
out-of-range and missing probes, neighbour rows of padded and duplicated
sites, stride-2 sites with a capacity below the unique count and its
overflow counted by hand), sparse_conv_apply's values and gradients
(against jax.grad, the plain gather-then-einsum version and
torch.autograd.gradcheck), and the tiny backbones (SpUNet-v1m1 / v1m2,
MinkUNet14 / 34C / 50, SPVCNN) with ao_tpu's weights carried across by
``from_jax_variables``: eval and train logits, running statistics, with
``discrete_coord`` given and absent, and SpUNet's whole-model gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops import sparse_conv as J
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.sparse_unet import convert
from ao_tpu_torch.models.utils import Dropout
from ao_tpu_torch.ops import sparse_conv as T

_np = functools.partial(jax.tree_util.tree_map, np.asarray)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny sparse models run thousands of small ops: one intra-op
    thread each (restored after the module), so that the test workers'
    thread pools do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _sites(B=2, M=256, extent=7, seed=0):
    """Integer sites in [0, extent)^3: scene 0's last 56 rows repeat its
    first 56 (two scenes merged by Mix3D), scene 1's last 56 are padding."""
    rng = np.random.default_rng(seed)
    dc = rng.integers(0, extent, (B, M, 3)).astype(np.int32)
    dc[0, M - 56:] = dc[0, :56]
    mask = np.ones((B, M), bool)
    mask[1, M - 56:] = False
    return dc, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _eq(t, j):
    return np.array_equal(t.numpy(), np.asarray(j))


def test_table_lookup_and_neighbours_match_jax():
    """build_table's order and extent, the sorted keys of the valid rows,
    lookup of probes in range, out of range (negative and past the
    extent) and missing, and neighbor_idx's rows and validity for k = 3,
    5 (submanifold) and 2 (stride 2 onto the coarse sites), all bit-equal
    to ao_tpu's, duplicates and padding rows included (a duplicated site
    resolves to the same row: stable sorts in both)."""
    dc, mask = _sites()
    tdc, tmask = _t(dc, mask)
    jt = J.build_table(jnp.asarray(dc), jnp.asarray(mask))
    tt = T.build_table(tdc, tmask)
    assert _eq(tt[1], jt[1]) and _eq(tt[2], jt[2])
    n_valid = mask.sum(1)
    for b in range(2):
        assert _eq(tt[0][b, :n_valid[b]], jt[0][b, :n_valid[b]])
    rng = np.random.default_rng(1)
    probes = rng.integers(-2, 10, (2, 400, 3)).astype(np.int32)
    ji, jf = J.lookup(*jt[:2], jnp.asarray(probes), jt[2])
    ti, tf = T.lookup(*tt[:2], torch.from_numpy(probes), tt[2])
    assert _eq(ti, ji) and _eq(tf, jf)
    out_of_range = ((probes < 0) | (probes >= 7)).any(-1)
    assert out_of_range.sum() > 50 and not tf.numpy()[out_of_range].any()
    assert ((~tf.numpy()) & ~out_of_range).sum() > 20  # missing sites
    for ks in (3, 5):
        ji, jv = J.neighbor_idx(jt, jnp.asarray(dc), jnp.asarray(dc),
                                jnp.asarray(mask), J.kernel_offsets(ks))
        ti, tv = T.neighbor_idx(tt, tdc, tmask, T.kernel_offsets(ks))
        assert _eq(ti, ji) and _eq(tv, jv)
        assert not tv.numpy()[1, 200:].any()
    out_dc, out_mask, _ = J.sparse_downsample(jnp.asarray(dc), jnp.asarray(mask), 64)
    ji, jv = J.neighbor_idx(jt, jnp.asarray(dc), out_dc, out_mask,
                            J.kernel_offsets(2), stride=2)
    ti, tv = T.neighbor_idx(tt, torch.from_numpy(np.asarray(out_dc)),
                            torch.from_numpy(np.asarray(out_mask)),
                            T.kernel_offsets(2), stride=2)
    assert _eq(ti, ji) and _eq(tv, jv)
    # the two rows of a duplicated site find the same row
    assert torch.equal(T.lookup(*tt[:2], tdc[:, :56], tt[2])[0][0],
                       T.lookup(*tt[:2], tdc[:, 200:], tt[2])[0][0])


@pytest.mark.parametrize("cap", [256, 48], ids=["ample", "overflowing"])
def test_sparse_downsample_matches_jax(cap):
    """The coarse sites, their mask and every fine site's parent bit-equal
    to ao_tpu's sparse_downsample, at an ample capacity and at one below
    the unique count (the clusters beyond it merge into the last row);
    the overflow is the unique coarse sites beyond the capacity, counted
    by hand with numpy, summed over the scenes."""
    dc, mask = _sites(extent=9)
    jo = J.sparse_downsample(jnp.asarray(dc), jnp.asarray(mask), cap)
    to = T.sparse_downsample(*_t(dc, mask), cap)
    assert all(_eq(t, j) for t, j in zip(to[:3], jo))
    unique = [len(np.unique(dc[b][mask[b]] // 2, axis=0)) for b in range(2)]
    assert int(to[3]) == sum(max(u - cap, 0) for u in unique)
    assert (int(to[3]) > 0) == (cap == 48)


def test_sparse_conv_apply_matches_jax():
    """sparse_conv_apply (the recomputing Function) on k=3 neighbour rows
    against ao_tpu's gather-then-einsum: values, and the gradients of feat
    and kernel against jax.grad, within 1e-5 of scale (measured up to
    2.0e-7); the plain version sparse_conv_apply_plain agrees with the
    Function as closely (up to 2.7e-7)."""
    dc, mask = _sites()
    tt = T.build_table(*_t(dc, mask))
    idx, valid = T.neighbor_idx(tt, *_t(dc, mask), T.kernel_offsets(3))
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 256, 5)).astype(np.float32)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    r = rng.normal(size=(2, 256, 7)).astype(np.float32)
    ji, jv = jnp.asarray(idx.numpy().astype(np.int32)), jnp.asarray(valid.numpy())

    def jloss(f, k):
        return (J.sparse_conv_apply(f, ji, jv, k) * r).sum()

    jout = np.asarray(J.sparse_conv_apply(jnp.asarray(feat), ji, jv, jnp.asarray(w)))
    jgf, jgw = jax.grad(jloss, (0, 1))(jnp.asarray(feat), jnp.asarray(w))
    outs = []
    for fn in (T.sparse_conv_apply, T.sparse_conv_apply_plain):
        f, k = (torch.from_numpy(a).requires_grad_() for a in (feat, w))
        out = fn(f, idx, valid, k)
        (out * torch.from_numpy(r)).sum().backward()
        outs.append((out.detach().numpy(), f.grad.numpy(), k.grad.numpy()))
    for t, j in zip(outs[0], (jout, jgf, jgw)):
        j = np.asarray(j)
        assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max()
    for t, p in zip(*outs):
        assert np.abs(t - p).max() <= 1e-5 * np.abs(p).max()


def test_sparse_conv_apply_gradcheck():
    """torch.autograd.gradcheck of the Function in f64 on a toy voxel set
    (k=3 rows with invalid slots, a padded scene, a duplicated site)."""
    dc, mask = _sites(M=64, extent=3, seed=3)
    tt = T.build_table(*_t(dc, mask))
    idx, valid = T.neighbor_idx(tt, *_t(dc, mask), T.kernel_offsets(3))
    assert not valid.all()
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(2, 64, 3, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(27, 3, 4, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda f, k: T.sparse_conv_apply(f, idx, valid, k), (feat, w))


# ------------------------------------------------------------- backbones

_W8 = (8, 16, 16, 16, 16, 16, 8, 8)
_ONE = (1,) * 8
_BACKBONES = {
    "spunet-v1m1": dict(type="SpUNet-v1m1", in_channels=4, num_classes=5,
                        base_channels=8, channels=_W8, layers=_ONE),
    "spunet-v1m2": dict(type="SpUNet-v1m2", in_channels=4, num_classes=5,
                        base_channels=8, channels=_W8, layers=_ONE,
                        bn_momentum=0.1),
    "minkunet14": dict(type="MinkUNet14", in_channels=4, num_classes=5,
                       base_channels=8, channels=_W8),
    "minkunet34c": dict(type="MinkUNet34C", in_channels=4, num_classes=5,
                        base_channels=8, channels=(8, 8, 8, 16, 16, 8, 8, 8),
                        layers=(1, 2, 1, 2, 1, 1, 1, 1)),
    "minkunet50": dict(type="MinkUNet50", in_channels=4, num_classes=5,
                       base_channels=8, channels=(4,) * 8, layers=_ONE),
    "spvcnn": dict(type="SPVCNN", in_channels=4, out_channels=5,
                   base_channels=8, channels=_W8, layers=_ONE),
}


def _inputs(fallback):
    """(coord, feat, mask, discrete_coord or None). With the fallback the
    coordinates are in grid units, so that floor(coord - min) is a grid."""
    dc, mask = _sites(extent=7, seed=4)
    rng = np.random.default_rng(5)
    jitter = rng.uniform(0.05, 0.95, dc.shape).astype(np.float32)
    feat = rng.normal(size=dc.shape[:2] + (4,)).astype(np.float32)
    if fallback:
        return (dc + jitter).astype(np.float32), feat, mask, None
    return ((dc + jitter) * 0.05).astype(np.float32), feat, mask, dc


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """ao_tpu's tiny backbone and random variables (kernels of He scale,
    BatchNorm scales, biases and running statistics away from 1 and 0)."""
    cfg = _BACKBONES[name]
    module = jax_build_model(dict(cfg))
    coord, feat, mask, dc = _inputs(False)
    shapes = jax.eval_shape(
        functools.partial(module.init, discrete_coord=jnp.asarray(dc)),
        jax.random.PRNGKey(0), jnp.asarray(coord), jnp.asarray(feat),
        jnp.asarray(mask))
    rng = np.random.default_rng(list(_BACKBONES).index(name))

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf in ("kernel",) or leaf.endswith("_kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return module, {k: variables[k] for k in ("params", "batch_stats")}


@functools.partial(jax.jit, static_argnums=(0, 6))
def _jax_apply(module, variables, coord, feat, mask, dc, train):
    if train:
        return module.apply(variables, coord, feat, mask, True, False,
                            discrete_coord=dc, mutable=["batch_stats"])
    return module.apply(variables, coord, feat, mask, True, True,
                        discrete_coord=dc), None


def _rel(t, j, mask):
    j = np.asarray(j, np.float32)
    return np.abs(t - j)[mask].max() / max(np.abs(j[mask]).max(), 1.0)


@pytest.mark.parametrize("name,fallback", [
    (name, False) for name in _BACKBONES] + [
    (name, True) for name in ("spunet-v1m1", "spunet-v1m2", "spvcnn")],
    ids=lambda v: {False: "dc", True: "fallback"}.get(v, v))
def test_backbone_matches_jax(name, fallback):
    """A tiny backbone with ao_tpu's variables carried across by
    from_jax_variables (strict), on the same inputs with discrete_coord
    given (coordinates of 0.05 m cells) and, for the two classes that
    derive the sites themselves (SpUNet, which the MinkUNets are, and
    SPVCNN), absent (floor(coord - min) in both). Eval logits within 1e-4
    of scale (measured up to 4.4e-7), train-mode logits within 1e-3 of
    scale (up to 9.1e-5: batch statistics amplify the frameworks'
    different summation orders), the updated running statistics within
    1e-5 of theirs (up to 2.7e-6). The
    backbone reports its stage overflow, and SPVCNN's two dropouts are off
    in train mode, as ao_tpu's with deterministic=True."""
    module, var = _jax_model(name)
    coord, feat, mask, dc = _inputs(fallback)
    args = [jnp.asarray(a) for a in (coord, feat, mask)]
    jdc = None if dc is None else jnp.asarray(dc)
    targs = _t(coord, feat, mask)
    tdc = None if dc is None else torch.from_numpy(dc)
    model = build_model(dict(_BACKBONES[name]))
    model.load_state_dict(convert.from_jax_variables(_np(var)), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    jout, _ = _jax_apply(module, var, *args, jdc, False)
    with torch.no_grad():
        tout = model.eval()(*targs, discrete_coord=tdc)
    assert _rel(tout.numpy(), jout, mask) < 1e-4
    assert model.stage_overflow.shape == (4,)
    assert int(model.pool_overflow) == int(model.stage_overflow.sum())
    jout, mut = _jax_apply(module, var, *args, jdc, True)
    with torch.no_grad():
        tout = model.train()(*targs, discrete_coord=tdc)
    assert _rel(tout.numpy(), jout, mask) < 1e-3
    sd = model.state_dict()
    ref = convert.from_jax_variables(_np(dict(params=var["params"],
                                              batch_stats=mut["batch_stats"])))
    stats = [k for k in ref if "running" in k]
    assert len(stats) >= 20
    for k in stats:
        v = ref[k].numpy()
        assert np.abs(sd[k].numpy() - v).max() <= 1e-5 * max(np.abs(v).max(), 1.0), k


def test_spunet_gradients_match_jax():
    """The tiny SpUNet-v1m1's whole-model gradients in train mode (batch
    statistics) of sum(logits * r) over the valid rows against jax.grad,
    every parameter within 1e-4 of its own scale (measured up to 1.1e-5),
    mapped onto the port's names by from_jax_variables."""
    module, var = _jax_model("spunet-v1m1")
    coord, feat, mask, dc = _inputs(False)
    r = np.random.default_rng(6).normal(size=(2, 256, 5)).astype(np.float32)
    r *= mask[..., None]

    def loss(params):
        out, _ = module.apply(dict(var, params=params), jnp.asarray(coord),
                              jnp.asarray(feat), jnp.asarray(mask), True,
                              False, discrete_coord=jnp.asarray(dc),
                              mutable=["batch_stats"])
        return (out * r).sum()

    grads = convert.from_jax_variables(_np(jax.jit(jax.grad(loss))(var["params"])))
    model = build_model(dict(_BACKBONES["spunet-v1m1"]))
    model.load_state_dict(convert.from_jax_variables(_np(var)), strict=True)
    out = model.train()(*_t(coord, feat, mask), discrete_coord=torch.from_numpy(dc))
    (out * torch.from_numpy(r)).sum().backward()
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for k, g in grads.items():
        g = g.numpy()
        assert np.abs(named[k].grad.numpy() - g).max() <= 1e-4 * np.abs(g).max(), k
