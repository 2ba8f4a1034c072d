"""Point Transformer V1 of ao_tpu_torch against ao_tpu on the CPU, with the
same numpy inputs and weights (random, from a numpy seed, in the shapes of
ao_tpu's variables, carried across by ``convert.py``): FPS and the
self-kNN index for index (random, padded and integer-grid clouds with
exact ties), the PointTransformerLayer, TransitionDown and TransitionUp
blocks and their train-mode parameter gradients, Seg26 / Cls26 /
PartSeg26 logits and running statistics in train and eval mode, Seg26's
eval-mode parameter gradients against jax.grad, the padded query's
softmax, and the converter over all nine registered names."""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.models.point_transformer.ptv1 as J
from ao_tpu.models import build_model as jax_build_model
from ao_tpu.ops.knn import knn_query as jax_knn_query
from ao_tpu.ops.sampling import farthest_point_sampling as jax_fps
from ao_tpu_torch.models import build_model
from ao_tpu_torch.models.point_transformer import ptv1 as T
from ao_tpu_torch.models.point_transformer.convert import flax_to_torch_state_dict
from ao_tpu_torch.models.utils import Dropout
from ao_tpu_torch.ops.knn import knn_query
from ao_tpu_torch.ops.sampling import farthest_point_sampling

knn_mod = importlib.import_module("ao_tpu_torch.ops.knn")
_np = functools.partial(jax.tree_util.tree_map, np.asarray)
NAMES = [f"PointTransformer-{kind}{depth}" for kind in ("Seg", "Cls", "PartSeg")
         for depth in (26, 38, 50)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Thousands of small ops a forward: one intra-op thread (restored after
    the module), so that the test workers' pools do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(kind, B=2, N=2048, C=6, seed=0):
    """coord (B, N, 3), feat (B, N, C), mask (B, N): uniform in a 4 x 4 x 2
    box; "padded": scene 1 ends with 600 padded rows; "grid": a shuffled
    8^3 lattice (exact distance ties everywhere), N = 512."""
    rng = np.random.default_rng(seed)
    if kind == "grid":
        g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
        g = g.reshape(-1, 3)
        coord = np.stack([g[rng.permutation(len(g))] for _ in range(B)])
    else:
        coord = rng.uniform(0, 1, (B, N, 3)) * np.array([4.0, 4.0, 2.0])
    coord = coord.astype(np.float32)
    mask = np.ones(coord.shape[:2], bool)
    if kind == "padded":
        mask[1, N - 600:] = False
    feat = rng.normal(size=coord.shape[:2] + (C,)).astype(np.float32)
    return coord, feat, mask


def _random_variables(shapes, seed=1):
    """Numpy arrays in the shapes of a flax variables tree: Dense kernels
    normal / sqrt(fan-in), biases normal x 0.1, scales 1 + normal x 0.1,
    running means normal x 0.1, running variances uniform in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _init(module, *args, **kw):
    shapes = jax.eval_shape(functools.partial(module.init, **kw),
                            jax.random.PRNGKey(0), *args)
    return _random_variables(shapes)


def _rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-12))


def _close(t, j, tol=1e-5):
    """All but 1 in 1000 elements within ``tol`` of scale, every one within
    10 x ``tol``. The position encoding's LayerNorm over three channels
    (epsilon 1e-6) divides by the spread of its three inputs: where they
    are nearly equal, it turns the two GEMMs' different roundings (and
    flax's mean(x^2) - mean(x)^2 variance against torch's two-pass one)
    into errors of 1e-5 of scale and more at a handful of points (measured:
    13 elements of 131072 above 1e-5 of scale in the layer, none above
    1e-4)."""
    t, j = np.asarray(t), np.asarray(j)
    err = np.abs(t - j) / max(np.abs(j).max(), 1e-12)
    return (err > tol).mean() <= 1e-3 and err.max() <= 10 * tol


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("kind", ["random", "padded", "grid"])
def test_fps_matches_jax(kind):
    """FPS indices and validity equal to ao_tpu's (padded rows never
    sampled, past n_valid index 0; on the lattice every step is an exact
    tie, resolved to the lowest index)."""
    coord, _, mask = _cloud(kind)
    m = coord.shape[1] // 4
    ji, jv = jax_fps(jnp.asarray(coord), jnp.asarray(mask), m)
    ti, tv = farthest_point_sampling(torch.from_numpy(coord),
                                     torch.from_numpy(mask), m)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert mask[np.arange(2)[:, None], ti.numpy()][tv.numpy()].all()


def test_fps_keeps_more_samples_than_valid_points_at_zero():
    """m above a scene's valid count: the samples past it are invalid and
    hold index 0, as ao_tpu's."""
    coord, _, mask = _cloud("random", N=256)
    mask[1, 40:] = False
    ji, jv = jax_fps(jnp.asarray(coord), jnp.asarray(mask), 64)
    ti, tv = farthest_point_sampling(torch.from_numpy(coord),
                                     torch.from_numpy(mask), 64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv[1].sum() == 40 and (ti[1, 40:] == 0).all()


@pytest.mark.parametrize("kind", ["random", "padded", "grid"])
def test_knn_query_matches_jax(kind):
    """The self-kNN (the point itself first) index for index, validity
    equal, distances within 1e-6 (both recompute them by subtract and
    square; XLA fuses the sum into multiply-adds)."""
    coord, _, mask = _cloud(kind, N=4096)
    ji, jd, jv = jax_knn_query(16, jnp.asarray(coord), jnp.asarray(mask))
    ti, td, tv = knn_query(16, torch.from_numpy(coord), torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ blocks


def _block(jmod, tmod, name, args, train, **kw):
    """ao_tpu's block and the port's on the same inputs and weights in
    train or eval mode; returns (jax outputs, port outputs)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    variables = _init(jmod, *jargs, **kw)
    # the block's trees under its flax name in a model's tree, the port's
    # names under the same prefix
    sd = flax_to_torch_state_dict(
        {name: variables["params"]},
        {name: variables["batch_stats"]} if "batch_stats" in variables else None)
    tmod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()}, strict=True)
    tmod.train(train)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    if isinstance(jmod, J.PointTransformerLayer):
        return jmod.apply(variables, *jargs), tmod(*targs)
    out, _ = jmod.apply(variables, *jargs, use_running_average=not train,
                        mutable=["batch_stats"], **jkw)
    return out, tmod(*targs, **tkw)


def test_point_transformer_layer_matches_jax():
    """The vector attention layer (C=32, 8 shared planes, 16 neighbours) on
    a padded cloud: within 1e-5 of scale as :func:`_close` holds it, padded
    rows 0."""
    coord, _, mask = _cloud("padded")
    feat = np.random.default_rng(3).normal(size=(2, 2048, 32)).astype(np.float32)
    j, t = _block(J.PointTransformerLayer(32, 32, 8, 16),
                  T.PointTransformerLayer(32, 32, 8, 16),
                  "PointTransformerLayer_0", (coord, feat, mask), True)
    assert _close(t.detach(), j)
    assert (t[~torch.from_numpy(mask)] == 0).all()


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_transition_down_matches_jax(train):
    """FPS to N / 4, kNN 16, Linear-BN-ReLU and max pool (C 32 -> 64) on a
    padded cloud: the sampled coordinates and mask equal, the features
    within 1e-5 of scale (:func:`_close`)."""
    coord, _, mask = _cloud("padded")
    feat = np.random.default_rng(4).normal(size=(2, 2048, 32)).astype(np.float32)
    (jc, jh, jm), (tc, th, tm) = _block(
        J.TransitionDown(32, 64, 4, 16), T.TransitionDown(32, 64, 4, 16),
        "enc2_down", (coord, feat, mask), train)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert _close(th.detach(), jh)


@pytest.mark.parametrize("n_fine", [2048, 4096], ids=["exact", "curve"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_transition_up_matches_jax(n_fine, train):
    """Skip Linear-BN-ReLU plus the interpolated coarse features (C 64 ->
    32) from N / 4 points: below the 2M-pair budget (the exact kNN) and
    above it (the 2-probe curve search, K1 and K2's plain versions against
    ao_tpu's CPU path); within 1e-5 of scale (:func:`_close`)."""
    fine, _, fmask = _cloud("padded", N=n_fine, seed=1)
    coarse, _, cmask = _cloud("padded", N=n_fine // 4, seed=2)
    cmask[1, n_fine // 4 - 150:] = False
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, n_fine // 4, 64)).astype(np.float32)
    skip = rng.normal(size=(2, n_fine, 32)).astype(np.float32)
    j, t = _block(J.TransitionUp(64, 32), T.TransitionUp(64, 32), "dec2_up",
                  (coarse, feat, cmask, fine, skip, fmask), train)
    assert _close(t.detach(), j)


def test_transition_up_head_with_shape_class_matches_jax():
    """The PartSeg decoder head: [feature, global mean, one-hot shape class
    -> Linear(1024) -> ReLU] -> Linear-BN-ReLU, train mode: within 1e-5 of
    scale (:func:`_close`)."""
    coord, _, mask = _cloud("padded", N=1024)
    feat = np.random.default_rng(6).normal(size=(2, 1024, 64)).astype(np.float32)
    category = np.array([3, 11], np.int32)
    j, t = _block(J.TransitionUp(64, 0, num_shape_classes=16),
                  T.TransitionUp(64, 0, num_shape_classes=16), "dec5_up",
                  (coord, feat, mask), True, category=category)
    assert _close(t.detach(), j)


def _block_gradients(jmod, tmod, name, args, pick):
    """Parameter gradients of sum(pick(out) * r) of a block in train mode
    (batch statistics): ao_tpu's by jax.grad, the port's in f32 and in
    float64 (a copy of the same block); returns the three dicts under the
    port's names."""
    jargs = [jnp.asarray(a) for a in args]
    variables = _init(jmod, *jargs)
    sd = flax_to_torch_state_dict({name: variables["params"]},
                                  {name: variables["batch_stats"]})
    tmod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()}, strict=True)
    t64 = copy.deepcopy(tmod).double()

    def apply(params):
        out, _ = jmod.apply(dict(variables, params=params), *jargs,
                            use_running_average=False, mutable=["batch_stats"])
        return pick(out)

    r = np.random.default_rng(9).normal(
        size=jax.eval_shape(apply, variables["params"]).shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: (apply(p) * r).sum()))(variables["params"])
    jg = {k[len(name) + 1:]: v.double()
          for k, v in flax_to_torch_state_dict({name: _np(jg)}).items()}
    ports = []
    for model, dt in ((tmod, torch.float32), (t64, torch.float64)):
        model.train()
        out = model(*(torch.from_numpy(a).to(dt) if a.dtype == np.float32
                      else torch.from_numpy(a) for a in args))
        (pick(out) * torch.from_numpy(r).to(dt)).sum().backward()
        ports.append({k: p.grad.double() for k, p in model.named_parameters()})
    return jg, ports[0], ports[1]


def _coarse_fine(n_fine):
    fine, _, fmask = _cloud("padded", N=n_fine, seed=1)
    coarse, _, cmask = _cloud("padded", N=n_fine // 4, seed=2)
    cmask[1, n_fine // 4 - 150:] = False
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, n_fine // 4, 64)).astype(np.float32)
    skip = rng.normal(size=(2, n_fine, 32)).astype(np.float32)
    return coarse, feat, cmask, fine, skip, fmask


def _padded_32():
    """(coord, 32-channel features, mask) of the padded 2048-point cloud."""
    coord, _, mask = _cloud("padded")
    return coord, np.random.default_rng(4).normal(size=(2, 2048, 32)).astype(
        np.float32), mask


_GRAD_BLOCKS = {
    # (ao_tpu block, port block, flax name, inputs, the output held)
    "bottleneck": lambda: (J.Bottleneck(32), T.Bottleneck(32), "enc1_block0",
                           _padded_32(), lambda out: out),
    "down": lambda: (J.TransitionDown(32, 64, 4, 16), T.TransitionDown(32, 64, 4, 16),
                     "enc2_down", _padded_32(), lambda out: out[1]),
    "up_exact": lambda: (J.TransitionUp(64, 32), T.TransitionUp(64, 32), "dec2_up",
                         _coarse_fine(2048), lambda out: out),
    "up_curve": lambda: (J.TransitionUp(64, 32), T.TransitionUp(64, 32), "dec2_up",
                         _coarse_fine(4096), lambda out: out),
}


@pytest.mark.parametrize("block", list(_GRAD_BLOCKS))
def test_block_train_gradients_match_jax(block):
    """Train-mode (batch statistics) parameter gradients of the Bottleneck
    (C=32, 16 neighbours), TransitionDown (32 -> 64) and TransitionUp (64
    -> 32, below and above the 2M-pair budget) on padded clouds against
    jax.grad: every leaf's difference within 1e-3 of its L2 norm, or
    within 3 x the port's own f32-to-float64 gap where that is larger.
    Gradients jump where a ReLU's input rounds to the other side of 0: one
    such element moves a (rows x C) leaf by about 1 / sqrt(rows x C) of its
    norm (the curve case: linear_skip 2.4e-3 between the port's own f32 and
    float64 runs, ao_tpu's f32 3e-7 from the float64 one), and over a whole
    model in train mode such jumps add up to 1e-2 (why Seg26's gradients
    are held in eval mode). Leaves whose true gradient is 0 (a bias before
    a train-mode BatchNorm, the softmax's shift-invariant bias) are
    rounding noise in all three runs: below 1e-4 of the largest leaf."""
    jg, g32, g64 = _block_gradients(*_GRAD_BLOCKS[block]())
    assert set(jg) == set(g32)
    gmax = max(float(g.norm()) for g in g64.values())
    for k, g in g64.items():
        diff = float((g32[k] - jg[k]).norm())
        if float(g.norm()) < 1e-5 * gmax:
            assert max(float(jg[k].norm()), float(g32[k].norm())) < 1e-4 * gmax, k
        else:
            spread = float((g32[k] - g).norm())
            assert diff <= max(1e-3 * float(g.norm()), 3 * spread), (k, diff, spread)


def test_padded_query_softmax_is_zero_with_zero_gradient():
    """A padded query has no valid neighbour: its weights are a softmax over
    -inf (NaN) turned to 0 by the second where, with a gradient of 0 (the
    first where stops the NaN), as jax.grad gives for the same 2 x 2 case;
    the layer's output and input gradients stay finite on padded rows."""
    valid = torch.tensor([[True, False], [False, False]])
    w = torch.tensor([[0.3, -1.2], [0.7, 0.1]], requires_grad=True)
    out = torch.where(valid, torch.softmax(torch.where(valid, w, -torch.inf), 1), 0.0)
    (out * torch.tensor([[2.0, 3.0], [5.0, 7.0]])).sum().backward()

    def jf(x):
        v = jnp.asarray(valid.numpy())
        y = jnp.where(v, jax.nn.softmax(jnp.where(v, x, -jnp.inf), axis=1), 0.0)
        return (y * jnp.asarray([[2.0, 3.0], [5.0, 7.0]])).sum()

    jw = jnp.asarray(w.detach().numpy())
    np.testing.assert_array_equal(out.detach().numpy()[1], [0.0, 0.0])
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jax.grad(jf)(jw)),
                               atol=1e-7)
    assert (w.grad[1] == 0).all()
    coord, feat, mask = (torch.from_numpy(a) for a in _cloud("padded", N=1024))
    layer = T.PointTransformerLayer(6, 16, 8, 16)
    feat.requires_grad_()
    y = layer(coord, feat, mask)
    y.sum().backward()
    assert torch.isfinite(y).all() and (y[~mask] == 0).all()
    assert torch.isfinite(feat.grad).all() and (feat.grad[~mask] == 0).all()


# ------------------------------------------------------------------ models


def _model_pair(name, coord, feat, mask, **kw):
    """ao_tpu's model, its random variables and the port's model with them."""
    jmodel = jax_build_model(dict(type=name, in_channels=6, num_classes=13))
    variables = _init(jmodel, jnp.asarray(coord), jnp.asarray(feat),
                      jnp.asarray(mask), **{k: jnp.asarray(v) for k, v in kw.items()})
    tmodel = _no_dropout(build_model(dict(type=name, in_channels=6, num_classes=13)))
    tmodel.load_state_dict(flax_to_torch_state_dict(
        variables["params"], variables["batch_stats"]), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def chunked_knn():
    """The exact kNN above 2^22 scores in chunks of torch.topk, as the card
    runs it above its 2^28 at full size (here: the cost of a full stable
    sort of every 4096-point scene's scores a layer); both paths give the
    full stable sort's ids."""
    old = knn_mod.CHUNK_ELEMENTS
    knn_mod.CHUNK_ELEMENTS = 2**22
    yield
    knn_mod.CHUNK_ELEMENTS = old


_MODELS = {
    # name: (B, N, padded rows of the last scene, extra inputs); the
    # deepest stage keeps N / 256 points a scene, over which the decoder
    # head's and the classifier's train-mode BatchNorms take their
    # statistics: with 4 points or fewer a scene they amplify the rounding
    # of the layers below by orders of magnitude, so no model runs so thin
    "PointTransformer-Seg26": (2, 4096, 600, {}),
    "PointTransformer-Cls26": (8, 1024, 200, {}),
    "PointTransformer-PartSeg26": (4, 1024, 100,
                                   {"category": np.array([3, 11, 0, 7], np.int32)}),
}
_RESULTS = {}


def _results(name, train):
    """(ao_tpu's logits, running statistics, gradients of sum(logits * r)
    or None; the port's) of ``name`` in train or eval mode, each model run
    once per mode in this module; Seg26 in eval mode with its gradients.
    ao_tpu's side runs jitted (one program per mode, forward and jax.grad
    together where there are gradients)."""
    if (name, train) in _RESULTS:
        return _RESULTS[name, train]
    B, N, pad, extra = _MODELS[name]
    rng = np.random.default_rng(8)
    coord, feat, mask = _cloud("random", B=B, N=N)
    mask[-1, N - pad:] = False
    jmodel, variables, tmodel = _model_pair(name, coord, feat, mask, **extra)
    r = rng.normal(size=(B, N, 13) if "Cls" not in name else (B, 13))
    r = (r * (mask[..., None] if r.ndim == 3 else 1)).astype(np.float32)
    jin = [jnp.asarray(a) for a in (coord, feat, mask)]
    jkw = {k: jnp.asarray(v) for k, v in extra.items()}

    def loss(params):
        out, mut = jmodel.apply(dict(variables, params=params), *jin, True,
                                not train, mutable=["batch_stats"], **jkw)
        return (out * r).sum(), (out, mut["batch_stats"])

    with_grad = name == "PointTransformer-Seg26" and not train
    if with_grad:
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        grads = flax_to_torch_state_dict(_np(grads))
    else:
        _, (out, stats) = jax.jit(loss)(variables["params"])
        grads = None
    jax_side = (np.asarray(out), flax_to_torch_state_dict(
        variables["params"], _np(stats)), grads)
    tmodel.train(train)
    tout = tmodel(*(torch.from_numpy(a) for a in (coord, feat, mask)),
                  **{k: torch.from_numpy(v) for k, v in extra.items()})
    if with_grad:
        (tout * torch.from_numpy(r)).sum().backward()
    port = (tout.detach().numpy(), tmodel.state_dict(),
            {k: p.grad for k, p in tmodel.named_parameters()} if with_grad else None)
    _RESULTS[name, train] = (mask, jax_side, port)
    return _RESULTS[name, train]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(_MODELS))
def test_model_matches_jax(chunked_knn, name, train):
    """Seg26 (B=2 x 4096, 600 padded rows: 1024 -> 4096 crosses the 2M-pair
    budget, so its first unpooling takes the curve search in both
    packages), Cls26 (B=8 x 1024) and PartSeg26 (B=4 x 1024, shape classes
    3, 11, 0 and 7) in eval mode and in train mode (batch statistics;
    dropout off, as ao_tpu's deterministic=True): logits of the valid
    points within 1e-4 of scale in eval mode (measured up to 1.3e-5) and
    1e-3 in train mode (measured up to 1.5e-4; ao_tpu's own jitted and
    op-by-op train forwards lie 1.0e-4 (Seg26) and 2.3e-4 (PartSeg26) of
    scale apart at B=4 x 1024: the batch statistics of the deep stages'
    few points amplify rounding), and after the train forward every
    running statistic within 1e-4 of its scale."""
    mask, (j, jstats, _), (t, tstats, _) = _results(name, train)
    if j.ndim == 3:
        j, t = j[mask], t[mask]
    assert _rel(t, j) <= (1e-3 if train else 1e-4)
    if train:
        for k, v in jstats.items():
            if "running" in k:
                assert _rel(tstats[k], v) <= 1e-4, k


def test_seg26_gradients_match_jax(chunked_knn):
    """Seg26's parameter gradients of sum(logits * r) over the valid points
    (eval mode: running statistics) against jax.grad: for every parameter
    the difference's L2 norm within 1e-3 of the gradient's (measured up to
    9.6e-4, at the first layer's position encoding, whose 3-channel
    LayerNorm conditions both), but the weight encoding's last bias,
    whose gradient is rounding noise in both (the softmax over the
    neighbours is shift invariant): below 1e-2 of the largest gradient.
    In train mode (batch statistics) the whole model's f32 gradients jump
    at ReLU inputs that round to the other side of 0 (see
    :func:`test_block_train_gradients_match_jax`): ao_tpu's own jitted and
    op-by-op gradients lie 2e-3 to 1.7e-2 of each leaf apart at the last
    decoder block, so train mode is held block by block."""
    _, (_, _, grads), (_, _, tgrads) = _results("PointTransformer-Seg26", False)
    assert set(grads) == set(tgrads)
    gmax = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        if k.endswith("linear_w.5.bias"):
            assert max(float(g.abs().max()), float(tgrads[k].abs().max())) < 1e-2 * gmax, k
        else:
            assert float((tgrads[k] - g).norm()) <= 1e-3 * float(g.norm()), k


@pytest.mark.parametrize("name", NAMES)
def test_converter_round_trip(name):
    """Every registered PT-v1 name: ao_tpu's variables (in the shapes its
    init gives at 512 points) carried across load into the port's model
    strictly, leaf for leaf: as many tensors as flax leaves (plus a
    num_batches_tracked a BatchNorm), each equal to its flax array (Dense
    kernels transposed)."""
    coord, feat, mask = (jnp.asarray(a) for a in _cloud("random", N=512))
    kw = {"category": jnp.zeros((2,), jnp.int32)} if "PartSeg" in name else {}
    jmodel = jax_build_model(dict(type=name, in_channels=6, num_classes=13))
    variables = _init(jmodel, coord, feat, mask, **kw)
    sd = flax_to_torch_state_dict(variables["params"], variables["batch_stats"])
    model = build_model(dict(type=name, in_channels=6, num_classes=13))
    model.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(variables)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) == len(leaves) + n_bn
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
