"""PT-v2m2 modules of ao_tpu_torch against ao_tpu's on the same weights
(carried by convert.from_jax_variables) and inputs, in eval mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ao_tpu.models.point_transformer_v2.ptv2m2 as jm
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.models.point_transformer_v2 import convert

# the slab tiling of a C<=96 stage scaled down: kernel tiles of TQ=32
# rows, half-window W=64, kNN windows [t*64 - 32, t*64 + 96) inside every
# covering slab (window = 2W + 2TQ - tile_q, front = W - tile_q + TQ)
_GEOM = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)


def _randomised_stats(stats, rng):
    def leaf(path, x):
        name = str(path[-1])
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
        return jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _seq_case(n=512, C=48, G=6, S=8, seed=0):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 2, (2, n, 3)).astype(np.float32)
    feat = (rng.normal(size=(2, n, C)) * 0.5).astype(np.float32)
    mask = np.ones((2, n), bool)
    mask[1, n - 40:] = False
    seq = jm.BlockSequence(depth=2, embed_channels=C, groups=G, neighbours=S,
                           dtype=jnp.bfloat16)
    var = jax.jit(seq.init)(jax.random.PRNGKey(seed), jnp.asarray(feat),
                            jnp.asarray(coord), jnp.asarray(mask))
    stats = _randomised_stats(var["batch_stats"], rng)
    return coord, feat, mask, seq, {"params": var["params"], "batch_stats": stats}


def _port_seq(var, C=48, G=6, S=8):
    seq = tm.BlockSequence(2, C, G, S, dtype=torch.bfloat16)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    w = convert._Writer(to_np(var["params"]), to_np(var["batch_stats"]))
    convert._block_seq(w, "", ())  # the model's mapping of one sequence
    seq.load_state_dict({k[1:]: torch.from_numpy(np.array(v))
                         for k, v in w.out.items()}, strict=True)
    return seq.eval()


def test_blocksequence_slab_path_matches_jax(monkeypatch):
    """The card's path on both sides: Morton sort, window-restricted graph,
    fused eval GVA (the JAX slab kernel in interpret mode; the port's K3
    plain version), unsort."""
    coord, feat, mask, seq, var = _seq_case()
    monkeypatch.setattr(jm, "_slab_geometry", lambda *a: dict(_GEOM))
    monkeypatch.setattr(jm, "_fused_gva_ok", lambda *a: True)
    orig = jm._gvas.gva_slab_core_eval
    monkeypatch.setattr(jm._gvas, "gva_slab_core_eval",
                        lambda *a: orig(*a, True))
    jout, jcache = seq.apply(var, jnp.asarray(feat), jnp.asarray(coord),
                             jnp.asarray(mask), None, True, True)
    pseq = _port_seq(var)
    with torch.inference_mode():
        tout, tcache = pseq(torch.from_numpy(feat), torch.from_numpy(coord),
                            torch.from_numpy(mask),
                            force=dict(slab=dict(_GEOM), fused=True))
    np.testing.assert_array_equal(tcache["order"].numpy(),
                                  np.asarray(jcache["order"]))
    np.testing.assert_array_equal(tcache["idx"].numpy(), np.asarray(jcache["idx"]))
    jout = np.asarray(jout, np.float32)
    scale = max(np.abs(jout).max(), 1.0)
    # measured: 0 (slab, n=40) and 3.4e-4 x scale (n=1500, 3-probe graph)
    assert np.abs(tout.float().numpy() - jout).max() < 2e-3 * scale


@pytest.mark.parametrize("n", [40, 1500])
def test_blocksequence_cpu_path_matches_jax(n):
    """Both packages' CPU path: exact (n <= 1152) or 3-probe graph, unfused
    GVA with the reference's pad semantics (below 64 points every query
    has pad slots)."""
    coord, feat, mask, seq, var = _seq_case(n=n, seed=n)
    jout, _ = seq.apply(var, jnp.asarray(feat), jnp.asarray(coord),
                        jnp.asarray(mask), None, True, True)
    with torch.inference_mode():
        tout, _ = _port_seq(var)(torch.from_numpy(feat),
                                 torch.from_numpy(coord),
                                 torch.from_numpy(mask))
    jout = np.asarray(jout, np.float32)
    scale = max(np.abs(jout).max(), 1.0)
    # measured: 0 (slab, n=40) and 3.4e-4 x scale (n=1500, 3-probe graph)
    assert np.abs(tout.float().numpy() - jout).max() < 2e-3 * scale


def test_slab_geometry_dispatch():
    """The JAX rules with "backend is tpu" read as "device is cuda"."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tm._slab_geometry(48, 81920, 16, cpu) is None
    assert tm._slab_geometry(512, 81920, 16, cuda) is None
    assert tm._slab_geometry(384, 2047, 16, cuda) is None
    table = {48: (128, 640, 256), 96: (128, 640, 256), 192: (128, 512, 192),
             384: (64, 512, 224)}
    for C, (tile_q, window, front) in table.items():
        g = tm._slab_geometry(C, 3512, 16, cuda)
        assert (g["tile_q"], g["window"], g["front"]) == (tile_q, window, front)
