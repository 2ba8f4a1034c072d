"""The train-mode GVA of ao_tpu_torch (K4 gva_pos, K5 gva_stats, K3 with
batch-statistic folds, K6 gva_bwd and the GVATrain function around them)
against the TPU kernels of ao_tpu run in Pallas interpret mode, in both
call modes: slab (gva_slab.compute_pos_moments_slab / gva_slab_core) and
gathered (gva_fused.compute_pos_moments / gva_core), on the case of
tests/test_gva_slab.py and at the ScanNet config's new shapes: its patch
embed's S = 8 at C = 48 (both modes) and its C = 512 stage (G = 64,
gathered, as the card runs it).

On the CPU every wrapper runs its kernel's plain version; chip_smoke.py
holds the CUDA kernels against the same plain versions on the card. The
hand-written backward is also checked against autograd of the plain
forward composition in float64, where the plain versions skip the bf16
rounding and evaluate the exact algebra."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ao_tpu.ops.pallas import gva_fused as gf
from ao_tpu.ops.pallas import gva_slab as gs
from ao_tpu_torch.ops import gva as tg

# (B, N, S, C, G, TQ, J) of the cases: "base" is the case of
# tests/test_gva_slab.py (every edge inside its query tile's slab); "S8-C48"
# the ScanNet patch embed's neighbours and width; "C512" its C = 512 stage
# at a few dozen queries (the JAX package's gathered tiling, TQ = 32)
SHAPES = {"base": (2, 90, 8, 16, 4, 32, 3), "S8-C48": (1, 90, 8, 48, 6, 32, 3),
          "C512": (1, 40, 16, 512, 64, 32, 3)}
B, N, S, C, G, TQ, J = SHAPES["base"]
PNAMES = ("Wp1", "bp1", "gp", "bp", "Wp2", "bp2", "W1", "b1", "gw", "bw",
          "W2", "b2")
# (mode, shape) of the tests held at every shape; the base shape's cases
# keep their ids
MODES = [pytest.param("slab", "base", id="slab"),
         pytest.param("gathered", "base", id="gathered"),
         pytest.param("slab", "S8-C48", id="slab-S8-C48"),
         pytest.param("gathered", "S8-C48", id="gathered-S8-C48"),
         pytest.param("gathered", "C512", id="gathered-C512")]


@functools.lru_cache(maxsize=None)
def make_case(shape="base"):
    B, N, S, C, G, TQ, J = SHAPES[shape]
    W = (J - 1) // 2 * TQ
    NP = -(-N // TQ) * TQ
    rng = np.random.default_rng(7)
    c = dict(
        k=rng.normal(size=(B, N, C)) * 0.5, v=rng.normal(size=(B, N, C)) * 0.5,
        coord=rng.uniform(0, 4, (B, N, 3)), q=rng.normal(size=(B, NP, C)) * 0.5,
        qcoord=rng.uniform(0, 4, (B, NP, 3)),
    )
    c = {k: a.astype(np.float32) for k, a in c.items()}
    idx = np.zeros((B, NP, S), np.int32)
    for i in range(NP):
        t = i // TQ
        lo, hi = max(t * TQ - W, 0), min(t * TQ + TQ + W, N)
        idx[:, i] = rng.integers(lo, hi, (B, S))
    valid = rng.random((B, NP, S)) < 0.9
    valid[:, N:] = False
    mask = rng.random((B, NP)) < 0.95
    mask[:, N:] = False
    # the weights' scales shrink with the fan-in past the base case's
    fc, fg = (16 / C) ** 0.5, (4 / G) ** 0.5
    p = dict(Wp1=((3, C), 0.3), bp1=((C,), 0.1), Wp2=((C, C), 0.2 * fc),
             bp2=((C,), 0.1), W1=((C, G), 0.3 * fc), b1=((G,), 0.1),
             W2=((G, G), 0.4 * fg), b2=((G,), 0.1))
    p = {k: (rng.normal(size=s) * m).astype(np.float32) for k, (s, m) in p.items()}
    p.update(gp=np.full(C, 1.1, np.float32), bp=np.full(C, 0.05, np.float32),
             gw=np.full(G, 0.9, np.float32), bw=np.full(G, -0.02, np.float32))
    c.update(idx=idx, valid=valid, mask=mask, p=p,
             cw=rng.normal(size=G).astype(np.float32),
             B=B, N=N, S=S, C=C, G=G, TQ=TQ, J=J, W=W, NP=NP)
    return c


@pytest.fixture(scope="module")
def case():
    return make_case()


# ---------------------------------------------------------------- JAX side


def _jax_rows(c, k, v, q):
    bf = jnp.bfloat16
    c6 = gf.pack_coords(jnp.asarray(c["coord"]))
    src = jnp.concatenate([k.astype(bf), v.astype(bf), c6], axis=-1)
    qrow = jnp.concatenate(
        [q.astype(bf), gf.pack_coords(jnp.asarray(c["qcoord"])),
         jnp.asarray(c["mask"])[..., None].astype(bf)], axis=-1)
    validb = jnp.asarray(c["valid"]).astype(bf)
    return src, qrow, validb


def jax_core(c, mode, k, v, q, pp):
    """(out, weight-BN stats, pe-BN stats) of gva_slab_core / gva_core in
    interpret mode, position moments computed in-kernel."""
    B, N, S, C, G, TQ, J, W, NP = (c[x] for x in "B N S C G TQ J W NP".split())
    src, qrow, validb = _jax_rows(c, k, v, q)
    wp = (pp["W1"], pp["b1"], pp["gw"], pp["bw"], pp["W2"], pp["b2"])
    pe = (pp["Wp1"], pp["bp1"], pp["gp"], pp["bp"], pp["Wp2"], pp["bp2"])
    if mode == "slab":
        kv_pad = gs.pad_for_slab(src, N, TQ, J)
        idxp = jnp.asarray(c["idx"] + W, jnp.int32)
        return gs.gva_slab_core(kv_pad, idxp, qrow, validb, *pe, wp, None,
                                NP, S, C, G, TQ, J, True)
    srcp = jnp.pad(src, ((0, 0), (0, NP - N), (0, 0)))
    kvp = jnp.take_along_axis(
        srcp, jnp.asarray(c["idx"].reshape(B, NP * S))[..., None], axis=1)
    return gf.gva_core(kvp, qrow, validb, *pe, wp, None, S, C, G, TQ, True)


def jax_pos_moments(c, mode):
    B, N, S, C, G, TQ, J, W, NP = (c[x] for x in "B N S C G TQ J W NP".split())
    src, qrow, validb = _jax_rows(c, *(jnp.asarray(c[x]) for x in "kvq"))
    if mode == "slab":
        return gs.compute_pos_moments_slab(
            gs.pad_for_slab(src, N, TQ, J), jnp.asarray(c["idx"] + W, jnp.int32),
            qrow, validb, S, C, G, TQ, J, True)
    srcp = jnp.pad(src, ((0, 0), (0, NP - N), (0, 0)))
    kvp = jnp.take_along_axis(
        srcp, jnp.asarray(c["idx"].reshape(B, NP * S))[..., None], axis=1)
    return gf.compute_pos_moments(kvp, qrow, validb, S, C, G, TQ, True)


# ---------------------------------------------------------------- port side


def port_rows(c, k, v, q, dtype=torch.bfloat16):
    c6 = tg.pack_coords(torch.from_numpy(c["coord"])).to(dtype)
    src = torch.cat([k.to(dtype), v.to(dtype), c6], -1)
    qrow = torch.cat([q.to(dtype),
                      tg.pack_coords(torch.from_numpy(c["qcoord"])).to(dtype),
                      torch.from_numpy(c["mask"])[..., None].to(dtype)], -1)
    return src, qrow, torch.from_numpy(c["idx"]), torch.from_numpy(c["valid"])


def port_train(c, k, v, q, p, dtype=torch.bfloat16):
    src, qrow, idx, valid = port_rows(c, k, v, q, dtype)
    return tg.gva_train(src, qrow, idx, valid, p)


def head_np(out, mu_w, var_w, cw, n=N):
    """sin of out (its first n queries) plus a linear function of the
    weight-BN statistics, so that the statistics' cotangent path is
    exercised."""
    return (jnp.sum(jnp.sin(out[:, :n])) + jnp.sum(mu_w * cw)
            + jnp.sum(var_w * cw * 0.5))


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(got - ref).max() / scale
    assert err < tol, (err, scale)
    return err


@pytest.mark.parametrize("mode,shape", MODES)
def test_pos_moments_plain_matches_pallas(mode, shape):
    """K4: the plain moments against the Pallas pos kernel's (the same f32
    positions summed in another order: 1e-5 relative, measured 2.1e-7;
    the count exact)."""
    case = make_case(shape)
    jm = jax_pos_moments(case, mode)
    src, qrow, idx, valid = port_rows(
        case, *(torch.from_numpy(case[x]) for x in "kvq"))
    tm = tg.gva_pos(src, qrow, idx, valid)
    assert tg.gva_pos.launches == 0  # CPU tensors: the plain version
    _close(tm[0], jm[0], 1e-5)
    _close(tm[1], jm[1], 1e-5)
    assert float(tm[2]) == float(jm[2]) == float(case["valid"].sum())


@pytest.mark.parametrize("edges", ["empty_query", "mostly_invalid"])
@pytest.mark.parametrize("mode", ["slab", "gathered"])
def test_pos_moments_plain_matches_pallas_sparse_edges(case, mode, edges):
    """K4 where edges are scarce, as the card kernel's grouping of four
    slots a thread meets them: a valid query row whose every slot is
    invalid (``empty_query``, row 5, beside the case's 10% invalid slots),
    or a stage whose edges are 95% invalid (``mostly_invalid``). The same
    band as above; the count exact."""
    c = dict(case)
    valid = case["valid"].copy()
    if edges == "empty_query":
        valid[:, 5] = False
        assert case["mask"][:, 5].any()
    else:
        valid &= np.random.default_rng(11).random(valid.shape) < 0.05
    c["valid"] = valid
    jm = jax_pos_moments(c, mode)
    src, qrow, idx, valid_t = port_rows(
        c, *(torch.from_numpy(c[x]) for x in "kvq"))
    tm = tg.gva_pos(src, qrow, idx, valid_t)
    assert tg.gva_pos.launches == 0
    _close(tm[0], jm[0], 1e-5)
    _close(tm[1], jm[1], 1e-5)
    assert float(tm[2]) == float(jm[2]) == float(valid.sum())


@pytest.mark.parametrize("mode,shape", MODES)
def test_forward_and_stats_match_pallas(mode, shape):
    """K5 and K3 with batch-statistic folds inside GVATrain: the output
    rows, the weight-BN (mean, var, count) and the pe-BN (mean, var,
    count) against gva_slab_core / gva_core (measured: out 1.4e-7 x scale,
    statistics up to 2.4e-7 relative, counts exact)."""
    case = make_case(shape)
    N = case["N"]
    kvq = [jnp.asarray(case[x]) for x in "kvq"]
    pp = {n: jnp.asarray(a) for n, a in case["p"].items()}
    jo, jsw, jsp = jax_core(case, mode, *kvq, pp)
    p = {n: torch.from_numpy(a) for n, a in case["p"].items()}
    with torch.no_grad():
        to, tsw, tsp, _ = port_train(
            case, *(torch.from_numpy(case[x]) for x in "kvq"), p)
    assert tg.gva_stats.launches == 0 and tg.gva_eval.launches == 0
    jo = np.asarray(jo)
    # bf16 rounding of the same operands in another order: 5e-3 x scale
    assert np.abs(to.numpy()[:, :N] - jo[:, :N]).max() < 5e-3 * max(
        np.abs(jo).max(), 1.0)
    assert np.abs(to.numpy()[:, N:]).max() == 0.0
    for a, b in list(zip(tsw[:2], jsw[:2])) + list(zip(tsp[:2], jsp[:2])):
        _close(a, b, 1e-4)
    assert float(tsw[2]) == float(jsw[2])
    assert float(tsp[2]) == float(jsp[2])


@pytest.mark.parametrize("mode,shape", MODES)
def test_gradients_match_jax_grad(mode, shape):
    """GVATrain's backward (K6 plain + the host algebra) against jax.grad
    of the TPU kernels' custom VJP, w.r.t. the row inputs and all twelve
    parameters. The JAX package's own slab-vs-gathered bands are 0.08
    relative for rows and 0.03 for parameters; the slab kernel rounds its
    per-edge row gradients to bf16, so rows get 0.02 here and parameters
    0.01 (measured: rows up to 7.6e-3, parameters up to 2.1e-3, both in
    gathered mode; slab parameters below 1e-5)."""
    case = make_case(shape)
    N = case["N"]
    cw = jnp.asarray(case["cw"])

    def loss(k, v, q, *plist):
        pp = dict(zip(PNAMES, plist))
        out, (mu, var, _), _ = jax_core(case, mode, k, v, q, pp)
        return head_np(out, mu, var, cw, N)

    args = [jnp.asarray(case[x]) for x in "kvq"] + [
        jnp.asarray(case["p"][n]) for n in PNAMES]
    jg = jax.grad(loss, argnums=tuple(range(len(args))))(*args)

    ins = [torch.from_numpy(case[x]).requires_grad_(True) for x in "kvq"]
    p = {n: torch.from_numpy(case["p"][n]).requires_grad_(True) for n in PNAMES}
    out, (mu, var, _), _, _ = port_train(case, *ins, p)
    tcw = torch.from_numpy(case["cw"])
    L = (torch.sin(out[:, :N]).sum() + (mu * tcw).sum()
         + (var * tcw * 0.5).sum())
    tgr = torch.autograd.grad(L, ins + [p[n] for n in PNAMES])
    assert tg.gva_bwd.launches == 0
    for name, a, b in zip(["k", "v", "q"] + list(PNAMES), tgr, jg):
        b = np.asarray(b, np.float32)
        if name in ("bp1", "b2"):
            # zero up to rounding: a BN removes bp1, the softmax's shift
            # invariance b2
            assert np.abs(a.numpy()).max() < 1e-3 * max(np.abs(b).max(), 1.0)
            continue
        _close(a.numpy(), b, 0.02 if name in "kvq" else 0.01)


def _composed(src, qrow, idx, valid, p, pm):
    """The train forward as a plain autograd composition: K5's statistics,
    the folds and K3, all differentiable."""
    A, cA, _, _, _, _ = tg.fold_pe(p["Wp1"], p["bp1"], p["gp"], p["bp"], pm)
    env = tg._recompute(src, qrow, idx, valid, A, cA, p["Wp2"], p["bp2"],
                        p["W1"], p["b1"])
    vf = env["vf"]
    n = vf.sum().clamp_min(1.0)
    mu = (env["t"] * vf).sum((0, 1, 2)) / n
    var = ((env["t"] ** 2 * vf).sum((0, 1, 2)) / n - mu ** 2).clamp_min(0.0)
    W1f, b1f, _, _ = tg.fold_w(p["W1"], p["b1"], p["gw"], p["bw"], mu, var)
    fp = dict(A=A, cA=cA, Wp2=p["Wp2"], bp2=p["bp2"], W1f=W1f, b1f=b1f,
              W2=p["W2"], b2=p["b2"])
    return tg.gva_eval_plain(src, qrow, idx, valid, fp), mu, var


def test_backward_algebra_exact_in_float64(case):
    """The hand-written backward (K6's sums and moments, then the host
    algebra that applies the BatchNorm statistics' gradients) against
    autograd of the plain forward composition, both in float64 where the
    plain versions skip the bf16 rounding: agreement to 1e-10 relative
    (measured about 1e-15)."""
    f64 = torch.float64
    ins = [torch.from_numpy(case[x]).to(f64).requires_grad_(True) for x in "kvq"]
    p = {n: torch.from_numpy(case["p"][n]).to(f64).requires_grad_(True)
         for n in PNAMES}
    cw = torch.from_numpy(case["cw"]).to(f64)

    def head(out, mu, var):
        return torch.sin(out).sum() + (mu * cw).sum() + (var * cw * 0.5).sum()

    out, (mu, var, _), _, pm = port_train(case, *ins, p, dtype=f64)
    g1 = torch.autograd.grad(head(out, mu, var), ins + list(p.values()))
    src, qrow, idx, valid = port_rows(case, *ins, dtype=f64)
    out2, mu2, var2 = _composed(src, qrow, idx, valid, p, pm)
    assert torch.allclose(out, out2, rtol=0, atol=1e-12)
    g2 = torch.autograd.grad(head(out2, mu2, var2), ins + list(p.values()))
    for name, a, b in zip(["k", "v", "q"] + list(p), g1, g2):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) < 1e-10 * scale, name


def test_fully_masked_query_tile_adds_nothing(case):
    """Queries past N and a tile whose slots are all invalid add nothing:
    zero output rows, zero dq there, and the same gradients elsewhere as
    without those queries' slots (cf. tests/test_gva_fused.py
    test_fully_padded_tile_finite)."""
    c = dict(case)
    valid = case["valid"].copy()
    valid[:, :TQ] = False  # the first query tile: every slot invalid
    c["valid"] = valid
    q = torch.from_numpy(case["q"]).requires_grad_(True)
    k, v = (torch.from_numpy(case[x]).requires_grad_(True) for x in "kv")
    p = {n: torch.from_numpy(a) for n, a in case["p"].items()}
    out, (mu, var, n), _, pm = port_train(c, k, v, q, p)
    assert torch.isfinite(out).all()
    assert float(out[:, :TQ].abs().max()) == 0.0
    assert float(out[:, N:].abs().max()) == 0.0
    assert float(n) == float(valid.sum()) == float(pm[2])
    gq, gk = torch.autograd.grad((out ** 2).sum() + mu.sum() + var.sum(), (q, k))
    assert torch.isfinite(gq).all() and torch.isfinite(gk).all()
    assert float(gq[:, :TQ].abs().max()) == 0.0
    assert float(gq[:, N:].abs().max()) == 0.0


def _bwd_weight_sums(src, qrow, idx, valid, fp, dout, round_operands):
    """The three weight sums of gva_bwd_plain that K6 takes on tensor cores
    or may round (dWp2 = pe1^T dpeb, dW1f = r^T dt, dW2 = relu(t)^T dw),
    from the plain version's own intermediates; with ``round_operands`` each
    operand is rounded to bf16 first and the sum accumulated in f32."""
    B, Nq, S = idx.shape
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    env = tg._recompute(src, qrow, idx, valid, fp["A"], fp["cA"], fp["Wp2"],
                        fp["bp2"], fp["W1f"], fp["b1f"])
    vf, t = env["vf"], env["t"]
    sm = tg._softmax_slots(t, fp["W2"], fp["b2"], valid)
    d = (dout * env["mrow"][..., None])[:, :, None]
    dsm = (env["v2"] * d).reshape(B, Nq, S, G, C // G).sum(-1)
    dw = sm * (dsm - (sm * dsm).sum(2, keepdim=True))
    dt = torch.where(t > 0, dw @ fp["W2"].T, 0.0) * vf
    dr = tg._bf(dt) @ tg._bf(fp["W1f"]).T
    dpeb = dr + sm.repeat_interleave(C // G, dim=-1) * d
    op = tg._bf if round_operands else (lambda x: x)

    def ssum(a, b):
        return torch.einsum("bnsi,bnsj->ij", op(a), op(b))

    return dict(dWp2=ssum(env["pe1"], dpeb), dW1f=ssum(env["r"], dt),
                dW2=ssum(torch.relu(t), dw))


@pytest.mark.parametrize("C,G", [(16, 2), (32, 4), (24, 6)])
def test_bf16_operand_weight_sums_within_k6_band(C, G):
    """K6 sums pe1^T dpeb and r^T dt on tensor cores with bf16 operands and
    f32 accumulation, as the TPU kernel's _mtm products do, where the plain
    version sums the f32 values. The same sums with rounded operands (and
    relu(t)^T dw, which K6 keeps in f32) stay inside the band chip_smoke.py
    holds K6 to against the plain version, 1e-2 of each sum's scale
    (measured here: dWp2 up to 1.1e-3, dW1f up to 3.8e-3, dW2 up to 4.4e-3,
    the last two at C=24, G=6). The unrounded sums of the helper are the
    plain version's own to 1e-6."""
    rng = np.random.default_rng(11 + C)
    Bq, Nq, S = 2, 64, 16
    f = lambda *s, m=1.0: torch.from_numpy((rng.normal(size=s) * m).astype(np.float32))
    coord = torch.from_numpy(rng.uniform(0, 2, (Bq, Nq, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((Bq, Nq)) < 0.95)
    src = torch.cat([f(Bq, Nq, C, m=0.5).bfloat16(), f(Bq, Nq, C, m=0.5).bfloat16(),
                     tg.pack_coords(coord)], -1)
    qrow = torch.cat([f(Bq, Nq, C, m=0.5).bfloat16(), tg.pack_coords(coord),
                      mask[..., None].bfloat16()], -1)
    idx = torch.from_numpy(rng.integers(0, Nq, (Bq, Nq, S)).astype(np.int32))
    valid = torch.from_numpy(rng.random((Bq, Nq, S)) < 0.9) & mask[..., None]
    fp = dict(A=f(3, C, m=0.5), cA=f(C, m=0.1), Wp2=f(C, C, m=C ** -0.5),
              bp2=f(C, m=0.1), W1f=f(C, G, m=C ** -0.5), b1f=f(G, m=0.1),
              W2=f(G, G, m=G ** -0.5), b2=f(G, m=0.1))
    dout = f(Bq, Nq, C)
    par = tg._split_par(tg.gva_bwd_plain(src, qrow, idx, valid, fp, dout)[2], C, G)
    exact = _bwd_weight_sums(src, qrow, idx, valid, fp, dout, False)
    rounded = _bwd_weight_sums(src, qrow, idx, valid, fp, dout, True)
    for name in ("dWp2", "dW1f", "dW2"):
        scale = float(par[name].abs().max())
        assert float((exact[name] - par[name]).abs().max()) <= 1e-6 * scale, name
        gap = float((rounded[name] - par[name]).abs().max()) / scale
        assert gap <= 1e-2, (name, gap)
