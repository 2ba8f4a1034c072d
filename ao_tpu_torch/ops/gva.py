"""Grouped vector attention of PT-v2m2 (port of ao_tpu/ops/pallas/
gva_fused.py and gva_slab.py): eval and train mode.

Kernels (CUDA sources under ``csrc/``), each replacing the TPU package's
slab-mode AND gathered-mode kernel of the same function:

* K3 ``gva_eval`` (``gva_eval.cu``): the attention forward with folded
  BatchNorms, running statistics in eval mode and batch statistics in
  train mode (the TPU kernels' ``_fwd_kernel``);
* K4 ``gva_pos`` (``gva_pos.cu``): the relative-position moments that fold
  the pe-MLP's BatchNorm (``_pos_kernel``);
* K5 ``gva_stats`` (``gva_stats.cu``): the weight-encoding BatchNorm's batch
  statistics (``_stats_kernel``);
* K6 ``gva_bwd`` (``gva_bwd.cu``): the recomputed forward and the whole
  backward, with the moments the BN-statistics' gradient is linear in
  (``_bwd_kernel``, and ``_bwd_stats_kernel`` of the gathered family).

K3, K5 and K6 share the tensor-core tile routine of ``gva_tile.cuh`` and
are built for the (C, G) instances of the S3DIS config (C = 48, 96, 192,
384, G = C / 8, S = 16); their wrappers raise on any other width.

The kernels gather neighbour rows themselves, so one kernel serves both
call modes: the caller passes sorted or unsorted source rows with the
matching neighbour ids.

Row layouts (bf16), as in the TPU package:
  src rows (B, Nsrc, 2C+6): [k | v | coord hi3 | coord lo3]
  q rows   (B, Nq, C+7):    [q | coord hi3 | coord lo3 | row mask]
  idx (B, Nq, S) int ids into src, valid (B, Nq, S) bool
Coordinates ride as two bf16 halves (``pack_coords``); kernels rebuild
relative positions in f32 from them.

:class:`GVATrain` is the train-mode function (K5, K3, then K6 and the host
algebra of the TPU package's custom VJP in its backward). Every wrapper
runs its kernel's plain PyTorch version on CPU tensors and launches the
kernel, or raises, on CUDA tensors.

``gva_reference`` is the unfused composition the model runs where the TPU
package runs its unfused path (off the card, or without bf16 compute): it
reproduces the reference's pad semantics (softmax over pad slots, zeroed
after) that the kernels do not model; autograd differentiates it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from . import _native
from .grouping import grouping

_EPS = 1e-5  # PointBatchNorm eps


def pack_coords(coord: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 -> (..., 6) bf16 [hi | lo] with hi + lo ~= coord."""
    hi = coord.to(torch.bfloat16)
    lo = (coord - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=-1)


def fold_pe_running(Wp1, bp1, gp, bp, mu_p, var_p):
    """Fold the pe-MLP's BatchNorm (running statistics) into the first
    layer: relu(pos @ A + cA) == relu(BN(pos @ Wp1 + bp1))."""
    inv_p = torch.rsqrt(var_p + _EPS)
    A = Wp1 * (gp * inv_p)[None, :]
    cA = (bp1 - mu_p) * gp * inv_p + bp
    return A, cA


def fold_pe(Wp1, bp1, gp, bp, pos_moments):
    """Fold the pe-MLP's BatchNorm with BATCH statistics (port of
    gva_fused.py:_fold_pe). The BN input pos @ Wp1 + bp1 is linear in the
    relative positions, so its batch mean and variance follow from their
    moments (sum pos, sum pos pos^T, count). Returns (A, cA, mu_p, var_p,
    pmean, pcov)."""
    psum, ppsum, pn = pos_moments
    n = torch.clamp_min(pn, 1.0)
    pmean = psum / n
    pcov = ppsum / n - pmean[:, None] * pmean[None, :]
    mu_p = pmean @ Wp1 + bp1
    var_p = torch.clamp_min(torch.einsum("ic,ij,jc->c", Wp1, pcov, Wp1), 0.0)
    inv_p = torch.rsqrt(var_p + _EPS)
    A = Wp1 * (gp * inv_p)[None, :]
    cA = (bp1 - mu_p) * gp * inv_p + bp
    return A, cA, mu_p, var_p, pmean, pcov


def fold_w(W1, b1, gw, bw, mu_w, var_w):
    """Fold the weight-encoding BatchNorm into its first layer. Returns
    (W1f, b1f, sw, inv_w)."""
    inv_w = torch.rsqrt(var_w + _EPS)
    sw = gw * inv_w
    cw = bw - mu_w * sw
    return W1 * sw[None, :], b1 * sw + cw, sw, inv_w


def folded_params(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw GVA parameters + running statistics -> the kernel's folded set
    (A, cA, Wp2, bp2, W1f, b1f, W2, b2), all f32."""
    A, cA = fold_pe_running(p["Wp1"], p["bp1"], p["gp"], p["bp"],
                            p["pe_mean"], p["pe_var"])
    W1f, b1f, _, _ = fold_w(p["W1"], p["b1"], p["gw"], p["bw"],
                            p["we_mean"], p["we_var"])
    return dict(A=A, cA=cA, Wp2=p["Wp2"], bp2=p["bp2"], W1f=W1f, b1f=b1f,
                W2=p["W2"], b2=p["b2"])


def _wd(x):
    """Working dtype of the plain versions: f32, or f64 for f64 inputs."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bf(x):
    """The kernels' bf16 operand rounding (the TPU kernels' _mm_bf16 /
    _mtm_mom operands), computed on in f32. Float64 inputs pass unrounded:
    the plain versions then evaluate the exact algebra (the tests' check of
    the hand-written backward)."""
    if x.dtype == torch.float64:
        return x
    return x.to(torch.bfloat16).float()


def _recompute(src, qrow, idx, valid, A, cA, Wp2, bp2, W1x, b1x):
    """The slot-level recompute shared by K3, K5 and K6 (port of
    gva_fused.py:_recompute) on gathered (B, Nq, S, .) tensors, up to
    t = (relation @ W1x + b1x) * valid. W1x / b1x are the folded (K3, K6)
    or raw (K5) first weight-encoding layer."""
    C = qrow.shape[-1] - 7
    wd = _wd(src)
    rows = grouping(src, idx.clamp(0, src.shape[1] - 1)).to(wd)
    qf = qrow.to(wd)
    vf = valid.to(wd)[..., None]
    pk = rows[..., 2 * C:2 * C + 3] + rows[..., 2 * C + 3:2 * C + 6]
    pq = qf[..., C:C + 3] + qf[..., C + 3:C + 6]
    pos = (pk - pq[:, :, None]) * vf
    pe0 = (_bf(pos) @ _bf(A) + cA) * vf
    pe1 = torch.relu(pe0)
    peb = _bf(pe1) @ _bf(Wp2) + bp2
    r = rows[..., :C] - qf[:, :, None, :C] + peb
    t = (_bf(r) @ _bf(W1x) + b1x) * vf
    return dict(pos=pos, vf=vf, mrow=qf[..., C + 6], pe0=pe0, pe1=pe1,
                peb=peb, r=r, v2=rows[..., C:2 * C] + peb, t=t)


def _softmax_slots(t, W2, b2, valid):
    """w = relu(t) @ W2 + b2, softmax over the valid slots of each (query,
    group), masked before the exp (the kernels' _softmax)."""
    w = torch.relu(t) @ W2 + b2
    wm = torch.where(valid[..., None], w, -1e30)
    mx = wm.amax(dim=2, keepdim=True)
    z = torch.exp(torch.clamp_min(wm - mx, -80.0)) * valid[..., None].to(w.dtype)
    return z / torch.clamp_min(z.sum(2, keepdim=True), 1e-30)


def gva_eval_plain(src, qrow, idx, valid, fp):
    """Plain PyTorch K3: the same function as the kernel (see
    csrc/gva_eval.cu), computed on the gathered (B, Nq, S, .) tensors."""
    B, Nq, S = idx.shape
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    env = _recompute(src, qrow, idx, valid, fp["A"], fp["cA"], fp["Wp2"],
                     fp["bp2"], fp["W1f"], fp["b1f"])
    sm = _softmax_slots(env["t"], fp["W2"], fp["b2"], valid)
    out = (env["v2"].reshape(B, Nq, S, G, C // G) * sm[..., None]).sum(2)
    return out.reshape(B, Nq, C) * env["mrow"][..., None]


def gva_eval(src, qrow, idx, valid, fp):
    """K3 (replaces gva_slab.py:gva_slab_core_eval / gva_slab_core and
    gva_fused.py:gva_core_eval / gva_core).

    src (B, Nsrc, 2C+6) bf16 rows, qrow (B, Nq, C+7) bf16, idx (B, Nq, S)
    ids into src, valid (B, Nq, S) bool, fp the folded parameters of
    :func:`folded_params` (or the batch-statistic folds of
    :class:`GVATrain`). Returns out (B, Nq, C) f32. The kernel is built for
    the widths of :data:`GVA_WIDTHS` with G = C / 8 and S = 16; any other
    shape raises."""
    if src.device.type == "cpu":
        return gva_eval_plain(src, qrow, idx, valid, fp)
    args = _check_rows("gva_eval", src, qrow, idx, valid)
    B, Nsrc, _ = src.shape
    Nq, S = idx.shape[1:]
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    _check_width("gva_eval", C, G)
    bf = torch.bfloat16
    args += [fp["A"].to(bf).contiguous(), fp["cA"].float().contiguous(),
             fp["Wp2"].to(bf).contiguous(), fp["bp2"].float().contiguous(),
             fp["W1f"].to(bf).contiguous(), fp["b1f"].float().contiguous(),
             fp["W2"].float().contiguous(), fp["b2"].float().contiguous()]
    _native.require_cuda("gva_eval", *args)
    out = torch.empty((B, Nq, C), dtype=torch.float32, device=src.device)
    # a persistent grid: as many blocks as the SMs hold at once
    nblk = _grid("gva_eval", src.device, C, B * -(-Nq // _tile_queries(C)))
    err = _native.lib().gva_eval_launch(
        *[a.data_ptr() for a in args], out.data_ptr(), B, Nsrc, Nq, S, C, G,
        nblk, _native.stream_ptr(out),
    )
    _native.check(err, "gva_eval")
    gva_eval.launches += 1
    return out


gva_eval.launches = 0


# ---------------------------------------------------------------------------
# train mode: K4 gva_pos, K5 gva_stats, K6 gva_bwd and the GVATrain function
# ---------------------------------------------------------------------------


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the widths K3, K5 and K6 are built for (every stage of the S3DIS config)
GVA_WIDTHS = (48, 96, 192, 384)


def _check_width(name, C, G):
    if C not in GVA_WIDTHS or G * 8 != C:
        raise ValueError(f"{name}: C={C}, G={G} outside the kernel's instances "
                         f"(C in {GVA_WIDTHS}, G = C / 8)")


def _check_rows(name, src, qrow, idx, valid):
    B, Nsrc, rw = src.shape
    C = qrow.shape[-1] - 7
    if (rw != 2 * C + 6 or idx.shape[-1] != 16 or C % 8
            or src.dtype != torch.bfloat16 or qrow.dtype != torch.bfloat16
            or qrow.shape[:2] != idx.shape[:2] or valid.shape != idx.shape):
        raise ValueError(
            f"{name}: rows {tuple(src.shape)} {src.dtype}, qrow "
            f"{tuple(qrow.shape)}, idx {tuple(idx.shape)} outside the "
            f"kernel's contract")
    return [src.contiguous(), qrow.contiguous(),
            idx.to(torch.int32).contiguous(),
            (valid.view(torch.uint8) if valid.dtype == torch.bool
             else valid.to(torch.uint8)).contiguous()]


def gva_pos_plain(src, qrow, idx, valid):
    """Plain PyTorch K4: (sum pos (3,), sum pos pos^T (3, 3), count) over the
    valid edges, pos = key coordinate - query coordinate (hi + lo halves)."""
    C = qrow.shape[-1] - 7
    wd = _wd(src)
    rows = grouping(src[..., 2 * C:], idx.clamp(0, src.shape[1] - 1)).to(wd)
    qf = qrow.to(wd)
    vf = valid.to(wd)[..., None]
    pq = qf[..., C:C + 3] + qf[..., C + 3:C + 6]
    pos = ((rows[..., :3] + rows[..., 3:6]) - pq[:, :, None]) * vf
    return (pos.sum((0, 1, 2)), torch.einsum("bnsi,bnsj->ij", pos, pos),
            vf.sum())


def gva_pos(src, qrow, idx, valid):
    """K4 (replaces gva_slab.py:compute_pos_moments_slab and
    gva_fused.py:compute_pos_moments): the relative-position moments of a
    stage's graph, which fold the pe-MLP's BatchNorm (:func:`fold_pe`).
    Same row contract as :func:`gva_eval`. Returns (psum (3,), ppsum (3, 3),
    count ()) f32."""
    if src.device.type == "cpu":
        return gva_pos_plain(src, qrow, idx, valid)
    args = _check_rows("gva_pos", src, qrow, idx, valid)
    _native.require_cuda("gva_pos", *args)
    B, Nsrc, _ = src.shape
    Nq, S = idx.shape[1:]
    C = qrow.shape[-1] - 7
    # the kernel reads 4 ids as one int4 and 4 validity bytes as one word
    if args[2].data_ptr() % 16:
        args[2] = args[2].clone()
    if args[3].data_ptr() % 4:
        args[3] = args[3].clone()
    dev = src.device
    nblk = _grid("gva_pos", dev, C, -(-B * Nq * S // 1024))
    # [13 totals | the kernel's block counter | 2 unused | nblk partial rows]
    buf = torch.empty(16 + 13 * nblk, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    err = _native.lib().gva_pos_launch(
        *[a.data_ptr() for a in args], ptr, ptr + 16 * 4, ptr + 13 * 4, B,
        Nsrc, Nq, S, C, nblk, _native.stream_ptr(buf))
    _native.check(err, "gva_pos")
    gva_pos.launches += 1
    return buf[:3], buf[3:12].view(3, 3), buf[12]


gva_pos.launches = 0


def gva_stats_plain(src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1):
    """Plain PyTorch K5: over the valid edges, sum t, sum t^2 and the count
    of t = (relation @ W1 + b1) with the UNFOLDED W1 (the weight-encoding
    BN's input), the relation built with the batch-stat pe folds (A, cA);
    plus the position sums of K4."""
    env = _recompute(src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1)
    t, vf, pos = env["t"], env["vf"], env["pos"]
    return ((t * vf).sum((0, 1, 2)), (t * t * vf).sum((0, 1, 2)), vf.sum(),
            pos.sum((0, 1, 2)), torch.einsum("bnsi,bnsj->ij", pos, pos))


def gva_stats(src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1):
    """K5 (replaces the _stats_kernel passes of gva_slab.py:_fwd_inner and
    gva_fused.py:_fwd_inner). Returns (sum t (G,), sum t^2 (G,), count (),
    sum pos (3,), sum pos pos^T (3, 3)) f32."""
    if src.device.type == "cpu":
        return gva_stats_plain(src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1)
    args = _check_rows("gva_stats", src, qrow, idx, valid)
    G = W1.shape[1]
    C = qrow.shape[-1] - 7
    _check_width("gva_stats", C, G)
    bf = torch.bfloat16
    args += [A.to(bf).contiguous(), cA.float().contiguous(),
             Wp2.to(bf).contiguous(), bp2.float().contiguous(),
             W1.to(bf).contiguous(), b1.float().contiguous()]
    _native.require_cuda("gva_stats", *args)
    B, Nsrc, _ = src.shape
    Nq, S = idx.shape[1:]
    # one row of 2G + 13 partial sums per block: as many blocks as the
    # SMs hold at once
    nblk = _grid("gva_stats", src.device, C, B * -(-Nq // _tile_queries(C)))
    part = torch.empty((nblk, 2 * G + 13), dtype=torch.float32,
                       device=src.device)
    err = _native.lib().gva_stats_launch(
        *[a.data_ptr() for a in args], part.data_ptr(), B, Nsrc, Nq, S, C, G,
        nblk, _native.stream_ptr(part))
    _native.check(err, "gva_stats")
    gva_stats.launches += 1
    tot = part.sum(0, dtype=torch.float64).float()
    return (tot[:G], tot[G:2 * G], tot[2 * G], tot[2 * G + 1:2 * G + 4],
            tot[2 * G + 4:2 * G + 13].reshape(3, 3))


gva_stats.launches = 0


def _tile_queries(C):
    """Queries per tile of K3, K5 and K6 (csrc/gva_tile.cuh: Tile<C>::TQ)."""
    return 8 if C <= 96 else 4


_OCCUPANCY = {}
_WORKSPACE = {}
# partial rows K6's blocks add their parameter sums into (block k into row
# k % rows): few enough that the rows stay in L2
_BWD_PART_ROWS = 16


def _workspace(device, numel):
    """A bf16 buffer of at least ``numel`` elements for work on the current
    stream of ``device``, kept and grown across calls: K6's scratch rows take
    0.4-0.6 GB per call at the train step's C >= 192 stages, and a fresh
    allocation of that size each call fragments the caching allocator's pool
    until it has to free and synchronise. One buffer per (device, stream):
    the calls on one stream run in order, so they may share it; a call on
    another stream gets its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < numel:
        _WORKSPACE.pop(key, None)
        buf = _WORKSPACE[key] = torch.empty(max(numel, 1), dtype=torch.bfloat16,
                                            device=device)
    return buf


def _grid(name, device, C, tiles):
    """Blocks of the persistent K3 / K5 / K6 grid: as many as the SMs hold
    at once (the kernel's own occupancy query), at most one per tile."""
    key = (name, C, device)
    if key not in _OCCUPANCY:
        n = ctypes.c_int(0)
        _native.check(getattr(_native.lib(), f"{name}_blocks_per_sm")(
            C, ctypes.byref(n)), name)
        _OCCUPANCY[key] = max(n.value, 1) * _sm_count(device)
    return max(1, min(tiles, _OCCUPANCY[key]))


def bwd_par_layout(C, G):
    """(name, shape) of K6's parameter sums, in the order of its flat
    output: the eight sums of the TPU kernel's dpar rows
    (gva_slab.py:_bwd_kernel :382-395) and the (1 + G, 6C) stat-correction
    moment dmom_par (:356-380; row 0 valid-weighted, rows 1..G t-weighted,
    columns [r | pe1 | relu gate | x*gate | y*gate | z*gate])."""
    return (("dW1f", (C, G)), ("db1f", (G,)), ("dW2", (G, G)), ("db2", (G,)),
            ("dWp2", (C, C)), ("dbp2", (C,)), ("dA", (3, C)), ("dcA", (C,)),
            ("mom_par", (1 + G, 6 * C)))


def _split_par(flat, C, G):
    out, o = {}, 0
    for name, shape in bwd_par_layout(C, G):
        out[name] = flat[o:o + math.prod(shape)].reshape(shape)
        o += math.prod(shape)
    return out


def gva_bwd_plain(src, qrow, idx, valid, fp, dout):
    """Plain PyTorch K6: recompute the forward with the folded parameters
    ``fp``, then backpropagate ``dout`` (B, Nq, C). Returns

    * dkv (B, Nsrc, 2C) f32: [dk | dv] summed per source row over the edges
      that read it;
    * dq (B, Nq, C): -sum over a query's slots of d(relation);
    * par: the flat parameter sums of :func:`bwd_par_layout`;
    * mom (B, Nsrc, 1 + G): [valid | t] summed per source row;
    * qmom (B, Nq, 1 + G): [valid | t] summed over a query's slots.

    mom, qmom and par's mom_par are the moments the weight-BN statistics'
    gradient is linear in; :func:`_bwd_host` applies it from them."""
    B, Nq, S = idx.shape
    Nsrc = src.shape[1]
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    env = _recompute(src, qrow, idx, valid, fp["A"], fp["cA"], fp["Wp2"],
                     fp["bp2"], fp["W1f"], fp["b1f"])
    vf, t, pe0 = env["vf"], env["t"], env["pe0"]
    sm = _softmax_slots(t, fp["W2"], fp["b2"], valid)
    dout_r = (dout.to(vf.dtype) * env["mrow"][..., None])[:, :, None]
    sme = sm.repeat_interleave(C // G, dim=-1)
    dv2 = sme * dout_r
    dsm = (env["v2"] * dout_r).reshape(B, Nq, S, G, C // G).sum(-1)
    dw = sm * (dsm - (sm * dsm).sum(2, keepdim=True))
    dt = torch.where(t > 0, dw @ fp["W2"].T, 0.0) * vf
    dr = _bf(dt) @ _bf(fp["W1f"]).T
    dpeb = dr + dv2
    dpe0 = torch.where(pe0 > 0, _bf(dpeb) @ _bf(fp["Wp2"]).T, 0.0) * vf
    ug = (pe0 > 0).to(vf.dtype) * vf
    pos = env["pos"]
    tv = torch.cat([vf, t], dim=-1)
    posu = torch.cat([pos[..., i:i + 1] * ug for i in range(3)], dim=-1)
    feats = torch.cat([env["r"], env["pe1"], ug, posu], dim=-1)

    def ssum(a, b):  # sum over every slot of a^T b
        return torch.einsum("bnsi,bnsj->ij", a, b)

    par = dict(dW1f=ssum(env["r"], dt), db1f=dt.sum((0, 1, 2)),
               dW2=ssum(torch.relu(t), dw), db2=dw.sum((0, 1, 2)),
               dWp2=ssum(env["pe1"], dpeb), dbp2=dpeb.sum((0, 1, 2)),
               dA=ssum(pos, dpe0), dcA=dpe0.sum((0, 1, 2)),
               mom_par=ssum(_bf(tv), _bf(feats)))
    flat = torch.cat([par[n].reshape(-1) for n, _ in bwd_par_layout(C, G)])
    ids = (idx.clamp(0, Nsrc - 1).long()
           + torch.arange(B, device=idx.device)[:, None, None] * Nsrc)
    dkv = torch.zeros((B * Nsrc, 2 * C), dtype=vf.dtype, device=src.device)
    dkv.index_add_(0, ids.reshape(-1),
                   torch.cat([dr, dv2], dim=-1).reshape(-1, 2 * C))
    mom = torch.zeros((B * Nsrc, 1 + G), dtype=vf.dtype, device=src.device)
    mom.index_add_(0, ids.reshape(-1), tv.reshape(-1, 1 + G))
    return (dkv.reshape(B, Nsrc, 2 * C), -dr.sum(2), flat,
            mom.reshape(B, Nsrc, 1 + G), tv.sum(2))


def gva_bwd(src, qrow, idx, valid, fp, dout):
    """K6 (replaces gva_slab.py:_bwd_vjp -> _bwd_kernel and
    gva_fused.py:_bwd_vjp -> _bwd_kernel + _bwd_stats_kernel): the
    backward of one GVA call; see :func:`gva_bwd_plain` for the outputs."""
    if src.device.type == "cpu":
        return gva_bwd_plain(src, qrow, idx, valid, fp, dout)
    args = _check_rows("gva_bwd", src, qrow, idx, valid)
    B, Nsrc, _ = src.shape
    Nq, S = idx.shape[1:]
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    _check_width("gva_bwd", C, G)
    bf = torch.bfloat16
    Wp2 = fp["Wp2"].to(bf).contiguous()
    # the kernel stages Wp2 in shared memory and reads it both ways; at
    # C = 384 it streams the weight from device memory, Wp2^T for dpe0
    Wp2T = Wp2.t().contiguous() if C > 192 else Wp2
    args += [fp["A"].to(bf).contiguous(), fp["cA"].float().contiguous(),
             Wp2, Wp2T, fp["bp2"].float().contiguous(),
             fp["W1f"].to(bf).contiguous(), fp["b1f"].float().contiguous(),
             fp["W2"].float().contiguous(), fp["b2"].float().contiguous(),
             dout.float().contiguous()]
    _native.require_cuda("gva_bwd", *args)
    P = sum(math.prod(s) for _, s in bwd_par_layout(C, G))
    nblk = _grid("gva_bwd", src.device, C, B * -(-Nq // _tile_queries(C)))
    # partial rows: blocks k, k + nrow, ... add into row k
    nrow = min(nblk, _BWD_PART_ROWS)
    dev = src.device
    dkv = torch.zeros((B, Nsrc, 2 * C), dtype=torch.float32, device=dev)
    dq = torch.empty((B, Nq, C), dtype=torch.float32, device=dev)
    mom = torch.zeros((B, Nsrc, 1 + G), dtype=torch.float32, device=dev)
    qmom = torch.empty((B, Nq, 1 + G), dtype=torch.float32, device=dev)
    part = torch.zeros((nrow, P), dtype=torch.float32, device=dev)
    # C >= 192: per-edge bf16 rows for the split-K pass that sums dWp2 and
    # the moment, spread over about four blocks per SM
    lib = _native.lib()
    W = lib.gva_bwd_scratch_width(C)
    scr = _workspace(dev, B * Nq * S * W)
    nsplit = -(-4 * _sm_count(dev) // lib.gva_bwd_sums_tiles(C)) if W else 1
    err = lib.gva_bwd_launch(
        *[a.data_ptr() for a in args], dkv.data_ptr(), dq.data_ptr(),
        mom.data_ptr(), qmom.data_ptr(), part.data_ptr(), scr.data_ptr(), B,
        Nsrc, Nq, S, C, G, nblk, nrow, nsplit, _native.stream_ptr(part))
    _native.check(err, "gva_bwd")
    gva_bwd.launches += 1
    return dkv, dq, part.sum(0), mom, qmom


gva_bwd.launches = 0


_PARAM_ORDER = ("Wp1", "bp1", "gp", "bp", "Wp2", "bp2", "W1", "b1", "gw", "bw",
                "W2", "b2")


def _bwd_host(k6, d_mu_in, d_var_in, p, mu_w, var_w, n, pe):
    """The host algebra of gva_slab.py:_bwd_vjp (:627-719) on K6's outputs:
    unfold the weight-BN affine, apply the weight-BN statistics' gradient
    (dt1 = (c0 + c1 * t1) * valid per edge) analytically from K6's moments,
    and unfold the pe-BN affine through the position moments. Returns
    (dk correction (B, Nsrc, C), dq (B, Nq, C), parameter gradients in the
    order of :data:`_PARAM_ORDER`). ``p`` holds the raw parameters, ``pe``
    the pe-BN batch statistics and position moments of :func:`fold_pe`."""
    dkv, dq, flat, mom, qmom = k6
    W1, b1, gw, bw = p["W1"], p["b1"], p["gw"], p["bw"]
    Wp1, bp1, gp, Wp2 = p["Wp1"], p["bp1"], p["gp"], p["Wp2"]
    C, G = W1.shape
    par = _split_par(flat, C, G)
    W1f, b1f, sw, inv_w = fold_w(W1, b1, gw, bw, mu_w, var_w)
    dW1f, db1f = par["dW1f"], par["db1f"]
    dW1 = dW1f * sw[None, :]
    db1 = db1f * sw
    d_cw = db1f
    d_sw = (dW1f * W1).sum(0) + db1f * b1 - d_cw * mu_w
    d_bw = d_cw
    d_gw = d_sw * inv_w
    d_inv = d_sw * gw
    d_mu = -d_cw * sw + d_mu_in
    d_var = d_inv * (-0.5) * inv_w ** 3 + d_var_in
    c0 = d_mu / n + d_var * (-2.0 * mu_w) / n
    c1 = 2.0 * d_var / n
    # t (folded, as K6 sees it) relates to the unfolded t1 by
    # t1 * valid = (t - cw * valid) / sw, so dt1 = a0 * valid + a1 * t
    cw = b1f - b1 * sw
    a0 = c0 - c1 * cw / sw
    a1 = c1 / sw
    dk_corr = (a0 * mom[..., :1] + a1 * mom[..., 1:]) @ W1.T
    dq = dq - (a0 * qmom[..., :1] + a1 * qmom[..., 1:]) @ W1.T
    mp = par["mom_par"]
    Rv, RT = mp[0, :C], mp[1:, :C].T
    Pv, PT = mp[0, C:2 * C], mp[1:, C:2 * C].T
    Uv, UT = mp[0, 2 * C:3 * C], mp[1:, 2 * C:3 * C].T
    Av = mp[0, 3 * C:].reshape(3, C)
    AT = mp[1:, 3 * C:].reshape(G, 3, C)
    dW1 = dW1 + Rv[:, None] * a0[None, :] + RT * a1[None, :]
    dsum1 = a0 * n + a1 * (sw * mu_w * n + cw * n)  # sum_e dt1 per group
    db1 = db1 + dsum1
    dWp2 = par["dWp2"] + (Pv[:, None] * a0[None, :] + PT * a1[None, :]) @ W1.T
    dbp2 = par["dbp2"] + dsum1 @ W1.T
    Kc = Wp2 @ W1  # (C, G): dpe1 = dt1 @ (Wp2 W1)^T
    dcA = par["dcA"] + Uv * (Kc @ a0) + (UT * Kc) @ a1
    dA = par["dA"] + Av * (Kc @ a0)[None, :] + torch.einsum(
        "g,gxc,cg->xc", a1, AT, Kc)
    # unfold the pe affine: A = Wp1 * s_p, cA = (bp1 - mu_p) * s_p + bp,
    # mu_p = pmean @ Wp1 + bp1, var_p = w_c^T pcov w_c
    mu_p, var_p, pmean, pcov = pe["mu_p"], pe["var_p"], pe["pmean"], pe["pcov"]
    inv_p = torch.rsqrt(var_p + _EPS)
    s_p = gp * inv_p
    dWp1 = dA * s_p[None, :]
    d_sp = (dA * Wp1).sum(0) + dcA * (bp1 - mu_p)
    dbp1 = dcA * s_p
    d_mu_p = -dcA * s_p
    d_gp = d_sp * inv_p
    d_var_p = d_sp * gp * (-0.5) * inv_p ** 3
    dWp1 = dWp1 + pmean[:, None] * d_mu_p[None, :]
    dbp1 = dbp1 + d_mu_p
    dWp1 = dWp1 + 2.0 * (pcov @ Wp1) * d_var_p[None, :]
    return dk_corr, dq, (dWp1, dbp1, d_gp, dcA, dWp2, dbp2, dW1, db1, d_gw,
                         d_bw, par["dW2"], par["db2"])


class GVATrain(torch.autograd.Function):
    """Train-mode GVA with batch statistics (port of gva_slab.py /
    gva_fused.py:gva_core's custom VJP).

    Forward: K5 (weight-BN statistics), the folds, K3 with the batch-stat
    folds. Backward: K6, then :func:`_bwd_host`. The kernels' wrappers run
    their plain versions on CPU tensors, so one function serves both.

    Inputs: src, qrow, idx, valid (the row contract of :func:`gva_eval`),
    the position moments (psum, ppsum, pn) of K4, and the raw parameters
    Wp1, bp1, gp, bp, Wp2, bp2, W1, b1, gw, bw, W2, b2. Outputs: out
    (B, Nq, C) f32, the weight-BN batch (mean, biased var, count) and the
    pe-BN batch (mean, biased var, count). Gradients flow to src (k and v
    lanes), qrow (q lanes), the parameters, and the weight-BN mean and
    variance; the counts and the pe-BN statistics only feed the running
    statistics and are not differentiable."""

    @staticmethod
    def forward(ctx, src, qrow, idx, valid, psum, ppsum, pn, Wp1, bp1, gp, bp,
                Wp2, bp2, W1, b1, gw, bw, W2, b2):
        A, cA, mu_p, var_p, pmean, pcov = fold_pe(Wp1, bp1, gp, bp,
                                                  (psum, ppsum, pn))
        st, st2, cnt = gva_stats(src, qrow, idx, valid, A, cA, Wp2, bp2,
                                 W1, b1)[:3]
        n = torch.clamp_min(cnt, 1.0)
        mu_w = st / n
        var_w = torch.clamp_min(st2 / n - mu_w * mu_w, 0.0)
        W1f, b1f, _, _ = fold_w(W1, b1, gw, bw, mu_w, var_w)
        fp = dict(A=A, cA=cA, Wp2=Wp2, bp2=bp2, W1f=W1f, b1f=b1f, W2=W2, b2=b2)
        out = gva_eval(src, qrow, idx, valid, fp)
        ctx.save_for_backward(src, qrow, idx, valid, Wp1, bp1, gp, bp, Wp2,
                              bp2, W1, b1, gw, bw, W2, b2, mu_w, var_w, n,
                              mu_p, var_p, pmean, pcov, A, cA)
        pn_out = pn.detach().clone()
        ctx.mark_non_differentiable(n, mu_p, var_p, pn_out)
        return out, mu_w, var_w, n, mu_p, var_p, pn_out

    @staticmethod
    def backward(ctx, dout, d_mu, d_var, *_):
        (src, qrow, idx, valid, Wp1, bp1, gp, bp, Wp2, bp2, W1, b1, gw, bw,
         W2, b2, mu_w, var_w, n, mu_p, var_p, pmean, pcov, A,
         cA) = ctx.saved_tensors
        C, G = W1.shape
        if dout is None:
            dout = torch.zeros(qrow.shape[:2] + (C,), dtype=mu_w.dtype,
                               device=src.device)
        d_mu = torch.zeros_like(mu_w) if d_mu is None else d_mu
        d_var = torch.zeros_like(var_w) if d_var is None else d_var
        W1f, b1f, _, _ = fold_w(W1, b1, gw, bw, mu_w, var_w)
        fp = dict(A=A, cA=cA, Wp2=Wp2, bp2=bp2, W1f=W1f, b1f=b1f, W2=W2, b2=b2)
        k6 = gva_bwd(src, qrow, idx, valid, fp, dout)
        p = dict(W1=W1, b1=b1, gw=gw, bw=bw, Wp1=Wp1, bp1=bp1, gp=gp, Wp2=Wp2)
        dk_corr, dq, pgrads = _bwd_host(
            k6, d_mu, d_var, p, mu_w, var_w, n,
            dict(mu_p=mu_p, var_p=var_p, pmean=pmean, pcov=pcov))
        dkv = k6[0]
        dsrc = torch.cat([dkv[..., :C] + dk_corr, dkv[..., C:],
                          torch.zeros_like(dkv[..., :6])], dim=-1)
        dqrow = torch.cat([dq, torch.zeros_like(dq[..., :7])], dim=-1)
        return (dsrc.to(src.dtype), dqrow.to(qrow.dtype), None, None, None,
                None, None) + tuple(pgrads)


def gva_train(src, qrow, idx, valid, p, pos_moments=None):
    """Train-mode GVA on the kernels: K4 when ``pos_moments`` is None (the
    first block at a resolution), then :class:`GVATrain`. ``p`` holds the
    raw parameters (:meth:`GroupedVectorAttention.raw_params`). Returns
    (out, (mu_w, var_w, n_w), (mu_p, var_p, n_p), pos_moments)."""
    if pos_moments is None:
        with torch.no_grad():
            pos_moments = gva_pos(src, qrow, idx, valid)
    out, mu_w, var_w, n_w, mu_p, var_p, n_p = GVATrain.apply(
        src, qrow, idx, valid, *pos_moments, *(p[k] for k in _PARAM_ORDER))
    return out, (mu_w, var_w, n_w), (mu_p, var_p, n_p), pos_moments


def gva_reference(k, v, q, coord6, idx, valid, mask, p, dtype, train=False):
    """Unfused GVA with the reference's pad semantics (port of
    gva_fused.py:gva_reference with pad_mode="reference"): pad slots gather
    zero k/v rows, take part in the softmax denominator, and are zeroed
    after it without renormalising. Eval mode normalises both BNs with the
    running statistics and returns out; train mode uses batch statistics,
    whose moments count every slot of a valid query as torch's unmasked
    BatchNorm1d does, and returns (out, (mu_w, var_w, n_w), (mu_p, var_p,
    n_p)). Differentiable by autograd.

    k, v, q (B, N, C) in the compute dtype; coord6 (B, N, 6) bf16 packed
    coordinates; idx/valid (B, N, S); mask (B, N); p the raw parameters
    and running statistics; ``dtype`` the matmul operand dtype."""
    B, N, S = idx.shape
    C = q.shape[-1]
    G = p["W2"].shape[0]
    kv = torch.cat([k, v], dim=-1).float()
    kv_g = torch.where(valid[..., None], grouping(kv, idx), 0.0)
    k_g, v_g = kv_g[..., :C], kv_g[..., C:]
    c6 = coord6.float()
    pos_all = c6[..., :3] + c6[..., 3:]
    pos = torch.where(valid[..., None],
                      grouping(pos_all, idx) - pos_all[:, :, None], 0.0)
    qf = q.float()

    def mm(a, b):  # matmul with operands in the compute dtype
        return (a.to(dtype) @ b.to(dtype)).float()

    if train:
        stat_m = mask[:, :, None].expand(B, N, S).float()[..., None]
        n_p = stat_m.sum()
        with torch.no_grad():
            moments = (pos.sum((0, 1, 2)),
                       torch.einsum("bnsi,bnsj->ij", pos, pos), n_p)
        A, cA, mu_p, var_p, _, _ = fold_pe(p["Wp1"], p["bp1"], p["gp"],
                                           p["bp"], moments)
    else:
        A, cA = fold_pe_running(p["Wp1"], p["bp1"], p["gp"], p["bp"],
                                p["pe_mean"], p["pe_var"])
    pe1 = torch.relu(mm(pos, A) + cA)
    peb = mm(pe1, p["Wp2"]) + p["bp2"]
    r = k_g - qf[:, :, None] + peb
    v2 = v_g + peb
    t1 = mm(r, p["W1"]) + p["b1"]
    if train:
        n = torch.clamp_min(stat_m.sum(), 1.0)
        mu_w = (t1 * stat_m).sum((0, 1, 2)) / n
        var_w = (((t1 - mu_w) ** 2) * stat_m).sum((0, 1, 2)) / n
    else:
        mu_w, var_w = p["we_mean"], p["we_var"]
    t0 = (t1 - mu_w) * torch.rsqrt(var_w + _EPS) * p["gw"] + p["bw"]
    w = torch.relu(t0) @ p["W2"] + p["b2"]
    w = torch.where(valid[..., None], torch.softmax(w, dim=2), 0.0)
    out = (v2.reshape(B, N, S, G, C // G) * w[..., None]).sum(2)
    out = torch.where(mask[..., None], out.reshape(B, N, C), 0.0)
    if not train:
        return out
    return out, (mu_w, var_w, n), (mu_p, var_p, n_p)
