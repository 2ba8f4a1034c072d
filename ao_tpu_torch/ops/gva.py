"""Eval-mode grouped vector attention of PT-v2m2 (port of the eval parts
of ao_tpu/ops/pallas/gva_fused.py and gva_slab.py).

Carries kernel K3 ``gva_eval`` (CUDA source ``csrc/gva_eval.cu``), which
replaces both eval GVA kernels of the TPU package: ``gva_slab_core_eval``
(Morton-sorted rows, window graph) and ``gva_core_eval`` (pre-gathered
rows). The kernel gathers neighbour rows itself, so one kernel serves
both: the caller passes sorted or unsorted source rows with the matching
neighbour ids.

Row layouts (bf16), as in the TPU package:
  src rows (B, Nsrc, 2C+6): [k | v | coord hi3 | coord lo3]
  q rows   (B, Nq, C+7):    [q | coord hi3 | coord lo3 | row mask]
Coordinates ride as two bf16 halves (``pack_coords``); kernels rebuild
relative positions in f32 from them.

``gva_reference_eval`` is the unfused composition the model runs where
the TPU package runs its unfused path (off the card, or without bf16
compute): it reproduces the reference's pad semantics (softmax over pad
slots, zeroed after) that the kernels do not model.
"""

from __future__ import annotations

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


def fold_w(W1, b1, gw, bw, mu_w, var_w):
    """Fold the weight-encoding BatchNorm into its first layer."""
    inv_w = torch.rsqrt(var_w + _EPS)
    sw = gw * inv_w
    cw = bw - mu_w * sw
    return W1 * sw[None, :], b1 * sw + cw


def folded_params(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Raw GVA parameters + running statistics -> the kernel's folded set
    (A, cA, Wp2, bp2, W1f, b1f, W2, b2), all f32."""
    A, cA = fold_pe_running(p["Wp1"], p["bp1"], p["gp"], p["bp"],
                            p["pe_mean"], p["pe_var"])
    W1f, b1f = fold_w(p["W1"], p["b1"], p["gw"], p["bw"],
                      p["we_mean"], p["we_var"])
    return dict(A=A, cA=cA, Wp2=p["Wp2"], bp2=p["bp2"], W1f=W1f, b1f=b1f,
                W2=p["W2"], b2=p["b2"])


def _bf(x):
    """Round to bf16 and compute on in f32 (the kernels' _mm_bf16 operands)."""
    return x.to(torch.bfloat16).float()


def gva_eval_plain(src, qrow, idx, valid, fp):
    """Plain PyTorch K3: the same function as the kernel (see
    csrc/gva_eval.cu), computed on the gathered (B, Nq, S, .) tensors."""
    B, Nq, S = idx.shape
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    rows = grouping(src, idx.clamp(0, src.shape[1] - 1)).float()
    k = rows[..., :C]
    v = rows[..., C:2 * C]
    pk = rows[..., 2 * C:2 * C + 3] + rows[..., 2 * C + 3:2 * C + 6]
    qf = qrow.float()
    q = qf[..., :C]
    pq = qf[..., C:C + 3] + qf[..., C + 3:C + 6]
    mrow = qf[..., C + 6]
    vf = valid.float()[..., None]
    pos = (pk - pq[:, :, None]) * vf
    pe0 = (_bf(pos) @ _bf(fp["A"]) + fp["cA"]) * vf
    peb = _bf(torch.relu(pe0)) @ _bf(fp["Wp2"]) + fp["bp2"]
    r = k - q[:, :, None] + peb
    v2 = v + peb
    t = (_bf(r) @ _bf(fp["W1f"]) + fp["b1f"]) * vf
    w = torch.relu(t) @ fp["W2"] + fp["b2"]
    wm = torch.where(valid[..., None], w, -1e30)
    mx = wm.amax(dim=2, keepdim=True)
    z = torch.exp(torch.clamp_min(wm - mx, -80.0)) * vf
    sm = z / torch.clamp_min(z.sum(2, keepdim=True), 1e-30)
    out = (v2.reshape(B, Nq, S, G, C // G) * sm[..., None]).sum(2)
    return out.reshape(B, Nq, C) * mrow[..., None]


def gva_eval(src, qrow, idx, valid, fp):
    """K3 (replaces gva_slab.py:gva_slab_core_eval and
    gva_fused.py:gva_core_eval).

    src (B, Nsrc, 2C+6) bf16 rows, qrow (B, Nq, C+7) bf16, idx (B, Nq, S)
    ids into src, valid (B, Nq, S) bool, fp the folded parameters of
    :func:`folded_params`. Returns out (B, Nq, C) f32."""
    if src.device.type == "cpu":
        return gva_eval_plain(src, qrow, idx, valid, fp)
    B, Nsrc, rw = src.shape
    Nq, S = idx.shape[1:]
    C = qrow.shape[-1] - 7
    G = fp["W2"].shape[0]
    if (rw != 2 * C + 6 or S != 16 or C % 4 or C % G
            or src.dtype != torch.bfloat16 or qrow.dtype != torch.bfloat16):
        raise ValueError(
            f"gva_eval: rows {tuple(src.shape)} {src.dtype}, qrow "
            f"{tuple(qrow.shape)}, S={S}, G={G} outside the kernel's contract"
        )
    bf = torch.bfloat16
    args = [
        src.contiguous(), qrow.contiguous(),
        idx.to(torch.int32).contiguous(), valid.to(torch.uint8).contiguous(),
        fp["A"].to(bf).contiguous(), fp["cA"].float().contiguous(),
        fp["Wp2"].to(bf).contiguous(), fp["bp2"].float().contiguous(),
        fp["W1f"].to(bf).contiguous(), fp["b1f"].float().contiguous(),
        fp["W2"].float().contiguous(), fp["b2"].float().contiguous(),
    ]
    _native.require_cuda("gva_eval", *args)
    out = torch.empty((B, Nq, C), dtype=torch.float32, device=src.device)
    err = _native.lib().gva_eval_launch(
        *[a.data_ptr() for a in args], out.data_ptr(), B, Nsrc, Nq, S, C, G,
        _native.stream_ptr(out),
    )
    _native.check(err, "gva_eval")
    gva_eval.launches += 1
    return out


gva_eval.launches = 0


def gva_reference_eval(k, v, q, coord6, idx, valid, mask, p, dtype):
    """Unfused eval GVA with the reference's pad semantics (port of
    gva_fused.py:gva_reference, running statistics, pad_mode="reference"):
    pad slots gather zero k/v rows, take part in the softmax denominator,
    and are zeroed after it without renormalising.

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

    A, cA = fold_pe_running(p["Wp1"], p["bp1"], p["gp"], p["bp"],
                            p["pe_mean"], p["pe_var"])
    pe1 = torch.relu(mm(pos, A) + cA)
    peb = mm(pe1, p["Wp2"]) + p["bp2"]
    r = k_g - qf[:, :, None] + peb
    v2 = v_g + peb
    t1 = mm(r, p["W1"]) + p["b1"]
    t0 = ((t1 - p["we_mean"]) * torch.rsqrt(p["we_var"] + _EPS) * p["gw"]
          + p["bw"])
    w = torch.relu(t0) @ p["W2"] + p["b2"]
    w = torch.where(valid[..., None], torch.softmax(w, dim=2), 0.0)
    out = (v2.reshape(B, N, S, G, C // G) * w[..., None]).sum(2)
    return torch.where(mask[..., None], out.reshape(B, N, C), 0.0)
