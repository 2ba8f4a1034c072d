"""Smoke run of the PyTorch / CUDA port (ao_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc; exits non-zero without them. Reads nothing
under data/ or exp/: the scenes are synthetic and the weights are random.
PT-v2m2 runs at the full width of configs/s3dis/semseg-pt-v2m2-0-base.py.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the kernels (one nvcc call over csrc/*.cu).
2. Kernel phase (test slice): runs the slice phase's own largest batch
   (8 distinct fragments of a synthetic room, padded as the tester pads
   them) and a small batch of two room pieces padded to 16384, whose deep
   stages fall below the 2048-point slab gate. The inputs of every kernel
   call with a new shape are captured; each kernel is then held against
   its plain PyTorch version on them and timed (CUDA events, after
   warm-up) beside the plain version, a library call where one computes
   the same function, and its bound.
3. Slice phase: whole-scene testing of the room through the port's entry
   point (ao_tpu_torch.tools.test) with the config's 10 TTA views; every
   point must receive finite votes from every view. Then the largest
   batch's forward is timed and traced with torch.profiler.
4. Train kernel phase: one train step of the train phase's batch (three
   synthetic rooms of about 80k voxels each, B=3 x 81920, every stage on
   the slab path) and one of the small batch (deep stages gathered), with
   the train path's GVA kernels captured (K3 with batch-statistic folds,
   K4 position moments, K5 weight-BN statistics, K6 backward); each held
   against its plain version and timed as in 2.
5. Train phase: a few steps of the base config's Trainer through the
   port's entry point (ao_tpu_torch.tools.train) on the three rooms; every
   loss and gradient norm must be finite and the parameters must move.
   Prints the step seconds, the data wait and the peak device memory, then
   times and traces one more step with torch.profiler.

Each main path (the slice phase, the train phase) runs with every
kernel's launch count set to 0 just before it and read just after, and
fails if one of its kernels never launched. The last three lines are the
card, the kernels' JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(ROOT, "configs", "s3dis", "semseg-pt-v2m2-0-base.py")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {
    "knn_window": dict(
        route="cuda", source="ao_tpu_torch/csrc/knn_window.cu",
        replaces="ao_tpu/ops/pallas/knn_window.py:108"),
    "merge_topk": dict(
        route="cuda", source="ao_tpu_torch/csrc/merge_topk.cu",
        replaces="ao_tpu/ops/pallas/merge_topk.py:91"),
    "gva_eval": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_eval.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:263 + "
                 "ao_tpu/ops/pallas/gva_fused.py:276"),
    "gva_pos": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_pos.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:203 + "
                 "ao_tpu/ops/pallas/gva_fused.py:242"),
    "gva_stats": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_stats.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:236 + "
                 "ao_tpu/ops/pallas/gva_fused.py:218"),
    "gva_bwd": dict(
        route="cuda", source="ao_tpu_torch/csrc/gva_bwd.cu",
        replaces="ao_tpu/ops/pallas/gva_slab.py:294 + "
                 "ao_tpu/ops/pallas/gva_fused.py:292 + "
                 "ao_tpu/ops/pallas/gva_fused.py:346"),
}
# the kernels of each main path (all six run in a train step)
SLICE_KERNELS = ("knn_window", "merge_topk", "gva_eval")
TRAIN_KERNELS = tuple(KERNEL_INFO)
# (make_room seed, room size in m) of the train phase's three rooms: over
# 100k voxels of 0.04 m each, so that after the train transforms
# (RandomScale down to 0.9) SphereCrop keeps 80000 points and the batch
# pads to the config's 81920
TRAIN_ROOMS = ((1, (6.0, 5.0, 3.0)), (2, (6.4, 4.8, 3.0)),
               (3, (5.6, 5.4, 3.2)))

# class id -> base colour of the synthetic room (S3DIS' 13 classes)
_COLORS = np.array([
    [200, 200, 200], [140, 120, 100], [220, 210, 190], [120, 100, 80],
    [180, 180, 170], [150, 190, 230], [130, 90, 60], [160, 110, 70],
    [60, 60, 140], [120, 40, 40], [90, 70, 50], [30, 80, 40], [110, 110, 110],
], np.float32)


def log(t0, msg):
    print(f"[{time.perf_counter() - t0:8.1f} s] {msg}", flush=True)


def card_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
            f"nvidia-smi failed: {res.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# synthetic S3DIS room
# ---------------------------------------------------------------------------


def _plane(rng, origin, u, v, spacing):
    """Jittered grid of points on the rectangle origin + [0,1]u + [0,1]v."""
    origin, u, v = (np.asarray(x, np.float64) for x in (origin, u, v))
    nu = max(int(np.linalg.norm(u) / spacing), 1)
    nv = max(int(np.linalg.norm(v) / spacing), 1)
    a, b = np.meshgrid((np.arange(nu) + 0.5) / nu, (np.arange(nv) + 0.5) / nv)
    pts = origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v
    return pts + rng.uniform(-0.1, 0.1, pts.shape) * spacing


def _box(rng, lo, hi, spacing):
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    d = hi - lo
    ex, ey, ez = np.diag(d)
    faces = [
        (lo, ex, ey), (lo + ez, ex, ey), (lo, ex, ez), (lo + ey, ex, ez),
        (lo, ey, ez), (lo + ex, ey, ez),
    ]
    return np.concatenate([_plane(rng, o, u, v, spacing) for o, u, v in faces])


def make_room(seed, size=(4.8, 4.0, 2.6), spacing=0.034):
    """One room in the S3DIS scene format: a shell (floor, ceiling, walls
    with a door, a window and a board), a beam, a column and box
    furniture, all placed relative to the room's size; coord (n, 3) f32,
    color (n, 3) in 0..255, semantic_gt (n, 1) in 0..12. At the default
    size the 0.04 m test voxelisation keeps about 80k points per
    fragment."""
    rng = np.random.default_rng(seed)
    X, Y, Z = size
    parts = []

    def add(points, label):
        parts.append((points, np.full(len(points), label, np.int64)))

    def box(lo, hi, label):  # lo / hi as fractions of the room
        add(_box(rng, np.multiply(lo, size), np.multiply(hi, size), spacing),
            label)

    add(_plane(rng, (0, 0, 0), (X, 0, 0), (0, Y, 0), spacing), 1)  # floor
    add(_plane(rng, (0, 0, Z), (X, 0, 0), (0, Y, 0), spacing), 0)  # ceiling
    walls = np.concatenate([
        _plane(rng, (0, 0, 0), (X, 0, 0), (0, 0, Z), spacing),
        _plane(rng, (0, Y, 0), (X, 0, 0), (0, 0, Z), spacing),
        _plane(rng, (0, 0, 0), (0, Y, 0), (0, 0, Z), spacing),
        _plane(rng, (X, 0, 0), (0, Y, 0), (0, 0, Z), spacing),
    ])
    wl = np.full(len(walls), 2, np.int64)
    x, y, z = (walls / np.asarray(size)).T
    eps = 1e-4
    wl[(y < eps) & (x > 0.15) & (x < 0.33) & (z < 0.77)] = 6  # door
    wl[(y > 1 - eps) & (x > 0.4) & (x < 0.7) & (z > 0.35) & (z < 0.77)] = 5
    wl[(x < eps) & (y > 0.3) & (y < 0.7) & (z > 0.38) & (z < 0.77)] = 11
    parts.append((walls, wl))
    box((0, 0.5, 0.89), (1, 0.56, 1), 3)  # beam
    box((0.92, 0.9, 0), (1, 1, 1), 4)  # column
    box((0.3, 0.3, 0.27), (0.63, 0.52, 0.29), 7)  # table
    box((0.17, 0.3, 0), (0.27, 0.41, 0.35), 8)  # chairs
    box((0.68, 0.35, 0), (0.77, 0.46, 0.35), 8)
    box((0.01, 0.01, 0), (0.39, 0.22, 0.31), 9)  # sofa
    box((0.75, 0.01, 0), (0.99, 0.11, 0.77), 10)  # bookcase
    n_clutter = int(0.01 * X * Y * Z / spacing**2)
    add(rng.uniform((0.1 * X, 0.1 * Y, 0), (0.9 * X, 0.9 * Y, 0.6 * Z),
                    (n_clutter, 3)), 12)

    coord = np.concatenate([p for p, _ in parts]).astype(np.float32)
    label = np.concatenate([lab for _, lab in parts])
    color = np.clip(_COLORS[label] + rng.normal(0, 12, (len(label), 3)), 0, 255)
    return dict(coord=coord, color=color.astype(np.float32),
                semantic_gt=label.reshape(-1, 1))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


class Capture:
    """Wraps the kernel wrappers so that the inputs of the first call of
    each (kernel, shape) are kept for the comparison with the plain
    versions."""

    def __init__(self):
        self.calls = {}
        self._undo = []

    def wrap(self, module, attr, name):
        fn = getattr(module, attr)

        def rec(*args):
            key = (name,) + tuple(
                tuple(a.shape) if torch.is_tensor(a) else a
                for a in args if not isinstance(a, dict))
            if key not in self.calls:
                self.calls[key] = (name, fn, [
                    a.clone() if torch.is_tensor(a)
                    else {k: v.clone() for k, v in a.items()}
                    if isinstance(a, dict) else a for a in args])
            return fn(*args)

        # the wrapper counts its launches on the module attribute, which
        # is this function while wrapped (these counts are discarded)
        rec.launches = 0
        setattr(module, attr, rec)
        self._undo.append((module, attr, fn))

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def _bound(nbytes, bf16_ops=0.0, f32_ops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bf16_ops / BF16_FLOP_PER_S + f32_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_knn_window(args, out_k, out_p):
    keys, k2, order, q, ws, k, tile_q, window = args
    (dk, ik), (dp, ip) = out_k, out_p
    B, Nq = q.shape[:2]
    T = Nq // tile_q
    # the (B, T, tile_q, window) score tile and window ids of the same inputs
    start = ws.long().clamp(0, keys.shape[1] - window)
    cols = (start[..., None] + torch.arange(window, device=ws.device)).reshape(B, -1)
    wk = torch.gather(keys, 1, cols[..., None].expand(-1, -1, 3))
    wo = torch.gather(order, 1, cols).reshape(B, T, window)
    scores = torch.gather(k2, 1, cols).reshape(B, T, 1, window) - 2.0 * torch.matmul(
        q.reshape(B, T, tile_q, 3), wk.reshape(B, T, window, 3).transpose(-1, -2))

    err = (dk - dp).abs()
    tol = 1e-5 * torch.clamp_min(dp.abs(), 1.0)
    ok = bool((err <= tol).all())
    # ids may differ only between equidistant candidates: every differing
    # id must be one of its tile's window ids whose score is the score the
    # kernel emitted for it
    b, n, j = (ik != ip).nonzero(as_tuple=True)
    t, qi = n // tile_q, n % tile_q
    hit = wo[b, t] == ik[b, n, j][:, None]
    col = hit.float().argmax(dim=1)
    s_hit = scores[b, t, qi, col]
    ok = ok and bool(hit.any(dim=1).all()) and bool(
        ((s_hit - dk[b, n, j]).abs() <= tol[b, n, j]).all())
    nbytes = _nbytes(keys, k2, order, q, ws) + B * Nq * k * 8
    # per (query, key) pair: 3 mul + 2 add for q.k, x2, -, and a compare
    bound_ms, by = _bound(nbytes, f32_ops=8.0 * B * Nq * window)
    # yardstick: torch.topk over the materialised score tile
    lib_ms = cuda_ms(lambda: torch.topk(scores, k, dim=-1, largest=False))
    return ok, float(err.max()), bound_ms, by, lib_ms, (
        f"ids differing at ties {len(b)}")


def check_merge_topk(args, out_k, out_p):
    d2, idx, k = args
    (dk, ik), (dp, ip) = out_k, out_p
    ok = torch.equal(ik, ip) and torch.equal(dk.view(torch.int32),
                                             dp.view(torch.int32))
    rows, width = d2.numel() // d2.shape[-1], d2.shape[-1]
    nbytes = _nbytes(d2, idx) + rows * k * 8
    bound_ms, by = _bound(nbytes, f32_ops=3.0 * rows * k * width)
    return ok, float((dk - dp).abs().max()), bound_ms, by, None, "bitwise"


def check_gva_eval(args, out_k, out_p):
    src, qrow, idx, valid, fp = args
    err = float((out_k - out_p).abs().max())
    scale = max(float(out_p.abs().max()), 1.0)
    ok = err < 5e-3 * scale
    B, Nq, S = idx.shape
    C, G = qrow.shape[-1] - 7, fp["W2"].shape[0]
    nbytes = _nbytes(src, qrow, idx, valid, *fp.values()) + B * Nq * C * 4
    slots = B * Nq * S
    mm = slots * (2 * 3 * C + 2 * C * C + 2 * C * G)  # bf16-operand products
    other = slots * (2 * G * G + 8 * C + 6 * G)  # f32 products, softmax, sums
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=other)
    return ok, err, bound_ms, by, None, f"scale {scale:.3g}"


def _gva_dims(args):
    """(B, Nq, S, Nsrc, C) of a GVA kernel's row arguments."""
    src, qrow, idx = args[:3]
    return (*idx.shape, src.shape[1], qrow.shape[-1] - 7)


def _rel(out_k, out_p, scale=None):
    """(max abs error, the reference's scale) of two tensors."""
    err = float((out_k.float() - out_p.float()).abs().max())
    ref = float(out_p.abs().max()) if scale is None else scale
    return err, max(ref, 1e-12)


def check_gva_pos(args, out_k, out_p):
    src, qrow, idx, valid = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    ok, errs, notes = torch.equal(out_k[2], out_p[2]), [], []
    for name, a, b in zip(("psum", "ppsum"), out_k[:2], out_p[:2]):
        err, scale = _rel(a, b)
        ok = ok and err <= 1e-4 * scale  # f32 sums of ~4M terms
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(out_p[2])
    # coordinate lanes of every source and query row, ids, validity
    nbytes = (B * (Nsrc + Nq) * 6 * 2 + _nbytes(idx, valid) + 13 * 4)
    bound_ms, by = _bound(nbytes, f32_ops=30.0 * edges)
    return ok, max(errs), bound_ms, by, None, (
        f"count {edges:.0f} exact={torch.equal(out_k[2], out_p[2])}; rel "
        + " ".join(notes))


def check_gva_stats(args, out_k, out_p):
    src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1 = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    G = W1.shape[1]
    ok, errs, notes = torch.equal(out_k[2], out_p[2]), [], []
    for name, a, b in zip(("sum_t", "sum_t2", "count", "psum", "ppsum"),
                          out_k, out_p):
        err, scale = _rel(a, b)
        ok = ok and err <= 1e-4 * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(out_p[2])
    nbytes = (B * Nsrc * (C + 6) * 2 + B * Nq * (C + 7) * 2
              + _nbytes(idx, valid, A, cA, Wp2, bp2, W1, b1) + (2 * G + 13) * 4)
    # the products pe0 (K = 3, bf16 operands), peb and t at the bf16 rate;
    # the elementwise steps and sums at the f32 rate
    mm = edges * (2 * 3 * C + 2 * C * C + 2 * C * G)
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=edges * (6 * C + 6 * G))
    return ok, max(errs), bound_ms, by, None, "rel " + " ".join(notes)


# K6's parameter sums and the weight sums whose scale their bias sums are
# measured against (db2 is zero up to rounding: the softmax is
# shift-invariant)
_PARTNER = {"db1f": "dW1f", "db2": "dW2", "dbp2": "dWp2", "dcA": "dA"}


def check_gva_bwd(args, out_k, out_p):
    from ao_tpu_torch.ops.gva import _split_par, bwd_par_layout

    src, qrow, idx, valid, fp, dout = args
    B, Nq, S, Nsrc, C = _gva_dims(args)
    G = fp["W2"].shape[0]
    # dkv / dq / the parameter sums: f32 atomics in changing order, and the
    # bf16 rounding of dt and dpeb can flip by one unit where the kernel's
    # sums differ in the last bit: 1e-2 of scale (measured up to 5.8e-3);
    # the [valid | t] moments: 1e-3
    ok, errs, notes = True, [], []
    for name, a, b, tol in (("dkv", out_k[0], out_p[0], 1e-2),
                            ("dq", out_k[1], out_p[1], 1e-2),
                            ("mom", out_k[3], out_p[3], 1e-3),
                            ("qmom", out_k[4], out_p[4], 1e-3)):
        err, scale = _rel(a, b)
        ok = ok and err <= tol * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    pk, pp = _split_par(out_k[2], C, G), _split_par(out_p[2], C, G)
    for name in pk:
        scale = float(pp[name].abs().max())
        if name in _PARTNER:
            scale = max(scale, float(pp[_PARTNER[name]].abs().max()))
        err, scale = _rel(pk[name], pp[name], scale)
        ok = ok and err <= 1e-2 * scale
        errs.append(err)
        notes.append(f"{name} {err / scale:.2g}")
    edges = float(valid.sum())
    P = sum(math.prod(shape) for _, shape in bwd_par_layout(C, G))
    nbytes = (_nbytes(src, qrow, idx, valid, dout, *fp.values())
              + B * Nsrc * (2 * C + 1 + G) * 4 + B * Nq * (C + 1 + G) * 4
              + P * 4)
    # at the bf16 rate the products with bf16 operands (as the TPU kernel):
    # pe0 (K = 3), peb and dpe0 and the sum pe1^T dpeb (C x C each), t, dr
    # and the sum r^T dt (C x G each), the (1 + G) x 6C moment; at the f32
    # rate the three G x G products (f32 operands), the softmax and the
    # elementwise steps
    mm = edges * (2 * 3 * C + 6 * C * C + 6 * C * G + 12 * C * (1 + G))
    f32 = edges * (6 * G * G + 36 * C)
    bound_ms, by = _bound(nbytes, bf16_ops=mm, f32_ops=f32)
    return ok, max(errs), bound_ms, by, None, "rel " + " ".join(notes)


def describe(name, args):
    if name == "knn_window":
        keys, _, _, q, _, k, tile_q, window = args
        return (f"B={q.shape[0]} Nq={q.shape[1]} Nk={keys.shape[1]} k={k} "
                f"tile_q={tile_q} window={window}")
    if name == "merge_topk":
        d2, _, k = args
        return f"B={d2.shape[0]} N={d2.shape[1]} width={d2.shape[2]} k={k}"
    B, Nq, S, Nsrc, C = _gva_dims(args)
    mode = "slab" if Nsrc >= 2048 else "gathered"
    G = (args[4]["W2"].shape[0] if name in ("gva_eval", "gva_bwd")
         else args[8].shape[1] if name == "gva_stats" else None)
    g = f" G={G}" if G else ""
    return f"B={B} N={Nq} S={S} C={C}{g} mode={mode}"


PLAIN = {}  # kernel name -> its plain version, filled by plain_versions()
CHECKS = {"knn_window": check_knn_window, "merge_topk": check_merge_topk,
          "gva_eval": check_gva_eval, "gva_pos": check_gva_pos,
          "gva_stats": check_gva_stats, "gva_bwd": check_gva_bwd}


def plain_versions():
    from ao_tpu_torch.ops import gva as g
    from ao_tpu_torch.ops import knn_spatial as ks

    PLAIN.update(knn_window=ks.knn_window_plain, merge_topk=ks.merge_topk_plain,
                 gva_eval=g.gva_eval_plain, gva_pos=g.gva_pos_plain,
                 gva_stats=g.gva_stats_plain, gva_bwd=g.gva_bwd_plain)
    return PLAIN


def hold_captured(cap, phase):
    """Hold each kernel against its plain version on every captured
    (kernel, shape) and time both; raise if one disagrees."""
    plain = plain_versions()
    rows, failures = [], []
    for key, (name, fn, args) in cap.calls.items():
        with torch.inference_mode():
            out_k = fn(*args)
            out_p = plain[name](*args)
            torch.cuda.synchronize()
            ok, err, bound_ms, by, lib_ms, note = CHECKS[name](args, out_k, out_p)
            del out_k, out_p
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: plain[name](*args), reps=3, warmup=1)
        row = dict(name=name, phase=phase, shape=describe(name, args), ok=ok,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=lib_ms, note=note)
        rows.append(row)
        print(f"  {name:10s} {row['shape']:46s} ok={ok} err={err:.3g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
              f"({by}) library_ms={lib_ms} {note}", flush=True)
        if not ok:
            failures.append(f"{name} {row['shape']}")
        torch.cuda.empty_cache()
    cap.calls.clear()
    print(json.dumps({"kernel_shapes": rows}), flush=True)
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return rows


def _require(rows, names, what):
    missing = set(names) - {r["name"] for r in rows}
    if missing:
        raise RuntimeError(f"kernels never called on the {what}: {sorted(missing)}")
    for name in names:
        if name.startswith("gva") and not any(
                r["name"] == name and "mode=gathered" in r["shape"] for r in rows):
            raise RuntimeError(f"{name} was not exercised in its gathered mode")


def kernel_phase(model, batches, t0, device):
    """Run the model once on each (label, coord, feat, mask) batch with the
    kernel wrappers captured, then hold each kernel against its plain
    version on every captured (kernel, shape) and time both."""
    from ao_tpu_torch.ops import knn_spatial as ks
    from ao_tpu_torch.models.point_transformer_v2 import ptv2m2

    cap = Capture()
    cap.wrap(ks, "knn_window", "knn_window")
    cap.wrap(ks, "merge_topk", "merge_topk")
    cap.wrap(ptv2m2, "gva_eval", "gva_eval")
    try:
        for label, coord, feat, mask in batches:
            with torch.inference_mode():
                logits = model(coord.to(device), feat.to(device), mask.to(device))
            torch.cuda.synchronize()
            if not torch.isfinite(logits[mask.to(device)]).all():
                raise RuntimeError(f"non-finite logits on the {label}")
            log(t0, f"captured kernel inputs of the {label}, (B, N) "
                    f"{tuple(mask.shape)}, stage capacities "
                    f"{model.backbone.stage_capacities(mask.shape[1])}")
    finally:
        cap.restore()
    rows = hold_captured(cap, "test")
    _require(rows, SLICE_KERNELS, "slice's path")
    return rows


def train_kernel_phase(trainer, batches, t0):
    """One train step on each (label, batch) with the GVA kernel wrappers of
    the train path captured (K3 with batch-statistic folds, K4, K5, K6),
    then each held against its plain version and timed."""
    from ao_tpu_torch.ops import gva as gva_mod

    cap = Capture()
    for name in ("gva_pos", "gva_stats", "gva_eval", "gva_bwd"):
        cap.wrap(gva_mod, name, name)
    try:
        for label, batch in batches:
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
            if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise RuntimeError(f"non-finite loss or gradient on the {label}")
            log(t0, f"captured train kernel inputs of the {label}, (B, N) "
                    f"{tuple(batch['mask'].shape)}, loss {float(m['loss']):.4f}")
    finally:
        cap.restore()
    rows = hold_captured(cap, "train")
    _require(rows, ("gva_pos", "gva_stats", "gva_eval", "gva_bwd"), "train path")
    return rows


def main_path_batch(options, fb=8):
    """The forward of the slice phase with the most points: the tester's
    own (B, N) batch of the room's fragments under ``options``, as
    (label, coord, feat, mask) CPU tensors."""
    from ao_tpu_torch.datasets import build_dataset
    from ao_tpu_torch.engines.test import TesterBase
    from ao_tpu_torch.utils import Config, DictAction

    cfg = Config.fromfile(BASE_CONFIG)
    cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in
                         (o.partition("=")[::2] for o in options)})
    frags = build_dataset(dict(cfg.data.test))[0]["fragment_list"]
    fb = int(cfg.get("test_fragments_per_batch", fb))
    _, batch = max(TesterBase.batches(frags, cfg.get("pad_multiple", 4096), fb),
                   key=lambda gb: gb[1]["mask"].numel())
    return ("slice phase's largest batch", batch["coord"], batch["feat"],
            batch["mask"])


def small_batch(room, n_pad=16384, n_keep=15000):
    """Two pieces of the room's first 0.04 m test fragment (its n_keep
    lowest and n_keep - 1000 highest points in x), padded to n_pad: small
    enough that the deep stages fall below the 2048-point slab gate (the
    gathered GVA and the 3-probe graph), in a batch of two distinct rows."""
    from ao_tpu_torch.datasets.transform import Compose, GridSample

    data = Compose([dict(type="CenterShift", apply_z=True),
                    dict(type="NormalizeColor")])(
        dict(coord=room["coord"].copy(), color=room["color"].copy()))
    frag = GridSample(grid_size=0.04, hash_type="fnv", mode="test",
                      keys=("coord", "color"))(data)[0]
    frag = Compose([dict(type="CenterShift", apply_z=False)])(frag)
    order = np.argsort(frag["coord"][:, 0], kind="stable")
    coord = torch.zeros((2, n_pad, 3))
    feat = torch.zeros((2, n_pad, 6))
    mask = torch.zeros((2, n_pad), dtype=torch.bool)
    for b, rows in enumerate((order[:n_keep], order[-(n_keep - 1000):])):
        c = torch.from_numpy(frag["coord"][rows].astype(np.float32))
        col = torch.from_numpy(frag["color"][rows].astype(np.float32))
        coord[b, : len(rows)] = c
        feat[b, : len(rows)] = torch.cat([c, col], dim=-1)
        mask[b, : len(rows)] = True
    return "small batch", coord, feat, mask


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def slice_setup(room, views=None, pad_multiple=None, workdir=None):
    """Write the room (from :func:`make_room`) under ``workdir`` (a new
    temporary directory by default). Returns (workdir, the entry point's
    KEY=VALUE config overrides for testing it, the number of TTA views)."""
    from ao_tpu_torch.utils import Config

    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_smoke_")
    room_dir = os.path.join(workdir, "s3dis", "Area_5")
    os.makedirs(room_dir, exist_ok=True)
    np.savez(os.path.join(room_dir, "office_1.npz"), **room)
    cfg = Config.fromfile(BASE_CONFIG)
    options = [f"weight={os.path.join(workdir, 'model.pt')}",
               f"save_path={os.path.join(workdir, 'exp')}",
               f"data.test.data_root={os.path.join(workdir, 's3dis')}"]
    n_views = len(cfg.data.test.test_cfg.aug_transform)
    if views is not None:
        n_views = views
        aug = cfg.data.test.test_cfg.aug_transform[:views]
        options.append(f"data.test.test_cfg.aug_transform={aug!r}")
    if pad_multiple is not None:
        options.append(f"pad_multiple={pad_multiple}")
    return workdir, options, n_views


def run_slice(device, seed=0, room_size=(4.8, 4.0, 2.6), spacing=0.034,
              views=None, pad_multiple=None, workdir=None, model=None,
              setup=None):
    """Whole-scene testing of one synthetic room through the port's entry
    point, on the room of ``setup`` (from :func:`slice_setup`) or a new
    one. Returns (result dict, votes (n, 13), n_views)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.tools.test import main as test_main
    from ao_tpu_torch.utils import Config

    workdir, options, n_views = setup or slice_setup(
        make_room(seed, room_size, spacing), views, pad_multiple, workdir)
    if model is None:
        torch.manual_seed(seed)
        model = build_model(dict(Config.fromfile(BASE_CONFIG).model))
    torch.save(model.state_dict(), os.path.join(workdir, "model.pt"))
    result = test_main(["--config-file", BASE_CONFIG, "--device", str(device),
                        "--options", *options])
    votes = np.load(os.path.join(workdir, "exp", "result", "office_1_pred.npy"))
    return result, votes, n_views


def check_votes(votes, n_views):
    if votes.ndim != 2 or votes.shape[1] != 13:
        raise RuntimeError(f"votes of shape {votes.shape}, expected (n, 13)")
    if not np.isfinite(votes).all():
        raise RuntimeError("non-finite votes")
    # every vote is a whole softmax row, and every view's fragments cover
    # every point at least once (points of sparse voxels recur in several
    # complementary fragments)
    total = votes.sum(-1)
    if not (np.abs(total - np.round(total)) < 1e-3).all():
        raise RuntimeError("votes are not sums of whole probability rows")
    if not (total > n_views - 1e-3).all():
        raise RuntimeError("a point missed the vote of some view")


def _by_kernel(events):
    """Device ms and launches of each port kernel in a profile (K6's sums
    pass counts with K6)."""
    out = {}
    for name in KERNEL_INFO:
        hits = [e for e in events if name in e.key]
        out[name] = dict(ms=sum(e.self_device_time_total for e in hits) / 1e3,
                         launches=sum(e.count for e in hits))
    return out


def profile_forward(model, batch, device):
    """Time one eval forward of a (label, coord, feat, mask) batch (CUDA
    events), then trace one with torch.profiler: device time by kernel
    name and the device's busy share of the forward."""
    _, coord, feat, mask = batch
    c, f, m = coord.to(device), feat.to(device), mask.to(device)
    with torch.inference_mode():
        wall_ms = cuda_ms(lambda: model(c, f, m), reps=3, warmup=1)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            model(c, f, m)
            torch.cuda.synchronize()
    # kernel rows only (op rows repeat their kernels' device time)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                calls=e.count) for e in events[:12]]
    return dict(shape=list(mask.shape), points=int(mask.sum()),
                wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, top=top,
                port_kernels=_by_kernel(events))


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------


def train_setup(rooms, workdir=None, batch_size=3, max_steps=5, workers=3,
                seed=0):
    """Write the rooms (from :func:`make_room`) as scenes of the S3DIS train
    split under ``workdir`` (a new temporary directory by default), one
    area each. Returns (workdir, the train entry point's KEY=VALUE config
    overrides)."""
    workdir = workdir or tempfile.mkdtemp(prefix="ao_chip_train_")
    for i, room in enumerate(rooms):
        room_dir = os.path.join(workdir, "s3dis", f"Area_{i + 1}")
        os.makedirs(room_dir, exist_ok=True)
        np.savez(os.path.join(room_dir, f"office_{i}.npz"), **room)
    options = [f"save_path={os.path.join(workdir, 'exp')}",
               f"data.train.data_root={os.path.join(workdir, 's3dis')}",
               f"batch_size={batch_size}", f"max_steps={max_steps}",
               f"num_worker={workers}", f"seed={seed}"]
    return workdir, options


def build_trainer(options, device):
    from ao_tpu_torch.engines import Trainer, default_config_parser
    from ao_tpu_torch.utils import DictAction

    opts = {k: DictAction._parse_value(v) for k, v in
            (o.partition("=")[::2] for o in options)}
    return Trainer(default_config_parser(BASE_CONFIG, opts), device=device)


def run_train(device, options):
    """Training through the port's entry point; returns the trainer."""
    from ao_tpu_torch.tools.train import main as train_main

    return train_main(["--config-file", BASE_CONFIG, "--device", str(device),
                       "--options", *options])


def check_train(trainer, steps):
    """Every step's loss and gradient norm finite, and the parameters moved
    away from the initial weights (rebuilt from the trainer's seed)."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.utils.env import set_seed

    hist = trainer.history
    if len(hist) != steps:
        raise RuntimeError(f"{len(hist)} train steps, expected {steps}")
    for i, r in enumerate(hist):
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise RuntimeError(f"step {i}: non-finite loss or gradient {r}")
    set_seed(trainer.seed)
    init = build_model(dict(trainer.cfg.model)).state_dict()
    params = dict(trainer.model.named_parameters())
    changed = sum(not torch.equal(p.detach().cpu(), init[n])
                  for n, p in params.items())
    if changed < 0.9 * len(params):
        raise RuntimeError(f"only {changed} of {len(params)} parameter tensors "
                           f"changed in training")
    return changed, len(params)


def profile_train_step(trainer, batch):
    """Time one train step (host clock around a synchronised step), then
    trace one with torch.profiler: device time by kernel name and the
    device's busy share of the step."""
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                calls=e.count) for e in events[:15]]
    return dict(shape=list(batch["mask"].shape),
                points=int(batch["mask"].sum()), wall_ms=wall_ms,
                device_ms=device_ms, busy_share=device_ms / wall_ms, top=top,
                port_kernels=_by_kernel(events))


def _wrappers():
    from ao_tpu_torch.ops import gva, knn_spatial

    return {"knn_window": knn_spatial.knn_window,
            "merge_topk": knn_spatial.merge_topk, "gva_eval": gva.gva_eval,
            "gva_pos": gva.gva_pos, "gva_stats": gva.gva_stats,
            "gva_bwd": gva.gva_bwd}


def _drive(path_kernels, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; fail if a kernel of the path never launched."""
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    launches = {n: w.launches for n, w in wrappers.items()}
    missing = [n for n in path_kernels if launches[n] <= 0]
    if missing:
        raise RuntimeError(f"kernels of the path never launched: {missing} "
                           f"({launches})")
    return out, launches


def run(device, seed, t0, room_size=(4.8, 4.0, 2.6), train_steps=5, card="",
        **setup_kw):
    """The test slice (kernel phase, slice phase, forward profile), then the
    train slice (train kernel phase, train phase, train-step profile); each
    main path is driven with the launch counts set to 0 just before it and
    read just after. Returns the kernels' record."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.utils import Config

    cfg = Config.fromfile(BASE_CONFIG)
    torch.manual_seed(seed)
    model = build_model(dict(cfg.model)).to(device).eval()
    room = make_room(seed, room_size)
    setup = slice_setup(room, **setup_kw)
    log(t0, f"synthetic room: {len(room['coord'])} points")
    main_batch = main_path_batch(setup[1])
    small = small_batch(room)
    rows = kernel_phase(model, [main_batch, small], t0, device)
    log(t0, "kernel phase done")

    (result, votes, n_views), slice_launches = _drive(
        SLICE_KERNELS, lambda: run_slice(device, seed, model=model, setup=setup))
    check_votes(votes, n_views)
    scene = result["scenes"][0]
    caps = sorted({tuple(model.backbone.stage_capacities(n))
                   for _, n in scene["batches"]})
    print(f"slice: {scene['fragments']} fragments in batches (B, N) "
          f"{scene['batches']}; stage capacities {caps}", flush=True)
    print(f"slice: launches {slice_launches}; scene {scene['seconds']:.2f} s; "
          f"mIoU {result['mIoU']:.4f} allAcc {result['allAcc']:.4f} "
          f"(random weights)", flush=True)
    log(t0, "slice phase done")
    print(json.dumps({"forward_profile": dict(
        profile_forward(model, main_batch, device), card=card)}), flush=True)
    del model
    torch.cuda.empty_cache()
    log(t0, "forward profile done")

    rooms = [make_room(s, size) for s, size in TRAIN_ROOMS]
    workdir, options = train_setup(rooms, max_steps=train_steps, seed=seed)
    log(t0, f"train rooms: {[len(r['coord']) for r in rooms]} points")
    trainer = build_trainer(
        options + [f"save_path={os.path.join(workdir, 'exp_kernels')}"], device)
    it = iter(trainer.train_loader)
    train_batch = next(it)
    del it
    _, coord, feat, mask = small
    small_train = dict(coord=coord, feat=feat, mask=mask,
                       segment=torch.where(mask, 0, -1).to(torch.int32))
    rows += train_kernel_phase(trainer, [("train phase's batch", train_batch),
                                         ("small batch", small_train)], t0)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "train kernel phase done")

    torch.cuda.reset_peak_memory_stats()
    trainer, train_launches = _drive(TRAIN_KERNELS,
                                     lambda: run_train(device, options))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    changed, n_params = check_train(trainer, train_steps)
    hist = trainer.history
    step_s = float(np.median([r["step_seconds"] for r in hist[1:]]))
    print(f"train: (B, N) {tuple(train_batch['mask'].shape)} points/step "
          f"{[r['points'] for r in hist]}", flush=True)
    print(f"train: losses {[round(r['loss'], 5) for r in hist]} grad_norms "
          f"{[round(r['grad_norm'], 4) for r in hist]} pool_overflow "
          f"{[r['pool_overflow'] for r in hist]}", flush=True)
    print(f"train: step seconds {[round(r['step_seconds'], 4) for r in hist]}"
          f" (median of steps 2-{train_steps}: {step_s:.4f} s), data wait "
          f"{[round(r['data_seconds'], 4) for r in hist]}; peak memory "
          f"{peak_gb:.2f} GiB; {changed}/{n_params} parameter tensors changed;"
          f" launches {train_launches} ({train_steps} steps); card {card}",
          flush=True)
    log(t0, "train phase done")
    print(json.dumps({"train_step_profile": dict(
        profile_train_step(trainer, train_batch), card=card)}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    log(t0, "train-step profile done")

    # one entry per kernel: its heaviest captured shape
    kernels = []
    for name, info in KERNEL_INFO.items():
        row = max((r for r in rows if r["name"] == name),
                  key=lambda r: r["bound_ms"])
        by_path = {"test": slice_launches[name], "train": train_launches[name]}
        kernels.append(dict(
            name=name, **info, launches=sum(by_path.values()),
            launches_by_path=by_path,
            launches_per_train_step=train_launches[name] / train_steps,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=f"{row['phase']}: {row['shape']}"))
    return kernels


def main():
    parser = argparse.ArgumentParser(description="port smoke run on one card")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # a healthy run takes a minute or two: a hang becomes a traceback
    # and a non-zero exit well inside any caller's time limit
    faulthandler.dump_traceback_later(280, exit=True)
    t0 = time.perf_counter()
    from ao_tpu_torch.ops import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    _native.lib()
    built = _native.build_seconds
    log(t0, f"kernels built: one nvcc call, {built:.1f} s" if built is not None
        else f"kernels reused from {_native.BUILD_DIR}")

    kernels = run(torch.device("cuda"), args.seed, t0, card=card)
    faulthandler.cancel_dump_traceback_later()
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
