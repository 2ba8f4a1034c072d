"""Smoke run of the PyTorch / CUDA port (ao_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc; exits non-zero without them. Reads nothing
under data/ or exp/: the scene is synthetic and the weights are random.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the kernels (one nvcc call over csrc/*.cu).
2. Kernel phase: PT-v2m2 at the full width of
   configs/s3dis/semseg-pt-v2m2-0-base.py, random weights from the seed,
   runs the slice phase's own largest batch (8 distinct fragments of the
   synthetic room, padded as the tester pads them) and a small batch of
   two room pieces padded to 16384, whose deep stages fall below the
   2048-point slab gate. The inputs of every kernel call with a new shape
   are captured; each kernel is then held against its plain PyTorch
   version on them and timed (CUDA events, after warm-up) beside the
   plain version, a library call where one computes the same function,
   and its bound.
3. Slice phase: runs whole-scene testing of the same room through the
   port's entry point (ao_tpu_torch.tools.test) with the config's 10 TTA
   views, then checks that every point received finite votes from every
   view.
4. Times the largest batch's forward again and traces it with
   torch.profiler (device time by kernel, busy share).

The last three lines are the card, the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
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
        replaces="ao_tpu/ops/pallas/gva_slab.py:432 + "
                 "ao_tpu/ops/pallas/gva_fused.py:419"),
}

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


def describe(name, args):
    if name == "knn_window":
        keys, _, _, q, _, k, tile_q, window = args
        return (f"B={q.shape[0]} Nq={q.shape[1]} Nk={keys.shape[1]} k={k} "
                f"tile_q={tile_q} window={window}")
    if name == "merge_topk":
        d2, _, k = args
        return f"B={d2.shape[0]} N={d2.shape[1]} width={d2.shape[2]} k={k}"
    src, qrow, idx, _, fp = args
    mode = "slab" if src.shape[1] >= 2048 else "gathered"
    return (f"B={idx.shape[0]} N={idx.shape[1]} S={idx.shape[2]} "
            f"C={qrow.shape[-1] - 7} G={fp['W2'].shape[0]} mode={mode}")


def kernel_phase(model, batches, t0, device):
    """Run the model once on each (label, coord, feat, mask) batch with the
    kernel wrappers captured, then hold each kernel against its plain
    version on every captured (kernel, shape) and time both."""
    from ao_tpu_torch.ops import gva as gva_mod
    from ao_tpu_torch.ops import knn_spatial as ks
    from ao_tpu_torch.models.point_transformer_v2 import ptv2m2

    plain = {"knn_window": ks.knn_window_plain,
             "merge_topk": ks.merge_topk_plain,
             "gva_eval": gva_mod.gva_eval_plain}
    checks = {"knn_window": check_knn_window,
              "merge_topk": check_merge_topk,
              "gva_eval": check_gva_eval}
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

    rows, failures = [], []
    for key, (name, fn, args) in cap.calls.items():
        with torch.inference_mode():
            out_k = fn(*args)
            out_p = plain[name](*args)
            torch.cuda.synchronize()
            ok, err, bound_ms, by, lib_ms, note = checks[name](args, out_k, out_p)
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: plain[name](*args), reps=3, warmup=1)
        row = dict(name=name, shape=describe(name, args), ok=ok,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=lib_ms, note=note)
        rows.append(row)
        print(f"  {name:11s} {row['shape']:58s} ok={ok} err={err:.3g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
              f"({by}) library_ms={lib_ms} {note}", flush=True)
        if not ok:
            failures.append(row["shape"])
        del out_k, out_p
        torch.cuda.empty_cache()
    print(json.dumps({"kernel_shapes": rows}), flush=True)
    missing = set(plain) - {r["name"] for r in rows}
    if missing:
        raise RuntimeError(f"kernels never called on the path: {sorted(missing)}")
    if not any("mode=gathered" in r["shape"] for r in rows):
        raise RuntimeError("gva_eval was not exercised in its gathered mode")
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
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
                busy_share=device_ms / wall_ms, top=top)


def run(device, seed, t0, room_size=(4.8, 4.0, 2.6), **setup_kw):
    """The kernel phase on the slice's largest batch and a small batch,
    then the slice phase with the launch counts set to 0 just before it
    and read just after; returns the kernels' record."""
    from ao_tpu_torch.models import build_model
    from ao_tpu_torch.ops import gva, knn_spatial
    from ao_tpu_torch.utils import Config

    cfg = Config.fromfile(BASE_CONFIG)
    torch.manual_seed(seed)
    model = build_model(dict(cfg.model)).to(device).eval()
    room = make_room(seed, room_size)
    setup = slice_setup(room, **setup_kw)
    log(t0, f"synthetic room: {len(room['coord'])} points")
    main_batch = main_path_batch(setup[1])
    rows = kernel_phase(model, [main_batch, small_batch(room)], t0, device)
    log(t0, "kernel phase done")

    wrappers = {"knn_window": knn_spatial.knn_window,
                "merge_topk": knn_spatial.merge_topk,
                "gva_eval": gva.gva_eval}
    for w in wrappers.values():
        w.launches = 0
    result, votes, n_views = run_slice(device, seed, model=model, setup=setup)
    launches = {n: w.launches for n, w in wrappers.items()}
    check_votes(votes, n_views)
    scene = result["scenes"][0]
    caps = sorted({tuple(model.backbone.stage_capacities(n))
                   for _, n in scene["batches"]})
    print(f"slice: {scene['fragments']} fragments in batches (B, N) "
          f"{scene['batches']}; stage capacities {caps}", flush=True)
    print(f"slice: launches {launches}; scene {scene['seconds']:.2f} s; "
          f"mIoU {result['mIoU']:.4f} allAcc {result['allAcc']:.4f} "
          f"(random weights)", flush=True)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    log(t0, "slice phase done")
    print(json.dumps({"forward_profile": profile_forward(
        model, main_batch, device)}), flush=True)
    log(t0, "forward profile done")

    # one entry per kernel: its heaviest captured shape
    kernels = []
    for name, info in KERNEL_INFO.items():
        row = max((r for r in rows if r["name"] == name),
                  key=lambda r: r["bound_ms"])
        kernels.append(dict(
            name=name, **info, launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"]))
    return kernels


def main():
    parser = argparse.ArgumentParser(description="port smoke run on one card")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # a healthy run takes under a minute: a hang becomes a traceback
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

    kernels = run(torch.device("cuda"), args.seed, t0)
    faulthandler.cancel_dump_traceback_later()
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
