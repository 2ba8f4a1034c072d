"""K1 (`knn_window`) against its plain version on random clouds at every
(tile_q, window, k) of the S3DIS and ScanNet paths.

    python -m ao_tpu_torch.tools.check_knn_window [--seeds 0 1 2 3] [--time]

``chip_smoke.py`` holds K1 against ``knn_window_plain`` on the graphs of
its own synthetic rooms; this check builds K1's inputs through the port's
own graph functions (so window starts, padding and penalties are the
path's) on four kinds of cloud, one per seed:

* ``clustered``: points on random planar patches (as a scan of an indoor
  room), Morton-sorted by the graph functions;
* ``lattice``: coordinates on a 0.25 m lattice with repeated points, so
  every score is exact in f32 and exact ties between valid keys abound;
* ``sparse``: the clustered inputs with 97% of the keys made invalid, so
  many windows hold fewer than k valid keys and some hold none;
* ``pad``: batches whose rows keep 65536-90112 valid points of 90112, as
  the test slice's largest batch pads its fragments: whole tiles of pad
  queries whose windows hold only invalid keys.

Self graphs of the slab path (B=8 x 90112: (tile_q, window) = (128, 640),
(128, 512), (64, 512); k=16, and k=8 at (128, 640) for the ScanNet patch
embed), the unpool cross probe (B=8, 90112 queries over 31616 keys:
(512, 640), k=3) and the gathered stages' 3-probe self graph (B=2 x 2048:
(256, 1152); B=2 x 702: (256, 702); k=16 and 8). Required at every case:
scores within 1e-5 x max(|plain score|, 1) (the band of ``chip_smoke.py``);
ids equal to the plain version's except where two keys' scores lie within
that band of each other (the kernel's fused multiply-adds round apart from
the plain matmul); on lattice clouds, where both are exact, every id equal
(ties: the lowest window column, the plain version's stable sort); and at
every slot whose score is the invalid keys' 1e30, the same id (the lowest
columns of the window's invalid keys). With ``--time`` it also prints K1's
device time per launch (torch.profiler) and the wrapper's (CUDA events) at
the first seed of each kind. Prints one JSON object per line; needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import knn_spatial as ks
from ..utils.devtime import device_ms

KINDS = ("clustered", "lattice", "sparse", "pad")
_BIG = 1e30


def cloud(kind, B, N, gen, device):
    """(coord (B, N, 3) f32, mask (B, N)) of one kind of cloud."""
    if kind == "lattice":
        coord = torch.randint(0, 24, (B, N, 3), generator=gen).float() * 0.25
    else:
        # points on 64 random planar patches of a 6 x 5 x 3 m room
        P = 64
        center = torch.rand((B, P, 3), generator=gen) * torch.tensor([6.0, 5.0, 3.0])
        axes = torch.nn.functional.normalize(torch.randn((B, P, 2, 3), generator=gen), dim=-1)
        size = 0.3 + 1.2 * torch.rand((B, P, 2), generator=gen)
        pid = torch.randint(0, P, (B, N), generator=gen)
        uv = (torch.rand((B, N, 2), generator=gen) - 0.5) * torch.gather(
            size, 1, pid[..., None].expand(B, N, 2))
        ax = torch.gather(axes, 1, pid[..., None, None].expand(B, N, 2, 3))
        coord = (torch.gather(center, 1, pid[..., None].expand(B, N, 3))
                 + (uv[..., None] * ax).sum(2)
                 + 0.003 * torch.randn((B, N, 3), generator=gen))
    mask = torch.ones((B, N), dtype=torch.bool)
    if kind == "pad":
        lo = N * 8 // 11  # 65536 of 90112
        n_valid = torch.randint(lo, N + 1, (B,), generator=gen)
        n_valid[0] = lo
        mask = torch.arange(N)[None] < n_valid[:, None]
        coord = torch.where(mask[..., None], coord, 0.0)
    return coord.to(device), mask.to(device)


def captured(fn):
    """The argument tuples of every K1 call ``fn`` makes."""
    calls = []
    orig = ks.knn_window

    def rec(*args):
        calls.append(args)
        return orig(*args)

    rec.launches = 0  # the wrapper counts on the module attribute
    ks.knn_window = rec
    try:
        fn()
    finally:
        ks.knn_window = orig
    return calls


def _sorted(coord, mask):
    order = torch.argsort(ks.morton_code(coord, mask), dim=1, stable=True)
    return (torch.gather(coord, 1, order[..., None].expand(-1, -1, 3)),
            torch.gather(mask, 1, order))


def cases(kind, seed, device, B=8, N=90112):
    """(name, K1 arguments) of every (tile_q, window, k) of the path, built
    through the port's graph functions on one cloud of ``kind`` (B x N)."""
    gen = torch.Generator().manual_seed(seed)
    coord, mask = cloud(kind, B, N, gen, device)
    sc, sm = _sorted(coord, mask)
    out = []
    # self graphs of the slab stages: C <= 96, C = 192, C = 384
    for k, tile_q, window, front in ((16, 128, 640, 256), (16, 128, 512, 192),
                                     (16, 64, 512, 224), (8, 128, 640, 256)):
        out += captured(lambda: ks.knn_self_presorted(
            sc, sm, k=k, tile_q=tile_q, window=window, front=front))
    # unpool: the fine cloud's points over a third of them (one probe)
    kc, km = coord[:, ::3].contiguous(), mask[:, ::3].contiguous()
    out += captured(lambda: ks._window_probe(coord, kc, mask, km, 3, 512, 512,
                                             0.0, False))
    # gathered stages: one probe of the 3-probe self graph
    for n in (2048, 702):
        c2, m2 = coord[:2, :n].contiguous(), mask[:2, :n].contiguous()
        for k in (16, 8):
            out += captured(lambda: ks._window_probe(c2, c2, m2, m2, k, 256,
                                                     1024, 0.0, True))
    if kind == "sparse":
        # 97% of the keys invalid: windows with fewer than k valid keys
        sparse = []
        for args in out:
            keys, k2 = args[:2]
            drop = torch.rand(k2.shape, generator=gen).to(device) < 0.97
            drop &= k2 < _BIG / 2
            sparse.append((keys, torch.where(drop, k2 + _BIG, k2), *args[2:]))
        out = sparse
    return [(describe(a), a) for a in out]


def describe(args):
    keys, _, _, q, _, k, tile_q, window = args
    return (f"B={q.shape[0]} Nq={q.shape[1]} Nk={keys.shape[1]} k={k} "
            f"tile_q={tile_q} window={window}")


def compare(args, out_k, out_p, exact):
    """Holds K1's (d2, idx) against the plain version's; returns a dict of
    the largest error and the counts of each kind of disagreement."""
    keys, k2, order, q, ws, k, tile_q, window = args
    (dk, ik), (dp, ip) = out_k, out_p
    tol = 1e-5 * torch.clamp_min(dp.abs(), 1.0)
    err = (dk - dp).abs()
    bad_d2 = int((err > tol).sum())
    diff = ik != ip
    res = dict(max_abs_err=float(err.max()), bad_d2=bad_d2,
               ids_differ=int(diff.sum()), invalid_slots=int((dp > _BIG / 2).sum()))
    b, n, j = diff.nonzero(as_tuple=True)
    # a differing id must name a key of the tile's window whose plain score
    # lies within the band of the plain version's score at that slot
    Nk = keys.shape[1]
    start = ws.long().clamp(0, Nk - window)
    flat_order = order.reshape(-1)
    near = torch.zeros_like(b, dtype=torch.bool)
    for lo in range(0, len(b), 100000):  # bounded memory: (chunk, window)
        bb, nn, jj = b[lo:lo + 100000], n[lo:lo + 100000], j[lo:lo + 100000]
        cols = (start[bb, nn // tile_q][:, None]
                + torch.arange(window, device=ws.device))
        hit = flat_order[bb[:, None] * Nk + cols] == ik[bb, nn, jj][:, None]
        col = cols.gather(1, hit.float().argmax(1, keepdim=True))[:, 0]
        s_hit = k2[bb, col] - 2.0 * (q[bb, nn] * keys[bb, col]).sum(-1)
        near[lo:lo + 100000] = hit.any(1) & (
            (s_hit - dp[bb, nn, jj]).abs() <= tol[bb, nn, jj])
    invalid_slot = dp[b, n, j] > _BIG / 2
    res.update(ids_differ_not_near_tie=int((~near).sum()),
               ids_differ_at_invalid=int(invalid_slot.sum()))
    res["ok"] = (bad_d2 == 0 and res["ids_differ_not_near_tie"] == 0
                 and res["ids_differ_at_invalid"] == 0
                 and (not exact or res["ids_differ"] == 0))
    return res


def wrapper_ms(fn, reps=10):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--kinds", nargs="+", default=list(KINDS))
    parser.add_argument("--time", action="store_true")
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_knn_window: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ok = True
    for kind in a.kinds:
        for seed in a.seeds:
            for name, args in cases(kind, seed, dev):
                with torch.inference_mode():
                    out_k = ks.knn_window(*args)
                    out_p = ks.knn_window_plain(*args)
                    row = dict(kind=kind, seed=seed, shape=name,
                               **compare(args, out_k, out_p, kind == "lattice"))
                    if a.time and seed == a.seeds[0]:
                        row["device_ms"] = device_ms(
                            lambda: ks.knn_window(*args), "knn_window")
                        row["wrapper_ms"] = wrapper_ms(
                            lambda: ks.knn_window(*args))
                ok = ok and row["ok"]
                print(json.dumps(row), flush=True)
                del out_k, out_p
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("check_knn_window: K1 disagrees with its plain version")


if __name__ == "__main__":
    main()
