"""K6 (`gva_bwd`) against its plain version on random graphs at the train
steps' shapes.

    python -m ao_tpu_torch.tools.check_gva_bwd [--seeds 0 1 2 3] [--time]

``chip_smoke.py`` holds K6 against ``gva_bwd_plain`` on the graphs of its
own synthetic rooms; this check adds random window graphs at the same
shapes (B=3 at the four stage sizes of an 81920-point batch, and the
gathered C=384 stage of a small batch) and at the ScanNet config's new
ones (its patch embed, S=8 at C=48 on B=4 x 102400, and its gathered C=512
stage), one per seed, where a gate
t > 0 that falls the other way from the plain version's shows as a dq
error of several percent of scale (the band is 1e-2). For the first seed
it also checks what K6's exact gates rely on: that the plain version's
f32 products equal a sequential FMA chain bit for bit. With ``--time`` it
times K6 per launch (CUDA events) instead. Prints one JSON object per
line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import gva as tg

# (B, N, C, S): the S3DIS train step's stages at B=3 x 81920 and the small
# batch's gathered C=384 stage, as chip_smoke.py captures them; the ScanNet
# config's patch embed (S=8) and gathered C=512 stage at B=4
SHAPES = ((3, 81920, 48, 16), (3, 28672, 96, 16), (3, 10035, 192, 16),
          (3, 3512, 384, 16), (2, 702, 384, 16), (4, 102400, 48, 8),
          (4, 1600, 512, 16))


def random_graph(seed, B, N, C, device, S=16):
    """Rows, ids and folded parameters of a random window graph (every key
    within 64 rows of its query), S slots, G = C / 8."""
    G = C // 8
    rng = np.random.default_rng(seed)

    def f(*s, m=1.0):
        return torch.from_numpy((rng.normal(size=s) * m).astype(np.float32))

    coord = torch.from_numpy(rng.uniform(0, 4, (B, N, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((B, N)) < 0.97)
    src = torch.cat([f(B, N, C, m=0.5).bfloat16(), f(B, N, C, m=0.5).bfloat16(),
                     tg.pack_coords(coord)], -1)
    qrow = torch.cat([f(B, N, C, m=0.5).bfloat16(), tg.pack_coords(coord),
                      mask[..., None].bfloat16()], -1)
    near = np.arange(N)[None, :, None] + rng.integers(-64, 64, (B, N, S))
    idx = torch.from_numpy(np.clip(near, 0, N - 1).astype(np.int32))
    valid = torch.from_numpy(rng.random((B, N, S)) < 0.9) & mask[..., None]
    fp = dict(A=f(3, C, m=2.0), cA=f(C, m=0.1), Wp2=f(C, C, m=C ** -0.5),
              bp2=f(C, m=0.1), W1f=f(C, G, m=C ** -0.5), b1f=f(G, m=0.1),
              W2=f(G, G, m=G ** -0.5), b2=f(G, m=0.1))
    dout = f(B, N, C)
    return (src.to(device), qrow.to(device), idx.to(device), valid.to(device),
            {k: v.to(device) for k, v in fp.items()}, dout.to(device))


def chain_agreement(src, qrow, idx, valid, fp):
    """Share of the plain version's peb, bf16(relation) and t that equal a
    sequential f32 FMA chain over k bit for bit (each product of two bf16
    values is exact in f32, so a multiply-add pair is one FMA), and the
    number of gates t > 0 on which the two differ."""
    env = tg._recompute(src, qrow, idx, valid, fp["A"], fp["cA"], fp["Wp2"],
                        fp["bp2"], fp["W1f"], fp["b1f"])
    C = qrow.shape[-1] - 7
    pe1, Wp2, W1 = tg._bf(env["pe1"]), tg._bf(fp["Wp2"]), tg._bf(fp["W1f"])
    acc = torch.zeros_like(env["peb"])
    for k in range(C):
        acc = acc + pe1[..., k:k + 1] * Wp2[k]
    peb = acc + fp["bp2"]
    rows = tg.grouping(src, idx.clamp(0, src.shape[1] - 1)).float()
    rb = tg._bf(rows[..., :C] - qrow.float()[:, :, None, :C] + peb)
    acc = torch.zeros_like(env["t"])
    for c in range(C):
        acc = acc + rb[..., c:c + 1] * W1[c]
    t = (acc + fp["b1f"]) * env["vf"]
    return dict(peb_equal=float((env["peb"] == peb).float().mean()),
                relation_equal=float((tg._bf(env["r"]) == rb).float().mean()),
                t_equal=float((env["t"] == t).float().mean()),
                gates_differ=int(((env["t"] > 0) != (t > 0)).sum()))


def k6_ms(args, reps=20):
    for _ in range(3):
        tg.gva_bwd(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        tg.gva_bwd(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--time", action="store_true")
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_gva_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ok = True
    for B, N, C, S in SHAPES:
        for i, seed in enumerate(a.seeds):
            args = random_graph(seed * 1000 + C, B, N, C, dev, S)
            row = dict(B=B, N=N, C=C, S=S, seed=seed)
            if a.time:
                row["ms"] = k6_ms(args)
                print(json.dumps(row), flush=True)
                continue
            if i == 0:
                row.update(chain_agreement(*args[:5]))
            dkv, dq = tg.gva_bwd(*args)[:2]
            pdkv, pdq = tg.gva_bwd_plain(*args)[:2]
            row["dq"] = float((dq - pdq).abs().max() / pdq.abs().max())
            row["dkv"] = float((dkv - pdkv).abs().max() / pdkv.abs().max())
            row["ok"] = row["dq"] <= 1e-2 and row["dkv"] <= 1e-2
            ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
            del args, dkv, dq, pdkv, pdq
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("check_gva_bwd: K6 outside the 1e-2 band")


if __name__ == "__main__":
    main()
