"""K3 (`gva_eval`) against its plain version on random graphs at the shapes
of both slices.

    python -m ao_tpu_torch.tools.check_gva_eval [--seeds 0 1 2 3] [--time]

``chip_smoke.py`` holds K3 against ``gva_eval_plain`` on the graphs of its
own synthetic rooms; this check adds the random window graphs of
``check_gva_bwd.random_graph`` (about 10% of the slots invalid, 3% of the
queries masked), one per seed and shape, at the train step's shapes
(B=3 at the four stage sizes of an 81920-point batch), the test slice's
largest batch (B=8 at the four stage sizes of a 90112-point batch) and
the gathered C=384 stage of a small batch (B=2, N=702), in a band of
5e-3 of the output's scale, as ``chip_smoke.py`` holds it. In every case
one query has no valid slot (its output must be 0), and at most stage
sizes the last tile of queries is ragged. With ``--time`` it also
times K3 per launch (CUDA events) and prints the blocks per SM of each
width. Prints one JSON object per line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import _native
from ..ops import gva as tg
from .check_gva_bwd import SHAPES as TRAIN_SHAPES
from .check_gva_bwd import random_graph

# the test slice's largest batch (B=8 x 90112): patch embedding / decoder
# C=48, then the encoder stages
TEST_SHAPES = ((8, 90112, 48), (8, 31539, 96), (8, 11038, 192), (8, 3863, 384))
SHAPES = TRAIN_SHAPES + TEST_SHAPES


def k3_ms(args, reps=20):
    for _ in range(3):
        tg.gva_eval(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        tg.gva_eval(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def blocks_per_sm(C):
    n = ctypes.c_int(0)
    _native.check(_native.lib().gva_eval_blocks_per_sm(C, ctypes.byref(n)),
                  "gva_eval")
    return n.value


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--time", action="store_true")
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_gva_eval: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if a.time:
        print(json.dumps({"blocks_per_sm": {C: blocks_per_sm(C)
                                            for C in tg.GVA_WIDTHS}}), flush=True)
    ok = True
    for B, N, C in SHAPES:
        for seed in a.seeds:
            src, qrow, idx, valid, fp, _ = random_graph(seed * 1000 + C, B, N, C,
                                                        dev)
            valid[-1, N // 2] = False  # a query with no valid slot
            args = (src, qrow, idx, valid, fp)
            out = tg.gva_eval(*args)
            ref = tg.gva_eval_plain(*args)
            torch.cuda.synchronize()
            scale = max(float(ref.abs().max()), 1.0)
            err = float((out - ref).abs().max())
            row = dict(B=B, N=N, C=C, seed=seed, err_over_scale=err / scale,
                       empty_query_zero=bool((out[-1, N // 2] == 0).all()))
            row["ok"] = err < 5e-3 * scale and row["empty_query_zero"]
            if a.time:
                row["ms"] = k3_ms(args)
            ok = ok and row["ok"]
            print(json.dumps(row), flush=True)
            del args, src, qrow, idx, valid, fp, out, ref
            torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("check_gva_eval: K3 outside the 5e-3 band")


if __name__ == "__main__":
    main()
