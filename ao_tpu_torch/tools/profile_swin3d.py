"""Device time by kernel of Swin3D's cRSE window attention, forward and
backward.

    python -m ao_tpu_torch.tools.profile_swin3d [--rows 12500] [--dim 48]
        [--window 5] [--fill 11]

Builds WindowAttentionCRSE (6 heads, xyz + rgb + norm, quant 4; random
weights from seed 0) over ``--rows`` window rows of 64 slots, the first
``--fill`` of each valid (stage 0 of the ScanNet Swin3D config holds 10-11
points a window over about 12500 occupied rows a scene: the defaults),
with xyz signals spread over the window and colour / normal signals in
[-1, 1]. Traces 2 passes of forward and backward (the gradient of sum(out
* r)) with torch.profiler, after one untraced pass. Prints one JSON
object: the wall ms and device ms a pass, the device's 15 heaviest kernels
(ms a pass, launches a pass) and the peak memory. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models.swin3d.swin3d import WindowAttentionCRSE
from ..utils.devtime import trace

HEADS, REPS = 6, 2


def inputs(rows, dim, window, fill, device):
    """(x, sig, valid, r) of ``rows`` windows of 64 slots."""
    g = torch.Generator(device="cpu").manual_seed(0)
    S = 64
    x = torch.randn(rows, S, dim, generator=g)
    xyz = torch.rand(rows, S, 3, generator=g) * window
    rest = torch.rand(rows, S, 6, generator=g) * 2 - 1
    valid = (torch.arange(S) < fill).expand(rows, S).clone()
    r = torch.randn(rows, S, dim, generator=g)
    return [t.to(device) for t in (x, torch.cat([xyz, rest], -1), valid, r)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=12500)
    parser.add_argument("--dim", type=int, default=48)
    parser.add_argument("--window", type=int, default=5)
    parser.add_argument("--fill", type=int, default=11)
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_swin3d needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    torch.manual_seed(0)
    attn = WindowAttentionCRSE(a.dim, HEADS, a.window, 4,
                               ("xyz", "rgb", "norm")).to(dev)
    x, sig, valid, r = inputs(a.rows, a.dim, a.window, a.fill, dev)
    x.requires_grad_()

    def step():
        (attn(x, sig, valid) * r).sum().backward()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_ms, device_ms, _, ev = trace(step, REPS, warmup=0)
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), rows=a.rows, heads=HEADS,
        dim=a.dim, window=a.window, fill=a.fill, wall_ms=wall_ms,
        device_ms=device_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        top=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3 / REPS,
                  launches=e.count / REPS) for e in ev[:15]])))


if __name__ == "__main__":
    main()
