"""Device time and kernel launches of one test forward and one train step.

    python -m ao_tpu_torch.tools.profile_path [--reps 3] [--seed 0]

Run from the root of a checkout (it imports that checkout's
``chip_smoke.py`` for its synthetic rooms). Builds PT-v2m2 at the full
width of configs/s3dis/semseg-pt-v2m2-0-base.py with random weights, then
traces with torch.profiler ``--reps`` eval forwards of the test slice's
largest batch (B=8 x 90112) and ``--reps`` train steps of the train
batch (B=3 x 81920): per forward and per step, the device ms and the
device launches in all and of each port kernel, and the wall ms. The
functions it calls are the ones every version of the port has had since
its train slice, so the same file measures an older checkout too. Prints
one JSON object; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import build_model
from ..utils import Config

# substrings of the port kernels' names (K6's sums pass counts with K6)
PORT_KERNELS = ("knn_window", "merge_topk", "gva_eval", "gva_pos",
                "gva_stats", "gva_bwd")


def traced(fn, reps):
    """(wall ms, device ms, launches, {port kernel: launches}) per call of
    ``fn`` over ``reps`` traced calls, after one untraced call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    ev = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    return dict(
        wall_ms=wall,
        device_ms=sum(e.self_device_time_total for e in ev) / 1e3 / reps,
        launches=sum(e.count for e in ev) / reps,
        port_launches={n: sum(e.count for e in ev if n in e.key) / reps
                       for n in PORT_KERNELS})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_path: needs a CUDA card")
    import chip_smoke  # the checkout's own, from its root

    dev = torch.device("cuda")
    torch.manual_seed(a.seed)
    model = build_model(dict(Config.fromfile(chip_smoke.BASE_CONFIG).model))
    model = model.to(dev).eval()
    setup = chip_smoke.slice_setup(chip_smoke.make_room(a.seed))
    _, coord, feat, mask = chip_smoke.main_path_batch(setup[1])
    c, f, m = coord.to(dev), feat.to(dev), mask.to(dev)
    with torch.inference_mode():
        fwd = traced(lambda: model(c, f, m), a.reps)
    del model
    torch.cuda.empty_cache()

    rooms = [chip_smoke.make_room(s, size) for s, size in chip_smoke.TRAIN_ROOMS]
    _, options = chip_smoke.train_setup(rooms, max_steps=1, seed=a.seed)
    trainer = chip_smoke.build_trainer(options, dev)
    batch = next(iter(trainer.train_loader))
    step = traced(lambda: float(trainer.train_step(batch)["loss"]), a.reps)
    print(json.dumps(dict(forward=dict(shape=list(mask.shape), **fwd),
                          train_step=dict(shape=list(batch["mask"].shape),
                                          **step))), flush=True)


if __name__ == "__main__":
    main()
