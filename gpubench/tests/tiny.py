"""Tiny CPU versions of the cells for the benchmark's tests: narrow widths
(the published depths and grid sizes), two scenes a batch, a few small
rooms, no loader workers."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {"model.backbone.patch_embed_channels": 16,
        "model.backbone.patch_embed_groups": 2,
        "model.backbone.enc_channels": (16, 32, 64),
        "model.backbone.enc_groups": (2, 4, 8),
        "model.backbone.dec_channels": (16, 16, 32),
        "model.backbone.dec_groups": (2, 2, 4),
        "batch_size": 2, "num_worker": 0, "max_points": 4096,
        "pad_multiple": 512}
TINY_SCANNET = dict(TINY, **{
    "model.backbone.enc_depths": (1, 1, 1, 1),
    "model.backbone.enc_channels": (16, 32, 32, 64),
    "model.backbone.enc_groups": (2, 4, 4, 8),
    "model.backbone.dec_channels": (16, 16, 32, 32),
    "model.backbone.dec_groups": (2, 2, 4, 4),
    "max_points": 6144})


def traffic(name, **rooms):
    with open(os.path.join(ROOT, "gpubench", "traffic", name + ".json")) as f:
        t = json.load(f)
    t = copy.deepcopy(t)
    t["rooms"].update(rooms)
    t["loop"] = 10
    return t


CELLS = {
    "s3dis-ptv2m2.train": (TINY, traffic("s3dis-rooms.train", count=4,
                                         spacing=0.12)),
    "scannet-ptv2m2.train": (TINY_SCANNET, traffic("scannet-rooms.train",
                                                   count=4, spacing=0.1)),
}


def run_cell(cell, seed=7, seconds=0.0, trace=0):
    """(exit code, result) of one CPU run of a tiny ``cell``."""
    import io
    from contextlib import redirect_stdout

    from gpubench.harness import core

    overrides, t = CELLS[cell]
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = core.main(["--workload", cell, "--seed", str(seed), "--seconds",
                          str(seconds), "--trace", str(trace)],
                         require_card=False, device="cpu",
                         overrides=overrides, traffic=t)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return code, (json.loads(lines[-1]) if lines else None)
