"""PP2S offline preprocessing CLI (port of tools/pp2s.py; reference: the
my_*_final.py scripts, SURVEY.md §3.5). Runs one stage or all of them.

    python -m ao_tpu_torch.tools.pp2s --data-root <dir> --sam-oracle \
        --frame-size 512 --bridge-depth-thresh 0.02 --stage render_frames
    python -m ao_tpu_torch.tools.pp2s --data-root <dir> --sam-oracle \
        --frame-size 512 --bridge-depth-thresh 0.02 --stage all

The neural SAM's image encoder runs on ``--device`` (the card by
default); the other stages and the oracle run on the host. ``main``
returns the pipeline, whose ``stage_seconds`` holds each stage's seconds.
"""

from __future__ import annotations

import argparse

from ..pp2s import PP2SPipeline
from ..pp2s.pipeline import AREAS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", default="data")
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--sam-model-type", default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b", "tiny"])
    p.add_argument(
        "--stage", default="all",
        choices=["render_frames", "embeddings", "bridges", "weak_labels",
                 "basket", "sam_labels", "all"],
    )
    p.add_argument("--areas", nargs="+", default=None)
    p.add_argument(
        "--frame-size", type=int, default=1080,
        help="frame pixel size for SAM prompt mapping (512 for the "
        "render_frames variant's synthetic views)",
    )
    p.add_argument(
        "--sam-oracle", action="store_true",
        help="no-checkpoint mode: stage 1 rasterises GT instance-id maps "
        "and stage 5 decodes oracle masks from them (models/sam/oracle.py)",
    )
    p.add_argument("--oracle-quality", type=float, default=0.7)
    p.add_argument(
        "--render-views", type=int, default=6,
        help="horizontal viewpoints for the render_frames stage (two "
        "vertical views are always added)",
    )
    p.add_argument(
        "--bridge-depth-thresh", type=float, default=0.1,
        help="visibility depth test (reference 0.1 m; 0.02 for the "
        "synthetic proxy whose splat depth is exact — see pipeline)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the neural SAM (default: the card)")
    args = p.parse_args(argv)
    pipe = PP2SPipeline(
        data_root=args.data_root,
        sam_checkpoint=args.sam_checkpoint,
        sam_model_type=args.sam_model_type,
        areas=tuple(args.areas) if args.areas else AREAS,
        sam_oracle=args.sam_oracle,
        oracle_quality=args.oracle_quality,
        bridge_depth_thresh=args.bridge_depth_thresh,
        device=args.device,
    )
    fs = (args.frame_size, args.frame_size)
    if args.stage == "all":
        pipe.run_all(frame_size=fs)
    elif args.stage == "sam_labels":
        pipe.run_stage("sam_labels", frame_size=fs)
    elif args.stage == "render_frames":
        pipe.run_stage("render_frames", views=args.render_views,
                       size=args.frame_size)
    else:
        pipe.run_stage(args.stage)
    return pipe


if __name__ == "__main__":
    main()
