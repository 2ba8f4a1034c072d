"""Pseudo-label quality evaluation CLI (port of tools/evaluate_labels.py;
reference: engines/my_evaluate.py).

    python -m ao_tpu_torch.tools.evaluate_labels <pred_root> --data-root <dir>

Runs on the host. ``main`` returns the metrics dict.
"""

from __future__ import annotations

import argparse

from ..engines.label_eval import TRAIN_AREAS, get_miou


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pred_root", help="dir of <area>/<room>.npy pseudo-labels")
    p.add_argument("--data-root", default="data/s3dis")
    p.add_argument("--num-classes", type=int, default=13)
    p.add_argument("--areas", nargs="+", default=list(TRAIN_AREAS))
    p.add_argument("--device", default="cuda",
                   help="accepted like the other entry points; the "
                   "evaluation runs on the host")
    args = p.parse_args(argv)
    m = get_miou(
        args.pred_root, args.data_root, args.num_classes,
        areas=tuple(args.areas),
    )
    print(
        f"mIoU {m['mIoU']:.4f}  mPrecision {m['mPrecision']:.4f}  "
        f"mRecall {m['mRecall']:.4f}  ({m['num_scenes']} scenes)"
    )
    return m


if __name__ == "__main__":
    main()
