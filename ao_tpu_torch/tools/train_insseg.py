"""Instance segmentation training entry point (PointGroup).

    python -m ao_tpu_torch.tools.train_insseg \
        --config-file configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py \
        --options save_path=<dir> data.train.data_root=<dir> \
        data.val.data_root=<dir> [max_steps=<n>] [--device cpu]

Runs on the card unless ``--device cpu`` is given. The trainer's step is
the PointGroup loss (CE and the offsets' L1 and cosine terms); each epoch
ends with the config's InsSegEvaluator (proposals clustered on the host,
ScanNet-protocol mAP / AP50 / AP25 over ``data.val``). ``main`` returns
the trainer.
"""

from __future__ import annotations

from ..engines import InsSegTrainer
from .train import run


def main(argv=None):
    return run(InsSegTrainer, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
