"""Self-supervised pretraining entry point (MSC).

    python -m ao_tpu_torch.tools.train_pretrain \
        --config-file configs/scannet/pretrain-msc-v1m1-0-spunet-base.py \
        --options save_path=<dir> data.train.data_root=<dir> \
        [max_steps=<n>] [--device cpu]

Runs on the card unless ``--device cpu`` is given. Each step encodes both
views of every scene and takes the MSC loss (masked-scene InfoNCE over
matched pairs, colour and normal reconstruction); there is no evaluation.
``main`` returns the trainer.
"""

from __future__ import annotations

from ..engines.train_pretrain import PretrainTrainer
from .train import run


def main(argv=None):
    return run(PretrainTrainer, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    main()
