"""Self-supervised pretraining, MSC (port of ao_tpu/engines/train_pretrain.py).

The MSC model takes two augmented views of each scene (the
ContrastiveViewsGenerator transform's ``view1_*`` / ``view2_*`` keys) and
returns its losses, so the step feeds both views and backpropagates the
model's ``loss``, reporting its NCE, colour and normal terms, the mean
positive similarity and the matched pairs; the model's random draws come
from the trainer's generator. The collate pads each view on its own
(:func:`view_collate_fn`: the views hold different numbers of points).
There is no validation loader; loaders, optimizer, schedule, hooks and
checkpoints are the semantic trainer's, as the reference runs MSC on its
plain Trainer (configs/scannet/pretrain-msc-v1m1-0-spunet-base.py).
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from ..datasets.collate import PAD_KEYS, _ceil_to, pad_to
from .train import Trainer

VIEWS = ("view1", "view2")


def view_collate_fn(samples, pad_multiple=1024):
    """Pad every view's per-point arrays to its own capacity (its largest
    count rounded up to ``pad_multiple``) and stack them into CPU tensors,
    with a ``<view>_mask`` each; ``<view>_discrete_coord`` stays int32, the
    rest is float32."""
    out = {}
    for view in VIEWS:
        counts = [s[f"{view}_coord"].shape[0] for s in samples]
        n_max = _ceil_to(max(counts), pad_multiple)
        mask = np.zeros((len(samples), n_max), bool)
        for i, c in enumerate(counts):
            mask[i, :c] = True
        out[f"{view}_mask"] = torch.from_numpy(mask)
        for key in samples[0]:
            if not key.startswith(view + "_"):
                continue
            dtype = PAD_KEYS.get(key[len(view) + 1:], np.float32)
            arrs = [np.asarray(s[key], dtype) for s in samples]
            if all(a.ndim >= 1 and a.shape[0] == c for a, c in zip(arrs, counts)):
                out[key] = torch.from_numpy(np.stack([pad_to(a, n_max) for a in arrs]))
    return out


class PretrainTrainer(Trainer):
    """Trainer whose step feeds both views into an MSC-style model."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.model.generator = self.generator
        self._inputs = set(inspect.signature(self.model.forward).parameters)

    def build_val_loader(self):
        return None  # pretraining has no per-epoch evaluation

    def _collate(self, mix_prob=0.0, generator=None):
        return functools.partial(view_collate_fn,
                                 pad_multiple=self.cfg.get("pad_multiple", 4096))

    def _masks(self, batch):
        return [batch[f"{v}_mask"] for v in VIEWS]

    def _loss(self, batch):
        out = self.model(**{k: v.to(self.device, non_blocking=True)
                            for k, v in batch.items() if k in self._inputs})
        terms = {k: v.detach() for k, v in out.items()
                 if k.endswith("_loss") or k in ("pos_sim", "pairs")}
        return out["loss"], None, terms
