"""Weights made from the run's seed, on the device, in one draw.

Every parameter follows PyTorch's default initialisation of its layer: a
Linear's weight and bias uniform in +-1/sqrt(fan_in), a BatchNorm's scale 1
and shift 0; the running statistics keep their initial mean 0 and variance
1. One uniform draw of all the parameters' elements from a generator on
the device, seeded by the run, is scaled leaf by leaf. The same tensors go
to the program and to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def weight_seed(seed):
    return int(np.random.SeedSequence([seed, 2]).generate_state(1)[0])


def make_weights(model, seed, device):
    """{name: tensor} for every parameter of ``model`` (float32 on
    ``device``)."""
    params = list(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params}
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device)
    g.manual_seed(weight_seed(seed))
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, o = {}, 0
    for name, p in params:
        x = u[o:o + p.numel()].view(p.shape)
        o += p.numel()
        if name.endswith("norm.weight"):
            out[name] = torch.ones_like(x)
        elif name.endswith("norm.bias"):
            out[name] = torch.zeros_like(x)
        else:
            wname = name[:-len("bias")] + "weight" if name.endswith("bias") else name
            fan_in = shapes[wname][1] if len(shapes[wname]) > 1 else shapes[wname][0]
            out[name] = x * (1.0 / math.sqrt(fan_in))
    return out


@torch.no_grad()
def load_weights(model, weights):
    """Copy ``weights`` into the model's parameters in place (an optimizer
    built on them keeps its references)."""
    for name, p in model.named_parameters():
        p.copy_(weights[name])
