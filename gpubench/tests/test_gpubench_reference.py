"""The reference against the port's CPU path at a tiny width: the same
weights and inputs give the same logits (eval and train mode), loss and
first gradients, within float32 rounding of sums taken in another order."""

import pytest
import torch

from ao_tpu_torch.models import build_model
from ao_tpu_torch.utils import Config
from gpubench.harness.core import Cell, load_bench
from gpubench.harness.weights import load_weights, make_weights
from gpubench.reference.ptv2m2 import (ReferencePTv2, cross_entropy,
                                       load_program_state)
from gpubench.tests.tiny import CELLS


def _cloud(B, N, n_valid, seed):
    g = torch.Generator().manual_seed(seed)
    coord = torch.rand(B, N, 3, generator=g) * torch.tensor([4.0, 3.0, 2.5])
    feat = torch.cat([coord, torch.rand(B, N, 3, generator=g)], -1)
    mask = torch.zeros(B, N, dtype=torch.bool)
    for b, n in enumerate(n_valid):
        mask[b, :n] = True
    coord = torch.where(mask[..., None], coord, 0.0)
    return coord, feat, mask


def _models(cell):
    overrides, _ = CELLS[cell]
    cfg = Config.fromfile(Cell(load_bench(), cell).config_file)
    cfg.merge_from_dict(dict(overrides, **{"model.backbone.compute_dtype": None,
                                           "model.backbone.drop_path_rate": 0.0}))
    prog = build_model(dict(cfg.model))
    weights = make_weights(prog, 3, torch.device("cpu"))
    load_weights(prog, weights)
    ref = load_program_state(
        ReferencePTv2(cfg.model.backbone, on_card=False), weights)
    return cfg, prog, ref


@pytest.mark.parametrize("cell", ["s3dis-ptv2m2.train", "scannet-ptv2m2.train"])
@pytest.mark.parametrize("train", [False, True])
def test_gpubench_reference_logits_match_the_port(cell, train):
    torch.set_num_threads(2)
    cfg, prog, ref = _models(cell)
    in_ch = cfg.model.backbone.in_channels
    coord, feat, mask = _cloud(2, 1536, (1536, 1100), 5)
    feat = torch.cat([feat, feat[..., :in_ch - 6]], -1)[..., :in_ch]
    prog.train(train)
    ref.train(train)
    a = prog(coord, feat, mask)
    b = ref(coord, feat, mask)
    scale = float(b.detach()[mask].abs().max())
    assert float((a - b)[mask].abs().max()) <= 1e-4 * scale
    if train:
        seg = torch.randint(0, cfg.model.backbone.num_classes, mask.shape,
                            generator=torch.Generator().manual_seed(1))
        la, lb = cross_entropy(a, seg, mask), cross_entropy(b, seg, mask)
        assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(lb))
        la.backward()
        lb.backward()
        ga = {n[len("backbone."):]: p.grad.norm() for n, p in
              prog.named_parameters()}
        gb = {n: p.grad.norm() for n, p in ref.named_parameters()}
        med = torch.stack(list(gb.values())).median()
        for n in gb:
            assert float((ga[n] - gb[n]).abs()) <= 1e-2 * float(max(gb[n], med)), n
