"""PointBatchNorm's autograd function (``ops/point_bn.py``) on the CPU.

Its plain forward against the PyTorch composite it replaced (copied below
as the reference: the two-pass masked statistics, the running update, the
cast, and the ReLU that followed at most call sites), bit for bit in the
output, the running statistics and ``num_batches_tracked``, in f32 and
bf16, with a mask, without one and with every row masked, train and eval
mode, the ReLU fused or not; its hand-written backward against autograd
through the composite, and by ``gradcheck`` in f64; a PT-v2m2 block
sequence under ``enable_checkpoint``, whose running statistics update once;
the launch geometry the wrapper hands the card's kernels; and the hold
that ``chip_smoke.py`` makes of them on the card (capture, forward and
backward on copies, the comparison), here with the CPU path in the
kernels' place. The kernels themselves run on the card only.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from ao_tpu_torch.models.point_transformer_v2 import ptv2m2 as tm
from ao_tpu_torch.models.utils import PointBatchNorm
from ao_tpu_torch.ops import point_bn as pb


def composite(bn, x, mask, training, relu):
    """PointBatchNorm's forward before its kernels, and the ReLU after it."""
    n = bn
    xf = x.float()
    if training:
        dims = tuple(range(x.dim() - 1))
        if mask is None:
            cnt = torch.tensor(float(xf[..., 0].numel()), device=x.device)
            mean = xf.mean(dims)
            var = ((xf - mean) ** 2).mean(dims)
        else:
            m = mask.float()[..., None]
            cnt = torch.clamp_min(m.sum(), 1.0)
            mean = (xf * m).sum(dims) / cnt
            var = (((xf - mean) ** 2) * m).sum(dims) / cnt
        with torch.no_grad():
            unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
            n.running_mean.mul_(1 - n.momentum).add_(n.momentum * mean.detach())
            n.running_var.mul_(1 - n.momentum).add_(n.momentum * unbiased.detach())
            n.num_batches_tracked += 1
    else:
        mean, var = n.running_mean, n.running_var
    y = (xf - mean) * torch.rsqrt(var + n.eps)
    y = y * n.weight + n.bias
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    y = y.to(x.dtype)
    return torch.relu(y) if relu else y


def _case(dtype, mask_kind, seed=0, shape=(2, 37), C=12):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=shape + (C,)) * 1.5 + 0.4)
                         .astype(np.float32)).to(dtype)
    mask = {"mask": torch.from_numpy(rng.random(shape) < 0.7),
            "none": None,
            "all": torch.zeros(shape, dtype=torch.bool)}[mask_kind]
    bn = PointBatchNorm(C, momentum=0.1)

    def f(a):
        return torch.from_numpy(a.astype(np.float32))

    with torch.no_grad():
        bn.norm.weight.copy_(f(rng.normal(1, 0.3, C)))
        bn.norm.bias.copy_(f(rng.normal(0, 0.3, C)))
        bn.norm.running_mean.copy_(f(rng.normal(0, 1, C)))
        bn.norm.running_var.copy_(f(rng.uniform(0.5, 2, C)))
    return x, mask, bn, f(rng.normal(size=shape + (C,))).to(dtype)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["norelu", "relu"])
@pytest.mark.parametrize("mask_kind", ["mask", "none", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_matches_the_composite(dtype, mask_kind, relu, training):
    """The output, the running mean and variance and num_batches_tracked
    equal the composite's bit for bit (an all-masked batch counts n = 1);
    the input and affine gradients of the written-out backward equal
    autograd's through the composite within 1e-6 of scale in f32 (the
    sums' order differs) and one bf16 rounding in bf16."""
    x, mask, mine, g = _case(dtype, mask_kind)
    ref = PointBatchNorm(x.shape[-1])
    ref.load_state_dict(mine.state_dict())
    mine.train(training)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = mine(xa, mask, relu=relu)
    yb = composite(ref.norm, xb, mask, training, relu)
    assert ya.dtype == dtype
    assert torch.equal(ya, yb)
    for key, value in ref.state_dict().items():
        assert torch.equal(mine.state_dict()[key], value), key
    assert int(mine.norm.num_batches_tracked) == int(training)
    ya.backward(g)
    yb.backward(g)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    for a, b in ((xa.grad, xb.grad), (mine.norm.weight.grad, ref.norm.weight.grad),
                 (mine.norm.bias.grad, ref.norm.bias.grad)):
        assert a.dtype == b.dtype
        scale = max(float(b.float().abs().max()), 1.0)
        assert float((a.float() - b.float()).abs().max()) <= tol * scale
    if mask_kind == "all":
        assert not ya.any() and not xa.grad.any()


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("relu", [False, True], ids=["norelu", "relu"])
def test_backward_gradcheck_f64(training, relu):
    """The hand-written backward (the plain version of the card's two
    backward kernels) by finite differences in f64, masked: dx, dweight,
    dbias, train mode (the statistics' terms) and eval mode."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 5)) * 1.5 + 0.3).requires_grad_()
    mask = torch.from_numpy(rng.random((2, 9)) < 0.75)
    bn = torch.nn.BatchNorm1d(5).double().train(training)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 2.0)
    w = torch.from_numpy(rng.normal(1, 0.3, 5)).requires_grad_()
    b = torch.from_numpy(rng.normal(0, 0.3, 5)).requires_grad_()

    def f(x, w, b):
        return pb._PointBatchNorm.apply(x, w, b, mask, bn, training, relu)

    assert torch.autograd.gradcheck(f, (x, w, b), eps=1e-6, atol=1e-7)


def test_checkpointed_blocks_update_the_running_statistics_once(monkeypatch):
    """A PT-v2m2 block sequence in bf16 on the card's train path (slab
    graph, the GVA kernels' plain versions) under enable_checkpoint: the
    output and every gradient equal the sequence without it bit for bit;
    each PointBatchNorm ran twice a block (the forward and its
    recomputation) and its running statistics and num_batches_tracked
    equal the sequence's without checkpointing (one update)."""
    n, C, G, S = 256, 48, 6, 8
    rng = np.random.default_rng(0)
    coord = torch.from_numpy(rng.uniform(0, 2, (2, n, 3)).astype(np.float32))
    feat = torch.from_numpy((rng.normal(size=(2, n, C)) * 0.5).astype(np.float32))
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[1, n - 7:] = False
    r = torch.from_numpy(rng.normal(size=(2, n, C)).astype(np.float32))
    calls = [0]
    plain = pb.point_batch_norm_plain
    monkeypatch.setattr(pb, "point_batch_norm_plain", lambda *a: (
        calls.__setitem__(0, calls[0] + 1), plain(*a))[1])
    geom = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)
    results = []
    for ckpt in (False, True):
        calls[0] = 0
        torch.manual_seed(0)
        seq = tm.BlockSequence(2, C, G, S, enable_checkpoint=ckpt,
                               dtype=torch.bfloat16).train()
        out, _ = seq(feat, coord, mask, force=dict(slab=geom, fused=True))
        (out * r).sum().backward()
        results.append((out.detach(), {k: p.grad for k, p in seq.named_parameters()},
                        seq.state_dict(), calls[0]))
    (o0, g0, s0, c0), (o1, g1, s1, c1) = results
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    tracked = [k for k in s0 if k.endswith("num_batches_tracked")]
    assert len(tracked) == 2 * 5 + 2 * 2  # 5 PointBatchNorms a block, 2 in its GVA
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
        if k.endswith("num_batches_tracked"):
            assert int(s1[k]) == 1, k
    assert (c0, c1) == (2 * 5, 2 * 2 * 5)


@pytest.mark.parametrize("vec", [True, False], ids=["vector", "scalar"])
def test_launch_geometry(monkeypatch, vec):
    """The grid the wrapper gives the kernels for every width up to 1024
    (multiples of 8 on the vector path): at most 32 threads a row's tile,
    tiles of equal lanes that cover every chunk, a channel tile of at most
    256 channels (the backward's prologue reduces twice a tile's channels
    with its 512 threads), at least one row a block, one block an SM over
    the tiles, and no more row strips than rows."""
    monkeypatch.setattr(pb, "_sm_count", lambda device: 132)
    widths = range(8, 1025, 8) if vec else range(1, 1025)
    for C in widths:
        chunks = C // 8 if vec else C
        for R in (1, 100, 983040):
            lanes, gx = pb._geometry(C, vec, R, None)
            tiles = -(-chunks // lanes)
            assert 1 <= lanes <= pb._MAX_LANES
            assert tiles * lanes >= chunks > (tiles - 1) * lanes
            assert lanes * (8 if vec else 1) <= 256
            rows = pb._THREADS // lanes
            assert rows >= 1
            assert 1 <= gx * tiles <= 132 + tiles
            assert (gx - 1) * rows < R


def _faulty_scale(x, mask, bn, training, relu=False):
    return pb.point_batch_norm(x, mask, bn, training, relu) * 1.05


def _faulty_stats(x, mask, bn, training, relu=False):
    frozen = torch.nn.BatchNorm1d(bn.num_features)
    frozen.load_state_dict(bn.state_dict())
    return pb.point_batch_norm_plain(x, mask, bn.weight, bn.bias, frozen,
                                     training, relu)[0]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_chip_smoke_holds_each_width_on_copies(training):
    """chip_smoke.py's hold of PointBatchNorm with the CPU path in the
    kernels' place: a block sequence's forward (and backward in train mode;
    eval under inference mode, as the tester runs) captured counts every
    call and keeps the first of each width and kind, with the module's
    statistics from before the call; each held forward and backward runs on
    copies (the model's state untouched) and passes against the
    composite; an output 5% off and a running update left out fail."""
    n, C, G, S = 256, 48, 6, 8
    rng = np.random.default_rng(1)
    coord = torch.from_numpy(rng.uniform(0, 2, (2, n, 3)).astype(np.float32))
    feat = torch.from_numpy((rng.normal(size=(2, n, C)) * 0.5).astype(np.float32))
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[1, n - 7:] = False
    torch.manual_seed(0)
    seq = tm.BlockSequence(2, C, G, S, dtype=torch.bfloat16).train(training)
    geom = dict(TQ=32, J=5, W=64, tile_q=64, window=128, front=32)
    before = {k: v.clone() for k, v in seq.state_dict().items()}
    seen = []
    cap = chip_smoke.Capture().wrap_path(chip_smoke.BN_KERNELS)
    try:
        from ao_tpu_torch.models import utils as model_utils

        held = model_utils.point_batch_norm

        def spy(*args):
            seen.append(chip_smoke._bn_key(*args))
            return held(*args)

        model_utils.point_batch_norm = spy
        if training:
            out, _ = seq(feat, coord, mask, force=dict(slab=geom, fused=True))
            out.float().sum().backward()
        else:
            with torch.inference_mode():
                seq(feat, coord, mask, force=dict(slab=geom, fused=True))
    finally:
        model_utils.point_batch_norm = held
        cap.restore()
    assert cap.counts["point_bn"] == len(seen) == 2 * 5
    assert {k[1:] for k in cap.calls} == set(seen)
    assert len(cap.calls) == len(set(seen))
    after = {k: v.clone() for k, v in seq.state_dict().items()}
    for name, fn, args in cap.calls.values():
        assert name == "point_bn"
        x, m, bn, mode = args[:4]
        assert mode == training and x.shape[-1] == C
        assert int(bn.num_batches_tracked) == 0  # the state before the call
        assert "vector" in chip_smoke.describe(name, args)
        with torch.inference_mode():
            ref = chip_smoke.point_bn_run(chip_smoke.point_bn_plain, *args)
            ok = chip_smoke.check_point_bn(
                args, chip_smoke.point_bn_run(fn, *args), ref)[0]
            assert ok
            assert int(ref[6]) == int(training)
            assert ref[1].shape == x.shape and ref[2].shape == (C,)
            for fault in (_faulty_scale, _faulty_stats):
                got = chip_smoke.point_bn_run(fault, *args)
                caught = not chip_smoke.check_point_bn(args, got, ref)[0]
                assert caught or (fault is _faulty_stats and not training)
    for k, v in seq.state_dict().items():
        assert torch.equal(v, after[k]), k
    tracked = [k for k in before if k.endswith("num_batches_tracked")]
    assert all(int(after[k]) == int(training) for k in tracked)


def test_chip_smoke_output_gradient_skips_undecided_gates():
    """The hold's output gradient (chip_smoke.point_bn_grad) is 0 exactly
    at the valid rows' elements whose ReLU input lies within BN_UNDECIDED
    of its terms' size of 0, in train mode (batch statistics) and eval mode (running ones), and
    everywhere else the seeded draw (a constant channel is undecided
    throughout, a normal one at about 1e-4 of its elements); without the
    ReLU it is the draw."""
    x, mask, mod, _ = _case(torch.float32, "mask", seed=4, shape=(3, 200), C=8)
    bn = mod.norm
    with torch.no_grad():
        x[..., 0] = 2.5  # a constant channel: in train mode t is its bias, 0
        bn.bias[0] = 0.0
    draw = chip_smoke.point_bn_grad(x, mask, bn, True, relu=False)
    assert (draw != 0).all()
    for training in (True, False):
        g = chip_smoke.point_bn_grad(x, mask, bn, training, relu=True)
        xd, m = x.double(), mask[..., None].double()
        n = m.sum()
        if training:
            mean = (xd * m).sum((0, 1)) / n
            var = (((xd - mean) ** 2) * m).sum((0, 1)) / n
        else:
            mean, var = bn.running_mean.double(), bn.running_var.double()
        rstd = torch.rsqrt(var + bn.eps)
        w, b = bn.weight.double(), bn.bias.double()
        t = (xd - mean) * rstd * w + b
        size = ((xd.abs() + (xd.abs() * m).sum((0, 1)) / n + mean.abs())
                * rstd * w.abs() + b.abs())
        undecided = ((t.abs() <= chip_smoke.BN_UNDECIDED * size)
                     & mask[..., None])
        assert torch.equal(g == 0, undecided)
        assert torch.equal(g[~undecided], draw[~undecided])
        if training:
            assert undecided[..., 0][mask].all()
        assert float(undecided[..., 1:].double().mean()) < 1e-3
