"""PointBatchNorm's computation (``models/utils.py``) as one autograd
function over the kernels of ``csrc/point_bn.cu``.

:func:`point_batch_norm` normalises x (..., C) over its rows: in train mode
with the batch statistics of the valid rows of ``mask`` (every row when
None), n = max(sum m, 1), mean = sum m x / n, var = sum m (x - mean)^2 / n
(two passes, f32), updating the BatchNorm1d's running mean, unbiased
running variance and ``num_batches_tracked`` in place; in eval mode with
the running statistics. y = (x - mean) * rsqrt(var + eps) * weight + bias
at the valid rows, 0 at the others, in x's type, and with ``relu`` the
ReLU of that. The backward is written out
(:func:`point_batch_norm_backward_plain`): autograd keeps x, the mask, and
the mean and rstd (C floats each), and no f32 copy of the activation. The
CPU runs the written-out backward too, not autograd through the plain
forward: it is the formula of the card's two backward kernels, which the
CPU tests hold by gradcheck where the kernels cannot run, and under a
process group it makes the card's one collective a backward (the sums of
g' and g' xhat) where autograd would make two (the backward of each
forward all-reduce), so that the CPU's two-process tests run the card's
scheme.

CPU tensors run the plain versions; CUDA tensors (bf16 or f32, f32
parameters and statistics) launch the kernels or raise: three launches a
train-mode forward, one an eval-mode forward, two a backward, counted in
``point_batch_norm.launches``. Under a process group the statistics are the
global batch's: two collectives forward ([sum x | n], then the squared
deviations), one backward (the sums of g' and g' xhat, as SyncBatchNorm's);
the parameter gradients stay per process, for the train step's reduction.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import comm
from . import _native

# csrc/point_bn.cu's block: threads, and the threads a row's tile at most
_THREADS = 512
_MAX_LANES = 32
_SMS = {}


@torch.no_grad()
def update_running_stats(bn: torch.nn.BatchNorm1d, mean, var, n, momentum=0.1):
    """torch's BatchNorm1d running update from a batch's mean, biased
    variance and count: the variance enters unbiased, n / max(n - 1, 1)."""
    unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
    bn.running_mean.mul_(1 - momentum).add_(momentum * mean.detach())
    bn.running_var.mul_(1 - momentum).add_(momentum * unbiased.detach())
    bn.num_batches_tracked += 1


def _compute_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


def _moments(xf, mask, dims):
    """(mean, biased variance, count) over ``dims`` at the valid rows; under
    a process group over every process (two collectives)."""
    if comm.is_distributed():
        return comm.global_moments(xf, mask, dims)
    if mask is None:
        cnt = torch.tensor(float(xf[..., 0].numel()), dtype=xf.dtype,
                           device=xf.device)
        mean = xf.mean(dims)
        return mean, ((xf - mean) ** 2).mean(dims), cnt
    m = mask.to(xf.dtype)[..., None]
    cnt = torch.clamp_min(m.sum(), 1.0)
    mean = (xf * m).sum(dims) / cnt
    return mean, (((xf - mean) ** 2) * m).sum(dims) / cnt, cnt


def point_batch_norm_plain(x, mask, weight, bias, bn, training, relu=False):
    """(y, mean, rstd, n): the forward in PyTorch ops, in f32 (f64 for f64
    inputs); n is None in eval mode."""
    xf = x.to(_compute_dtype(x))
    if training:
        mean, var, cnt = _moments(xf, mask, tuple(range(x.dim() - 1)))
        update_running_stats(bn, mean, var, cnt, bn.momentum)
    else:
        mean, var, cnt = bn.running_mean.clone(), bn.running_var, None
    rstd = torch.rsqrt(var + bn.eps)
    y = (xf - mean) * rstd
    y = y * weight + bias
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    y = y.to(x.dtype)
    return (torch.relu(y) if relu else y), mean, rstd, cnt


def point_batch_norm_backward_plain(g, x, mask, weight, bias, mean, rstd, n,
                                    training, relu=False):
    """(dx, dweight, dbias) of :func:`point_batch_norm_plain`'s y for the
    output gradient g, written out; under a process group the input
    gradient takes the global sums (one collective)."""
    cdt = _compute_dtype(x)
    xf, gf = x.to(cdt), g.to(cdt)
    xhat = (xf - mean) * rstd
    if relu:
        gf = torch.where((xhat * weight + bias).to(x.dtype) > 0, gf, 0.0)
    if mask is not None:
        gf = torch.where(mask[..., None], gf, 0.0)
    dims = tuple(range(x.dim() - 1))
    db, dw = gf.sum(dims), (gf * xhat).sum(dims)
    scale = weight * rstd
    if training:
        s = comm.all_reduce(torch.cat([db, dw]))
        C = x.shape[-1]
        dx = scale * (gf - (s[:C] + xhat * s[C:]) / n)
        if mask is not None:
            dx = torch.where(mask[..., None], dx, 0.0)
    else:
        dx = scale * gf
    return dx.to(x.dtype), dw, db


def _sm_count(device) -> int:
    if device not in _SMS:
        props = torch.cuda.get_device_properties(device)
        _SMS[device] = props.multi_processor_count
    return _SMS[device]


def _geometry(C, vec, R, device):
    """(lanes, grid x) of a launch over R rows of width C: a row's chunks (8
    channels on the vector path, 1 otherwise) split into as few equal
    channel tiles of at most 32 chunks as they can, and a grid of one block
    an SM over the tiles and the row strips."""
    chunks = C // 8 if vec else C
    tiles = -(-chunks // _MAX_LANES)
    lanes = -(-chunks // tiles)
    rows = _THREADS // lanes
    return lanes, max(1, min(-(-_sm_count(device) // tiles), -(-R // rows)))


def _vector(C, *tensors):
    return C % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _global_rows(part):
    """A launch's partial rows summed (f64) over the blocks and over every
    process, as one f32 row."""
    rows = part.sum(0, keepdim=True, dtype=torch.float64)
    return comm.all_reduce(rows).float()


def _check(x, mask, weight, bias, bn):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"point_batch_norm: x must be float32 or bfloat16 on "
                         f"the card, not {x.dtype}")
    C = x.shape[-1]
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != tuple(x.shape[:-1])):
        raise ValueError(f"point_batch_norm: mask must be bool of shape "
                         f"{tuple(x.shape[:-1])}")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", bn.running_mean),
                    ("running_var", bn.running_var)):
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise ValueError(f"point_batch_norm: {name} must be float32 of "
                             f"shape ({C},)")
    _native.require_cuda("point_batch_norm", x, weight, bias, bn.running_mean,
                         bn.running_var, bn.num_batches_tracked,
                         *(() if mask is None else (mask,)))


def _forward(x, mask, weight, bias, bn, training, relu):
    """(y, stats = [mean (C) | rstd (C) | n]) on the card."""
    _check(x, mask, weight, bias, bn)
    C = x.shape[-1]
    R = x.numel() // C
    vec = _vector(C, x)
    lanes, gx = _geometry(C, vec, R, x.device)
    lib, st = _native.lib(), _native.stream_ptr(x)
    mp = None if mask is None else mask.data_ptr()
    shape = (R, C, int(x.dtype == torch.bfloat16), int(vec), lanes, gx)
    y = torch.empty_like(x)
    stats = torch.empty(2 * C + 1, dtype=torch.float32, device=x.device)
    sq, nrow = stats, 0
    if training:
        part = torch.empty((gx, C + 1), dtype=torch.float32, device=x.device)
        _native.check(lib.point_bn_sum_launch(
            x.data_ptr(), mp, part.data_ptr(), *shape, st), "point_bn_sum")
        if comm.is_distributed():
            part = _global_rows(part)
        sq = torch.empty((gx, C), dtype=torch.float32, device=x.device)
        _native.check(lib.point_bn_sqdev_launch(
            x.data_ptr(), mp, part.data_ptr(), sq.data_ptr(), stats.data_ptr(),
            part.shape[0], *shape, st), "point_bn_sqdev")
        if comm.is_distributed():
            sq = _global_rows(sq)
        nrow = sq.shape[0]
    m = bn.momentum
    _native.check(lib.point_bn_norm_launch(
        x.data_ptr(), mp, sq.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
        bn.num_batches_tracked.data_ptr(), y.data_ptr(), nrow, *shape,
        int(training), int(relu), bn.eps, m, 1 - m, st), "point_bn_norm")
    point_batch_norm.launches += 3 if training else 1
    return y, stats


def _backward(g, x, mask, weight, bias, stats, training, relu):
    """(dx, dweight, dbias) on the card."""
    C = x.shape[-1]
    R = x.numel() // C
    g = g.to(x.dtype).contiguous()
    vec = _vector(C, x, g)
    lanes, gx = _geometry(C, vec, R, x.device)
    lib, st = _native.lib(), _native.stream_ptr(x)
    mp = None if mask is None else mask.data_ptr()
    shape = (R, C, int(x.dtype == torch.bfloat16), int(vec), lanes, gx)
    part = torch.empty((gx, 2 * C), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), mp, g.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), bias.data_ptr())
    _native.check(lib.point_bn_bwd_sums_launch(
        *ptrs, part.data_ptr(), *shape, int(relu), st), "point_bn_bwd_sums")
    dx = torch.empty_like(x)
    if training and comm.is_distributed():
        local = part.sum(0, dtype=torch.float64)
        db, dw = local[:C].float(), local[C:].float()
        part = comm.all_reduce(local[None]).float()
        out = (None, None)
    else:
        dw = torch.empty(C, dtype=torch.float32, device=x.device)
        db = torch.empty(C, dtype=torch.float32, device=x.device)
        out = (dw.data_ptr(), db.data_ptr())
    _native.check(lib.point_bn_bwd_dx_launch(
        *ptrs, part.data_ptr(), *out, dx.data_ptr(), part.shape[0], *shape,
        int(training), int(relu), st), "point_bn_bwd_dx")
    point_batch_norm.launches += 2
    return dx, dw, db


class _PointBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, bn, training, relu):
        if x.device.type == "cpu":
            y, mean, rstd, n = point_batch_norm_plain(x, mask, weight, bias,
                                                      bn, training, relu)
            stats = (mean, rstd, n)
        else:
            x = x.contiguous()
            mask = None if mask is None else mask.contiguous()
            y, stats = _forward(x, mask, weight, bias, bn, training, relu)
            stats = (stats,)
        ctx.save_for_backward(x, mask, weight, bias, *stats)
        ctx.training, ctx.relu = training, relu
        return y

    @staticmethod
    def backward(ctx, g):
        x, mask, weight, bias, *stats = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, db = point_batch_norm_backward_plain(
                g, x, mask, weight, bias, *stats, ctx.training, ctx.relu)
        else:
            dx, dw, db = _backward(g, x, mask, weight, bias, stats[0],
                                   ctx.training, ctx.relu)
        return dx, dw, db, None, None, None, None


def point_batch_norm(x: torch.Tensor, mask: Optional[torch.Tensor],
                     bn: torch.nn.BatchNorm1d, training: bool,
                     relu: bool = False) -> torch.Tensor:
    """``bn``'s normalisation of x (..., C) over the valid rows of ``mask``
    ((...) bool, or None), with the ReLU after it when ``relu``; see the
    module's docstring."""
    return _PointBatchNorm.apply(x, bn.weight, bn.bias, mask, bn, training,
                                 relu)


point_batch_norm.launches = 0
