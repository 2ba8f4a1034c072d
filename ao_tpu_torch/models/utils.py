"""Shared model building blocks (port of ao_tpu/models/utils.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.point_bn import point_batch_norm


class PointBatchNorm(nn.Module):
    """BatchNorm over points for padded batches. Train mode normalises with
    the batch statistics of the valid rows (the padded batch's translation
    of the reference's BatchNorm1d over ragged points) and updates the
    running mean and the running variance, the latter unbiased, with
    ``momentum`` (torch's: the batch statistic's weight; 0.1 by default);
    eval mode normalises with the running statistics. Padded
    rows come out zero. ``relu=True`` applies the ReLU that follows the
    norm at most call sites inside the same computation (the card's kernels
    fuse it). ``norm`` is a BatchNorm1d so that parameter names
    follow the reference (``<name>.norm.weight`` ...). Under a process
    group the statistics are the global batch's, as the JAX package's are
    over its data mesh axis. The computation is
    :func:`~ao_tpu_torch.ops.point_bn.point_batch_norm`: hand-written
    kernels on the card, its plain version on the CPU."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.norm = nn.BatchNorm1d(features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                relu: bool = False):
        return point_batch_norm(x, mask, self.norm, self.training, relu)


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode. The keep
    draws come from ``generator`` (a ``torch.Generator`` on the tensor's
    device; the device's default generator when None)."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)


class Dropout(nn.Module):
    """Elementwise dropout (the TPU package's flax ``nn.Dropout``): train
    mode keeps each element with probability 1 - rate, scaled by
    1 / (1 - rate); the identity in eval mode or at rate 0. The keep draws
    come from ``generator`` as in :class:`DropPath`."""

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias in ``dtype`` when given (the
    TPU package's Dense(dtype=...)), else in f32."""
    dt = dtype or torch.float32
    b = None if layer.bias is None else layer.bias.to(dt)
    return nn.functional.linear(x.to(dt), layer.weight.to(dt), b)


class ClassifierHead(nn.Module):
    """Linear(256)-BN-ReLU-Dropout(0.5), Linear(128)-BN-ReLU-Dropout(0.5),
    Linear(num_classes) over a (B, C) embedding (the PT-v1 classifier's
    head and DefaultClassifier's)."""

    def __init__(self, in_features: int, num_classes: int, dropout: float = 0.5):
        super().__init__()
        self.cls_fc1 = nn.Linear(in_features, 256)
        self.cls_bn1 = PointBatchNorm(256)
        self.cls_drop1 = Dropout(dropout)
        self.cls_fc2 = nn.Linear(256, 128)
        self.cls_bn2 = PointBatchNorm(128)
        self.cls_drop2 = Dropout(dropout)
        self.cls_out = nn.Linear(128, num_classes)

    def forward(self, x):
        x = self.cls_drop1(torch.relu(self.cls_bn1(self.cls_fc1(x))))
        x = self.cls_drop2(torch.relu(self.cls_bn2(self.cls_fc2(x))))
        return self.cls_out(x)


# elements of one chunk of the per-row histograms of the position table's
# gradient (:func:`_table_grad`)
TABLE_HIST_ELEMENTS = 2**26


def table_bins(offsets: torch.Tensor, length: int) -> torch.Tensor:
    """(..., A) integer bins of a table of ``A x length`` rows, axis a's
    bins ``offsets[..., a] + a * length`` (offsets already in [0, length)),
    as the smallest integer type that holds them (uint8 up to 256 rows)."""
    A = offsets.shape[-1]
    flat = offsets + torch.arange(A, device=offsets.device) * length
    return flat.to(torch.uint8 if A * length <= 256 else torch.int16)


def _table_bias(bins, table):
    """The relative-position bias of attention logits from a learned (L, H)
    table at integer bins (R, Q, K, A), each axis's bins offset into its own
    rows of the table (:func:`table_bins`): (R, H, Q, K) sum over the axes
    of table[bins[..., a]] (a view)."""
    tt = table.t()  # (H, L)
    bias = tt[:, bins[..., 0].long()]
    for a in range(1, bins.shape[-1]):
        bias += tt[:, bins[..., a].long()]
    return bias.transpose(0, 1)


def _table_grad(bins, dbias, table_shape):
    """The (L, H) table's gradient of :func:`_table_bias` from the bias's
    (R, H, Q, K): added into histograms of each row (``scatter_add_``) and
    summed, a chunk of rows at a time. Adding every pair straight into the
    (L, H) table piles all atomics onto a few addresses. A histogram is
    kept per query where the table has no more rows than a query has keys
    (L <= K: then it is no larger than the logits), else per row."""
    L, H = table_shape
    R, Q, K, A = bins.shape
    per_query = L <= K
    dtable = dbias.new_zeros((H, L))
    rows = max(TABLE_HIST_ELEMENTS // (H * (Q if per_query else 1) * L), 1)
    for r0 in range(0, R, rows):
        g = dbias[r0:r0 + rows]
        rc = g.shape[0]
        if not per_query:
            g = g.reshape(rc, H, 1, Q * K)
        hist = g.new_zeros((rc, H, g.shape[2], L))
        for a in range(A):
            idx = bins[r0:r0 + rows, ..., a].long().reshape(rc, 1, g.shape[2], -1)
            hist.scatter_add_(3, idx.expand(-1, H, -1, -1), g)
        dtable += hist.sum((0, 2))
    return dtable.t()


def _biased_softmax(q, k, bins, k_valid, table, scale):
    logits = (q @ k.transpose(2, 3)) * scale + _table_bias(bins, table)
    logits.masked_fill_(~k_valid[:, None, None, :], -1e9)
    return torch.softmax(logits, dim=-1)


class BiasedAttention(torch.autograd.Function):
    """``softmax(q k^T * scale + bias) @ v`` over rows of queries q (R, H, Q,
    D) and keys k, v (R, H, K, D), the bias that of :func:`_table_bias` at
    bins (R, Q, K, A) into the (L, H) table, keys where ``k_valid`` (R, K)
    is False at -1e9 before the softmax. Keeps only its inputs: the backward
    recomputes the softmax, so no (R, H, Q, K) tensor outlives the call.
    Every row needs a valid key (the masked logits' gradient is 0)."""

    @staticmethod
    def forward(ctx, q, k, v, bins, k_valid, table, scale):
        ctx.save_for_backward(q, k, v, bins, k_valid, table)
        ctx.scale = scale
        return _biased_softmax(q, k, bins, k_valid, table, scale) @ v

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bins, k_valid, table = ctx.saved_tensors
        p = _biased_softmax(q, k, bins, k_valid, table, ctx.scale)
        dv = p.transpose(2, 3) @ dout
        ds = dout @ v.transpose(2, 3)
        ds -= (ds * p).sum(-1, keepdim=True)
        ds *= p
        del p
        ds.masked_fill_(~k_valid[:, None, None, :], 0.0)
        dtable = _table_grad(bins, ds, table.shape)
        ds *= ctx.scale
        return ds @ k, ds.transpose(2, 3) @ q, dv, None, None, dtable, None


class _GeluLinear(torch.autograd.Function):
    """linear(gelu(h), weight, bias), exact GELU, keeping h and the weight:
    the backward recomputes gelu(h)."""

    @staticmethod
    def forward(ctx, h, weight, bias):
        ctx.save_for_backward(h, weight)
        return nn.functional.linear(nn.functional.gelu(h), weight, bias)

    @staticmethod
    def backward(ctx, dy):
        h, weight = ctx.saved_tensors
        g = nn.functional.gelu(h)
        dy2 = dy.reshape(-1, dy.shape[-1])
        dweight = dy2.t() @ g.reshape(-1, g.shape[-1])
        dh = torch.ops.aten.gelu_backward(dy @ weight, h)
        return dh, dweight, dy2.sum(0)


class GeluMlp(nn.Sequential):
    """Linear -> exact GELU -> Linear (children ``0`` / ``1`` / ``2``, as
    nn.Sequential names them) that keeps the first Linear's output only:
    the second's input, gelu of it, is recomputed in the backward."""

    def __init__(self, channels: int, hidden: int):
        super().__init__(nn.Linear(channels, hidden), nn.GELU(),
                         nn.Linear(hidden, channels))

    def forward(self, x):
        return _GeluLinear.apply(self[0](x), self[2].weight, self[2].bias)
