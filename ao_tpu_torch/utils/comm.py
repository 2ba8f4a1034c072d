"""Cross-process helpers (port of ao_tpu/utils/comm.py; reference:
pointcept/utils/comm.py) over ``torch.distributed``.

With no initialised process group every call keeps its single-process
meaning: world size 1, rank 0, ``gather(x)`` and ``all_gather(x)`` return
``[x]``, ``synchronize`` does nothing and the tensor reductions return
their input. ``WORLD_SIZE`` > 1 in the environment with no initialised
group is an error that names the launcher (``engines/launch.py``): a
silent single-process run there would train each process on its own.

Under a group (``engines/launch.py`` initialises it: NCCL for cards, gloo
for the CPU), the object gathers pickle through ``all_gather_object``;
:func:`all_reduce` sums a tensor in place of a copy, and
:func:`all_reduce_grad` is the same sum with a backward (the gradient of
a sum that every rank reads is the sum of every rank's gradient), which
the global BatchNorm statistics (:func:`global_moments`) differentiate
through. Inside :func:`global_batch` (the trainer's loss of a step) the
losses divide by the global batch's denominators; elsewhere (evaluation)
each process scores its own batches. Every tensor collective adds one to :data:`COUNTS`
(``collectives``) and, while :func:`timed` is on, its seconds (the device
synchronised before and after) to ``seconds``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

# tensor collectives and their seconds (while timed) since the last reset
COUNTS = {"collectives": 0, "seconds": 0.0}
_TIMED = [False]
_GLOBAL_BATCH = [False]


def is_distributed() -> bool:
    """True under an initialised process group. Without one, ``WORLD_SIZE``
    > 1 is an error: the processes were started without the launcher."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world} but no process group is initialised: start "
            f"the processes through ao_tpu_torch.engines.launch.launch (the "
            f"tools' --num-devices, or torchrun, whose environment launch "
            f"reads)")
    return False


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_local_rank() -> int:
    """This process's index on its machine (``LOCAL_RANK``, which the
    launcher sets; 0 in a single process)."""
    return int(os.environ.get("LOCAL_RANK", "0")) if is_distributed() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize():
    """Barrier across processes: nothing to wait for with one process."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Every process's picklable ``data``, on every process, in rank order."""
    world = get_world_size()
    if world == 1:
        return [data]
    out = [None] * world
    dist.all_gather_object(out, data)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's ``data`` on process ``dst`` (others get ``[]``)."""
    out = all_gather(data)
    return out if get_rank() == dst else []


def shared_random_seed() -> int:
    """A seed drawn by process 0 and shared by all (reference comm.py:158)."""
    seed = int(np.random.randint(2**31))
    return int(all_gather(seed)[0])


def reduce_dict(input_dict: Dict[str, Any], average: bool = True) -> Dict:
    """The mean (or sum) of every process's dict of numbers or arrays, key
    by key (reference comm.py:171)."""
    world = get_world_size()
    if world == 1:
        return dict(input_dict)
    gathered = all_gather(input_dict)
    out = {}
    for k in sorted(input_dict):
        total = sum(g[k] for g in gathered)
        out[k] = total / world if average else total
    return out


@contextlib.contextmanager
def global_batch():
    """Inside, :func:`in_global_batch` is true under a process group: the
    losses then divide by the global batch's denominators, a collective
    every process of the group must reach (the trainer's step does)."""
    _GLOBAL_BATCH[0] = True
    try:
        yield
    finally:
        _GLOBAL_BATCH[0] = False


def in_global_batch() -> bool:
    return _GLOBAL_BATCH[0] and is_distributed()


@contextlib.contextmanager
def timed():
    """Time every tensor collective inside (the device synchronised
    around each, so a collective is not charged with the work before it)."""
    _TIMED[0] = True
    try:
        yield
    finally:
        _TIMED[0] = False


def reset_counts():
    COUNTS.update(collectives=0, seconds=0.0)


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _counted(op, t):
    """Run the collective ``op`` on ``t``'s device, counted (and timed)."""
    COUNTS["collectives"] += 1
    if not _TIMED[0]:
        op()
        return
    _sync(t)
    start = time.perf_counter()
    op()
    _sync(t)
    COUNTS["seconds"] += time.perf_counter() - start


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` across processes in place, counted (and timed)."""
    _counted(lambda: dist.all_reduce(t), t)
    return t


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process (``t`` itself without a group);
    no gradient flows through it."""
    if not is_distributed():
        return t
    return _all_reduce_(t.detach().clone())


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone())


def all_reduce_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process, differentiable: its gradient on
    each process is the sum of the gradients every process passes back
    (``t`` itself without a group)."""
    if not is_distributed():
        return t
    return _AllReduceGrad.apply(t)


def all_gather_padded(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (its last dimension may differ between
    processes) padded with zeros to the largest process's length, stacked
    in rank order: (world, *t.shape[:-1], longest). Two collectives, the
    lengths then the tensors; no gradient flows through it. Without a
    group: ``t[None]``."""
    if not is_distributed():
        return t.detach()[None]
    world = get_world_size()
    n = torch.tensor([t.shape[-1]], dtype=torch.int64, device=t.device)
    lengths = [torch.zeros_like(n) for _ in range(world)]
    _counted(lambda: dist.all_gather(lengths, n), n)
    longest = max(int(x) for x in lengths)
    padded = torch.nn.functional.pad(t.detach(), (0, longest - t.shape[-1]))
    out = [torch.empty_like(padded) for _ in range(world)]
    _counted(lambda: dist.all_gather(out, padded.contiguous()), padded)
    return torch.stack(out)


def broadcast_(tensors, src: int = 0):
    """Overwrite ``tensors`` with process ``src``'s: one flat collective
    per dtype."""
    if not is_distributed():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():  # one flat collective per dtype
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        COUNTS["collectives"] += 1
        dist.broadcast(flat, src)
        o = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()


def global_moments(x, mask, dims):
    """(mean, biased variance, count) of ``x`` over ``dims`` at the valid
    rows of ``mask`` (every row when None), over every process of the
    group: two collectives, [sum | count] then the squared deviations
    (the two-pass variance of the single-process path), each
    differentiable, so that every process's input gradient takes the
    global sums of the output gradient, as SyncBatchNorm's does."""
    m = (torch.ones_like(x[..., :1]) if mask is None
         else mask.to(x.dtype)[..., None])
    s = all_reduce_grad(torch.cat([(x * m).sum(dims), m.sum().reshape(1)]))
    cnt = torch.clamp_min(s[-1].detach(), 1.0)
    mean = s[:-1] / cnt
    var = all_reduce_grad((((x - mean) ** 2) * m).sum(dims)) / cnt
    return mean, var, cnt
