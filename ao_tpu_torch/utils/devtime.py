"""Device time of a kernel per call, from torch.profiler's trace.

CUDA events around a Python wrapper time the host's enqueueing as well as
the kernel: a launch that runs for tens of microseconds can take longer
to enqueue (PyTorch ops and a ctypes call) than to run. The profiler's
self device time of the kernels whose names hold a given string counts
the card's own time only."""

from __future__ import annotations

import time

import torch

_ACTIVITIES = (torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA)


def trace(fn, reps: int = 1, warmup: int = 1):
    """(wall ms, device ms, device launches) per call of ``fn`` over ``reps``
    calls traced with torch.profiler after ``warmup`` untraced ones, then
    the trace's CUDA kernel rows, heaviest self device time first (kernel
    rows only: the op rows repeat their kernels' device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=list(_ACTIVITIES)) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    events.sort(key=lambda e: -e.self_device_time_total)
    return (wall_ms, sum(e.self_device_time_total for e in events) / 1e3 / reps,
            sum(e.count for e in events) / reps, events)


def device_ms(fn, name: str, reps: int = 10, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn`` in the CUDA kernels whose names
    contain ``name``, over ``reps`` traced calls: each such kernel's mean
    time per launch, summed over the kernels (each launched once a call).
    A trace that lost some launches' events still gives their mean; one
    that lost them all is taken again, up to three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(3):
        with torch.profiler.profile(activities=list(_ACTIVITIES)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.count > 0]
        hits = [e for e in cuda if name in e.key]
        if hits:
            return sum(e.self_device_time_total / e.count for e in hits) / 1e3
        seen.update(e.key[:60] for e in cuda)
    raise RuntimeError(f"no CUDA kernel named like {name!r} in 3 traces; "
                       f"CUDA kernels seen: {sorted(seen)[:8]}")
