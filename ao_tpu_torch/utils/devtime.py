"""Device time of a kernel per call, from torch.profiler's trace.

CUDA events around a Python wrapper time the host's enqueueing as well as
the kernel: a launch that runs for tens of microseconds can take longer
to enqueue (PyTorch ops and a ctypes call) than to run. The profiler's
self device time of the kernels whose names hold a given string counts
the card's own time only."""

from __future__ import annotations

import torch


def device_ms(fn, name: str, reps: int = 10, warmup: int = 2) -> float:
    """Device milliseconds per call of ``fn`` in the CUDA kernels whose names
    contain ``name``, over ``reps`` traced calls: each such kernel's mean
    time per launch, summed over the kernels (each launched once a call).
    A trace that lost some launches' events still gives their mean; one
    that lost them all is taken again, up to three times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = set()
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
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
