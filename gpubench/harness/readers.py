"""Arithmetic the per-layer metric readers share: a window's share of the
peak FLOP/s, a kernel's share of its roofline, the device's idle share, and
a span's mean time. Each returns None where the run has nothing to read."""

from __future__ import annotations

from gpubench.counts import ptv2m2
from gpubench.harness.peaks import H100, matmul_peak


def span_mean_ms(run, name):
    if run.spans is None:
        return None
    d = run.spans.durations(name)
    return 1e3 * sum(d) / len(d) if d else None


def mfu(run):
    """Model FLOPs of the window's forwards (a train step counts three)
    over the window's time at the peak of the stated precision, in %."""
    c = run.counts
    if not c.get("forwards") or not run.window_s:
        return None
    per = 3.0 if c["train"] else 1.0
    flops = per * sum(ptv2m2.forward_flops(c["backbone"], n)
                      for _, n in c["forwards"])
    return 100.0 * flops / (run.window_s * matmul_peak(c["precision"], c["tf32"]))


def roofline(run, kernel):
    """The least time of ``kernel``'s work in the window over its device
    time in the trace, in %; None where no kernel of that name ran."""
    c = run.counts
    if run.trace is None or not c.get("forwards"):
        return None
    spent = run.trace.seconds_of(kernel)
    if spent <= 0:
        return None
    least = 0.0
    for shape, n in c["forwards"]:
        ops16, ops32, nbytes = ptv2m2.kernel_bounds(
            c["backbone"], shape, n, c["train"])[kernel]
        least += ptv2m2.bound_seconds(ops16, ops32, nbytes, H100)
    return 100.0 * least / spent


def idle_share(run):
    """The share of the window in which no kernel ran on the device, in %."""
    if run.trace is None or not run.window_s:
        return None
    return 100.0 * max(1.0 - run.trace.busy_s / run.window_s, 0.0)
