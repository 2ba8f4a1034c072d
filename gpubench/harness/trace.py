"""Host spans and the device trace of a run.

``Spans`` records the benchmark's own spans around its calls into each
layer of the program, on the host clock; while a trace is on each span is
also a ``torch.profiler.record_function`` range, so that the trace can say
what the host was doing during a gap in the device's work.

``Trace`` runs ``torch.profiler`` (CPU and CUDA activities) over the
measured window and reduces the raw events: the kernels' intervals (their
union is the device's busy time), the device time by kernel name, and the
idle gaps between kernels with the innermost span that covers each.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

SPAN_PREFIX = "gpubench."


class Spans:
    def __init__(self, tracing=False):
        self.records = []  # (name, start s, end s) on the host clock
        self.tracing = tracing

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        if self.tracing:
            import torch

            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name):
        return [t1 - t0 for n, t0, t1 in self.records if n == name]


def _ns(ev, what):
    """An event's start or duration in ns (the API names them either way)."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(ev, f"{what}_us")() * 1e3


class Trace:
    """torch.profiler over a window, when enabled; ``result`` after exit."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.prof = None
        self.result = None

    def __enter__(self):
        if self.enabled:
            import torch

            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.result = reduce_events(self.prof.profiler.kineto_results.events())
        return False


def reduce_events(events):
    """The device activities' intervals [(start, end, name)] (kernels,
    copies, fills) and the host spans [(start, end, name)] in ns, from
    kineto's raw events, and their summary. The device's copies of host
    ranges (a benchmark span, the optimizer's annotation) carry a host
    range's name and are no device activity."""
    events = list(events)
    host_names = {ev.name() for ev in events
                  if not str(ev.device_type()).endswith("CUDA")}
    kernels, spans = [], []
    for ev in events:
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if str(ev.device_type()).endswith("CUDA"):
            if name not in host_names and not name.startswith(SPAN_PREFIX):
                kernels.append((start, end, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((start, end, name[len(SPAN_PREFIX):]))
    kernels.sort()
    return TraceResult(kernels, spans)


class TraceResult:
    def __init__(self, kernels, spans):
        self.kernels = kernels
        self.spans = spans
        by = defaultdict(float)
        for s, e, n in kernels:
            by[n] += (e - s) * 1e-9
        self.kernel_seconds = dict(by)
        # union of the kernel intervals, and the gaps between them
        self.busy_s = 0.0
        self.gaps = []
        cur_s = cur_e = None
        for s, e, _ in kernels:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                self.busy_s += (cur_e - cur_s) * 1e-9
                self.gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            self.busy_s += (cur_e - cur_s) * 1e-9

    def seconds_of(self, part):
        """Device seconds of the kernels whose names contain ``part``."""
        return sum(t for n, t in self.kernel_seconds.items() if part in n)

    def span_at(self, t):
        """The innermost (shortest) benchmark span covering time t."""
        best = None
        for s, e, n in self.spans:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "outside any span"

    def breakdown(self, top=10):
        """The heaviest device operations and the longest idle gaps, each
        gap with the host span it fell in and the kernel before it."""
        ops = sorted(self.kernel_seconds.items(), key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        idle = [[f"{self.span_at((s + e) / 2)} ({_short(self._before(s))})",
                 (e - s) * 1e-9] for s, e in gaps]
        return dict(device_ops=[[_short(n), t] for n, t in ops],
                    idle_gaps=idle)

    def _before(self, t):
        """The name of the last kernel that ended at or before t."""
        name = ""
        for s, e, n in self.kernels:
            if e <= t:
                name = n
            elif s > t:
                break
        return name


def _short(name, n=120):
    return name if len(name) <= n else name[:n - 3] + "..."
