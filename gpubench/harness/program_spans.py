"""The program's own spans (``ao_tpu_torch.utils.tracing``) against the
device trace: the device's idle time that falls inside a span.

The program records its spans on the trace's clock, and only while a
profiler records, so in a traced run its records are the window's. A
program without the spans (an older checkout) has no records, and the
readers then return None.
"""

from __future__ import annotations


def _records():
    try:
        from ao_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.records()


def _overlap_ns(gaps, spans):
    """The time, in ns, that two lists of sorted, disjoint intervals share."""
    total = i = j = 0
    while i < len(gaps) and j < len(spans):
        lo = max(gaps[i][0], spans[j][0])
        hi = min(gaps[i][1], spans[j][1])
        total += max(hi - lo, 0)
        if gaps[i][1] < spans[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_step(run, span_name):
    """The device's idle time inside the program's ``span_name`` spans, in
    ms a step of the window; None without a trace or without records."""
    if run.trace is None or not run.attempted:
        return None
    spans = sorted((s, e) for n, s, e in _records() if n == span_name)
    if not spans:
        return None
    return 1e-6 * _overlap_ns(run.trace.gaps, spans) / run.attempted
