"""The port's spans, on the device trace's clock.

``span(name)`` marks a part of the program's work. It records only while
a ``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``):
then it opens ``torch.profiler.record_function("ao/" + name)``, so that the
range appears in the profiler's trace (a ``RuntimeProfiler`` hook's
``trace.json`` among them), and appends ``(name, start_ns, end_ns)`` to a
bounded record in this process. Both times are ``time.time_ns()``, read
outside the range, so that the record brackets the trace's event of the
range. Otherwise it returns one shared null context: no clock is read,
nothing is allocated and no range is opened.

Spans: ``step/forward``, ``step/backward`` and ``step/optimizer`` in
``Trainer._step``; ``ptv2m2/embed``, ``ptv2m2/enc<i>`` and
``ptv2m2/dec<i>`` in PT-v2m2's forward.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

PREFIX = "ao/"
LIMIT = 2**20  # records kept; the oldest go first

_records = collections.deque(maxlen=LIMIT)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "start", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _records.append((self.name, self.start, time.time_ns()))
        return False


def span(name):
    """A context that records ``name`` while a profiler records."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def records():
    """The recorded spans, oldest first: [(name, start_ns, end_ns)]."""
    return list(_records)


def clear():
    _records.clear()
