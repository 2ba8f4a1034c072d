"""Training-event scalar storage, meters and writers (port of
ao_tpu/utils/events.py).

A context-managed ``EventStorage`` collects named scalars per iteration;
``HistoryBuffer`` keeps each scalar's history for windowed averages and
medians (the hooks' "latest (average of the last 50)" log fields);
``JSONWriter`` appends the latest scalars as JSON lines;
``TensorboardWriter`` writes scalars to TensorBoard when a backend
imports, and does nothing otherwise.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Tuple

# the EventStorage contexts entered and not yet left, innermost last
_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    """The innermost EventStorage whose context is open."""
    if not _CURRENT_STORAGE_STACK:
        raise RuntimeError("get_event_storage() called outside an "
                           "EventStorage context")
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Bounded history of (value, iteration) with a running global mean."""

    def __init__(self, max_length: int = 1000000):
        self._data: Deque[Tuple[float, float]] = deque(maxlen=max_length)
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration=None):
        if iteration is None:
            iteration = self._count
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        vals = sorted(v for v, _ in list(self._data)[-window_size:])
        return vals[len(vals) // 2]

    def avg(self, window_size: int) -> float:
        vals = [v for v, _ in list(self._data)[-window_size:]]
        return sum(vals) / len(vals)

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return list(self._data)


class AverageMeter:
    """Running mean meter (reference: pointcept/utils/events.py:505)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class EventStorage:
    """Named scalars by iteration, for the hooks and the writers; a context
    manager, as the trainer holds one over a run (inside it,
    :func:`get_event_storage` returns it)."""

    def __init__(self, start_iter: int = 0):
        self._iter = start_iter
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._current_prefix = ""

    def put_scalar(self, name: str, value: float, smoothing_hint: bool = True):
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"no history for {name}")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, Tuple[float, int]]:
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20):
        """Each scalar's latest (value, iteration); the value is the median
        of the last ``window_size`` where its smoothing hint is set."""
        return {k: (self._history[k].median(window_size)
                    if self._smoothing_hints[k] else v, it)
                for k, (v, it) in self._latest_scalars.items()}

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int):
        self._iter = int(val)

    def step(self):
        self._iter += 1

    @contextmanager
    def name_scope(self, name: str):
        old = self._current_prefix
        self._current_prefix = f"{old}{name}/"
        try:
            yield
        finally:
            self._current_prefix = old

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args):
        if not _CURRENT_STORAGE_STACK or _CURRENT_STORAGE_STACK[-1] is not self:
            raise RuntimeError("EventStorage contexts left out of order")
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    """Writes an EventStorage's scalars somewhere on each ``write``."""

    def write(self, storage: EventStorage):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends one JSON object a ``write`` to ``json_file``: the iteration,
    the wall time, and every scalar's latest value (its median over the
    last ``window_size`` where it is smoothed)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(os.path.abspath(json_file)), exist_ok=True)
        self._file = open(json_file, "a")
        self._window_size = window_size

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter, "time": time.time()}
        for k, (v, _) in storage.latest_with_smoothing_hint(
                self._window_size).items():
            rec[k] = v
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class TensorboardWriter:
    """TensorBoard scalars under ``log_dir`` through torch's or
    tensorboardX's SummaryWriter; ``add_scalar`` does nothing when neither
    imports."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
        self._writer = SummaryWriter(log_dir)

    def add_scalar(self, name: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(name, value, step)
