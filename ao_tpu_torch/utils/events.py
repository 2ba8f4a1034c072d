"""Training-event scalar storage, meters and writers (port of
ao_tpu/utils/events.py).

A context-managed ``EventStorage`` collects named scalars per iteration;
``HistoryBuffer`` keeps each scalar's history for windowed averages (the
hooks' "latest (average of the last 50)" log fields);
``TensorboardWriter`` writes scalars to TensorBoard when a backend
imports, and does nothing otherwise.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Deque, Dict


class HistoryBuffer:
    """Bounded scalar history."""

    def __init__(self, max_length: int = 1000000):
        self._data: Deque[float] = deque(maxlen=max_length)

    def update(self, value: float):
        self._data.append(value)

    def latest(self) -> float:
        return self._data[-1]

    def avg(self, window_size: int) -> float:
        vals = list(self._data)[-window_size:]
        return sum(vals) / len(vals)


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
    """Named scalars by iteration, for the hooks; a context manager, as the
    trainer holds one over a run."""

    def __init__(self, start_iter: int = 0):
        self._iter = start_iter
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)

    def put_scalar(self, name: str, value: float):
        self._history[name].update(float(value))

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"no history for {name}")
        return self._history[name]

    @property
    def iter(self) -> int:
        return self._iter

    def step(self):
        self._iter += 1

    def __enter__(self):
        return self

    def __exit__(self, *args):
        pass


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
