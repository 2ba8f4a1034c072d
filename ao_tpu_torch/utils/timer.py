"""Stopwatch (port of ao_tpu/utils/timer.py)."""

from __future__ import annotations

import time
from typing import Optional


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused: Optional[float] = None
        self._total_paused = 0.0
        self._count_start = 1

    def pause(self):
        if self._paused is not None:
            raise ValueError("timer already paused")
        self._paused = time.perf_counter()

    def is_paused(self) -> bool:
        return self._paused is not None

    def resume(self):
        if self._paused is None:
            raise ValueError("timer is not paused")
        self._total_paused += time.perf_counter() - self._paused
        self._paused = None
        self._count_start += 1

    def seconds(self) -> float:
        end = self._paused if self._paused is not None else time.perf_counter()
        return end - self._start - self._total_paused

    def avg_seconds(self) -> float:
        return self.seconds() / self._count_start
