"""Metric meters (port of the ``AverageMeter`` of ao_tpu/utils/events.py;
the training-event storage comes with the training slice)."""

from __future__ import annotations


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
