"""The preprocessors' process pool: ``spawn`` workers, as a forked child
of a process with threads can deadlock."""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor


def pool_map(fn, items, num_workers, *args):
    """``[fn(item, *args) for item in items]`` over ``num_workers`` spawned
    processes, in order."""
    with ProcessPoolExecutor(max_workers=num_workers,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(fn, item, *args) for item in items]
        return [f.result() for f in futures]
