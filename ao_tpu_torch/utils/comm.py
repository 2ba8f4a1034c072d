"""Cross-process helpers (the single-process subset of ao_tpu/utils/comm.py;
reference: pointcept/utils/comm.py).

The port runs one process on one card. These are the calls that REAL's
``after_epoch`` makes, with their single-process meaning: ``gather(x)``
and ``all_gather(x)`` return ``[x]`` and ``synchronize`` does nothing.
Under ``WORLD_SIZE`` > 1 every call raises: data parallelism over NCCL
(ROADMAP.md queue 1 item 6) is not ported, and a silent single-process
run there would train each process on its own.
"""

from __future__ import annotations

import os
from typing import Any, List


def _check_single_process():
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: ao_tpu_torch runs one process; DDP over "
            f"NCCL is not ported (ROADMAP.md queue 1 item 6)")


def get_world_size() -> int:
    _check_single_process()
    return 1


def get_rank() -> int:
    _check_single_process()
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize():
    """Barrier across processes: nothing to wait for with one process."""
    _check_single_process()


def all_gather(data: Any) -> List[Any]:
    """Every process's ``data``, on every process: ``[data]``."""
    _check_single_process()
    return [data]


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's ``data`` on process ``dst`` (others get ``[]``)."""
    out = all_gather(data)
    return out if get_rank() == dst else []
