"""Console and file logging (port of ao_tpu/utils/logger.py).

``get_root_logger`` returns a logger that writes to stdout and optionally
to a file on process 0 of the process group (the only process without
one) and only warnings elsewhere; repeated calls reuse handlers.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_initialized = set()


def get_root_logger(
    log_file: Optional[str] = None,
    log_level: int = logging.INFO,
    name: str = "ao_tpu_torch",
    process_index: Optional[int] = None,
) -> logging.Logger:
    logger = logging.getLogger(name)
    key = (name, log_file)
    if key in _initialized:
        return logger
    if process_index is None:
        from .comm import get_rank

        process_index = get_rank()

    logger.setLevel(log_level if process_index == 0 else logging.WARNING)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if process_index == 0 and not any(
        type(h) is logging.StreamHandler for h in logger.handlers
    ):
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None and process_index == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _initialized.add(key)
    return logger
