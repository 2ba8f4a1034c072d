"""Seeding (port of ao_tpu/utils/env.py)."""

from __future__ import annotations

import os
import random
from datetime import datetime

import numpy as np
import torch


def get_random_seed() -> int:
    return (
        os.getpid()
        + int(datetime.now().strftime("%S%f"))
        + int.from_bytes(os.urandom(2), "big")
    ) % (2**31)


def set_seed(seed=None) -> int:
    """Seed Python's, numpy's and torch's generators (every device's);
    a random seed when None. Returns the seed."""
    if seed is None:
        seed = get_random_seed()
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
