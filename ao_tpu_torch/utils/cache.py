"""Cross-process in-memory dataset cache (port of ao_tpu/utils/cache.py;
reference: pointcept/utils/cache.py:20-56, which keeps SharedArray shm://
arrays).

A scene dict is saved as one ``.npy`` file an array in a directory named
by the SHA-1 of its cache name, under ``AO_SHM_CACHE`` (read at each call;
``/dev/shm/ao_tpu_cache`` by default, so that the files live in memory).
Every later caller, in any process, gets read-only memory maps of them:
one copy of the decoded scenes for every loader worker.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, Optional

import numpy as np

DEFAULT_ROOT = "/dev/shm/ao_tpu_cache"


def cache_root() -> str:
    return os.environ.get("AO_SHM_CACHE", DEFAULT_ROOT)


def _slot(name: str) -> str:
    return os.path.join(cache_root(),
                        hashlib.sha1(name.encode()).hexdigest()[:16])


def shared_dict(name: str, data: Optional[Dict[str, np.ndarray]] = None
                ) -> Dict[str, np.ndarray]:
    """The cache entry ``name`` as a dict of read-only memory-mapped
    arrays. The first caller passes ``data`` to fill it (written under a
    temporary name, then renamed into place); a caller that finds the
    entry filled reads it, ``data`` or not. Raises KeyError for an entry
    nobody filled."""
    slot = _slot(name)
    if data is not None and not os.path.isdir(slot):
        tmp = f"{slot}.tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for k, v in data.items():
            np.save(os.path.join(tmp, f"{k}.npy"), np.asarray(v))
        try:
            os.replace(tmp, slot)
        except OSError:  # another process filled it first
            shutil.rmtree(tmp, ignore_errors=True)
    if not os.path.isdir(slot):
        raise KeyError(f"shared cache entry missing: {name}")
    return {f[:-4]: np.load(os.path.join(slot, f), mmap_mode="r")
            for f in sorted(os.listdir(slot)) if f.endswith(".npy")}


def clear_cache():
    """Remove every entry (the whole ``AO_SHM_CACHE`` directory)."""
    if os.path.isdir(cache_root()):
        shutil.rmtree(cache_root())
