"""Connected components of the same-label radius graph, on the host (port
of ao_tpu/ops/cluster.py; reference: libs/pointgroup_ops, ballquery_batch_p
and bfs_cluster).

The C++ source is the port's copy, ``csrc/host/cluster.cpp``. At first use
it compiles with ``g++ -O3 -std=c++17 -fPIC -shared`` into
``_build/host-<hash of the source and flags>/libaocluster.so`` (each
process builds to its own name and renames, so concurrent first uses are
safe) and loads through ctypes. A failed build raises. It runs on the
CPU, on the card's machine as here, between the model's forward and the
AP evaluation; it is not a TPU kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "cluster.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"host-{h.hexdigest()[:16]}" / "libaocluster.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.is_file():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}")
        res = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{SOURCE}:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ao_bfs_cluster.restype = ctypes.c_int32
    lib.ao_bfs_cluster.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_float, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def bfs_cluster(
    coords: np.ndarray,  # (N, 3) float32
    semantic: np.ndarray,  # (N,) int32, < 0: never clustered
    batch: Optional[np.ndarray] = None,  # (N,) int32
    radius: float = 1.5,
    min_points: int = 50,
):
    """Returns (labels (N,) int32: component id or -1, number of
    components). Components are grown from the lowest unvisited index,
    within one batch id and one semantic label, over neighbours within
    ``radius``; those smaller than ``min_points`` are dropped."""
    lib = _load()
    coords = np.ascontiguousarray(coords, np.float32)
    semantic = np.ascontiguousarray(semantic, np.int32)
    n = coords.shape[0]
    if coords.shape != (n, 3) or semantic.shape != (n,):
        raise ValueError(f"bfs_cluster: coords {coords.shape}, semantic "
                         f"{semantic.shape}")
    batch = np.ascontiguousarray(np.zeros(n, np.int32) if batch is None else batch,
                                 np.int32)
    if batch.shape != (n,):
        raise ValueError(f"bfs_cluster: batch {batch.shape} for {n} points")
    out = np.empty(n, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    count = lib.ao_bfs_cluster(
        n, coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        semantic.ctypes.data_as(i32), batch.ctypes.data_as(i32),
        ctypes.c_float(radius), min_points, out.ctypes.data_as(i32))
    return out, int(count)
