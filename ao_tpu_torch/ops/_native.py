"""Build and bind the port's CUDA kernels.

All ``csrc/*.cu`` sources compile in ONE ``nvcc`` call into one shared
library with a plain C interface, loaded through ``ctypes``. No PyTorch
headers are compiled, so the build takes seconds. The library goes to
``ao_tpu_torch/_build/<hash of the sources>/`` at first use and is reused
while the sources are unchanged.

Every launcher takes raw device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on
a non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# launcher name -> argtypes (pointers and the stream are c_void_p)
_SIGNATURES = {
    # keys, k2, order, queries, window_starts, d2_out, idx_out,
    # B, Nk, Nq, T, k, tile_q, window, stream
    "knn_window_launch": [_P] * 7 + [_I] * 7 + [_P],
    # d2, idx, d2_out, idx_out, rows, width, k, stream
    "merge_topk_launch": [_P] * 4 + [_L, _I, _I, _P],
    # src, qrow, idx, valid, A, cA, Wp2, bp2, W1f, b1f, W2, b2, out,
    # B, Nsrc, Nq, S, C, G, stream
    "gva_eval_launch": [_P] * 13 + [_I] * 6 + [_P],
    # src, qrow, idx, valid, part, B, Nsrc, Nq, S, C, nblk, stream
    "gva_pos_launch": [_P] * 5 + [_I] * 6 + [_P],
    # src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1, part,
    # B, Nsrc, Nq, S, C, G, nblk, stream
    "gva_stats_launch": [_P] * 11 + [_I] * 7 + [_P],
    # src, qrow, idx, valid, A, cA, Wp2, Wp2T, bp2, W1f, b1f, W2, b2, dout,
    # dkv, dq, mom, qmom, part, scratch, B, Nsrc, Nq, S, C, G, nblk, nrow,
    # nsplit, stream
    "gva_bwd_launch": [_P] * 20 + [_I] * 9 + [_P],
    # C: K6's per-edge scratch width (0: none), its sums pass' output tiles
    "gva_bwd_scratch_width": [_I],
    "gva_bwd_sums_tiles": [_I],
    # C, &blocks: blocks of the persistent kernel one SM holds
    "gva_stats_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    "gva_bwd_blocks_per_sm": [_I, ctypes.POINTER(_I)],
}

_lib = None
build_seconds = None  # wall time of the nvcc call of this process, if any


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of ao_tpu_torch "
        "are built from csrc/ at first use"
    )


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / "libao_kernels.so"
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libao_kernels.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
            )
        os.replace(tmp, so)
    cdll = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.ao_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.ao_cuda_error_string.restype = ctypes.c_char_p
    _lib = cdll
    return _lib


def check(err: int, name: str):
    if err != 0:
        msg = lib().ao_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}: {msg}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor):
    """Raise unless every tensor lies on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all tensors must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
