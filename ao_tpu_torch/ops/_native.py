"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles to an object in its own ``nvcc``
process, all started together, and one more call links the objects into
one shared library with a plain C interface, loaded through ``ctypes``. No
PyTorch headers are compiled, so the build takes seconds to tens of
seconds, as long as the slowest source. The library goes to
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# launcher name -> argtypes (pointers and the stream are c_void_p)
_SIGNATURES = {
    # keys, k2, order, queries, window_starts, d2_out, idx_out,
    # B, Nk, Nq, T, k, tile_q, window, stream
    "knn_window_launch": [_P] * 7 + [_I] * 7 + [_P],
    # d2, idx, d2_out, idx_out, rows, width, k, stream
    "merge_topk_launch": [_P] * 4 + [_L, _I, _I, _P],
    # s[P], idx[P], q2[P], inv[P] (host arrays of device pointers), d2_out,
    # idx_out, P, k, B, Nq, Nqp, stream
    "merge_topk_probes_launch": [ctypes.POINTER(_P)] * 4 + [_P] * 2
    + [_I] * 5 + [_P],
    # src, qrow, idx, valid, A, cA, Wp2, bp2, W1f, b1f, W2, b2, out,
    # B, Nsrc, Nq, S, C, G, nblk, stream
    "gva_eval_launch": [_P] * 13 + [_I] * 7 + [_P],
    # src, qrow, idx, valid, out, part, done, B, Nsrc, Nq, S, C, nblk, stream
    "gva_pos_launch": [_P] * 7 + [_I] * 6 + [_P],
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
    # C, &blocks: blocks of the kernel one SM holds (K4: the same at any C)
    "gva_pos_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    "gva_eval_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    "gva_stats_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    "gva_bwd_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    # xyz planes, mask, scratch, out, B, N, m, start_idx, stream
    "fps_launch": [_P] * 4 + [_I] * 4 + [_P],
    # PointBatchNorm (csrc/point_bn.cu); every launch ends in R, C, bf,
    # vec, lanes, gx. x, mask, part, ..., stream
    "point_bn_sum_launch": [_P] * 3 + [_I] * 6 + [_P],
    # x, mask, sums, part, stats, nrow, ..., stream
    "point_bn_sqdev_launch": [_P] * 5 + [_I] * 7 + [_P],
    # x, mask, sq, stats, weight, bias, running_mean, running_var,
    # num_batches_tracked, y, nrow, ..., train, relu, eps, momentum,
    # 1 - momentum, stream
    "point_bn_norm_launch": [_P] * 10 + [_I] * 9 + [_F] * 3 + [_P],
    # x, mask, g, stats, weight, bias, part, ..., relu, stream
    "point_bn_bwd_sums_launch": [_P] * 7 + [_I] * 7 + [_P],
    # x, mask, g, stats, weight, bias, part, dweight, dbias, dx, nrow, ...,
    # train, relu, stream
    "point_bn_bwd_dx_launch": [_P] * 10 + [_I] * 9 + [_P],
}

_lib = None
build_seconds = None  # wall time of this process' build, if it built one


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


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(cmd, proc):
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")


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
        t0 = time.perf_counter()
        nvcc, pid = _nvcc(), os.getpid()
        objs = [out_dir / f"{p.stem}.{pid}.o" for p in srcs]
        procs = [_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)])
                 for p, o in zip(srcs, objs)]
        try:
            for proc in procs:
                _finish(*proc)
        finally:  # after a failed source, stop the others' builds
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = out_dir / f"libao_kernels.{pid}.so"
        _finish(*_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                         *map(str, objs)]))
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
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
