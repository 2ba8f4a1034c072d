"""K2 (`merge_topk`, `merge_topk_probes`) against its plain versions on the
probes of the S3DIS path's multi-probe searches.

    python -m ao_tpu_torch.tools.check_merge_topk [--seeds 0 1 2 3] [--time] [--phases]

The raw outputs of the probes are built through the port's own window
search (``knn_spatial._window_probe``) on the four kinds of cloud of
``check_knn_window``: the unpool search of the test slice's largest batch
(B=8: 90112 queries over every third point, 2 probes of k=3) and of the
train batch (B=3 x 81920), and the gathered stages' 3-probe self graph
(B=2 x 2048, k=16). Required at every case, bit for bit on scores and
ids: the fused kernel against ``merge_topk_probes_plain`` (the per-probe
tail, the concatenation and ``merge_topk_plain``), and the row kernel
``merge_topk`` on the concatenated tails against ``merge_topk_plain``.

``--time`` adds, at the first seed of each kind, the device ms per call
(torch.profiler) of the fused kernel, of the row kernel, and of the
PyTorch tail plus row kernel that the fused kernel replaces, with the
device launches of each. ``--phases`` builds an instrumented copy of the
first design of K2 (one thread per row, the row in local memory, runtime
width and k) and prints the share of clock64() cycles its warps spend in
the loads, the k rounds and the stores at B=8 x 90112, beside its device
ms and the fused kernel's on the same rows. Prints one JSON object per
line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import _native
from ..ops import knn_spatial as ks
from ..utils.devtime import device_ms, trace
from .check_knn_window import KINDS, cloud

# (label, B, N, probes, k, tile_q, window, self graph)
SHAPES = (("test unpool", 8, 90112, 2, 3, 512, 512, False),
          ("train unpool", 3, 81920, 2, 3, 512, 512, False),
          ("gathered self", 2, 2048, 3, 16, 256, 1024, True))


def probes(kind, seed, shape, device):
    """The raw outputs of every probe of one multi-probe search."""
    _, B, N, P, k, tile_q, window, self_mode = shape
    gen = torch.Generator().manual_seed(seed)
    coord, mask = cloud(kind, B, N, gen, device)
    if self_mode:
        key, kmask = coord, mask
    else:
        key, kmask = coord[:, ::3].contiguous(), mask[:, ::3].contiguous()
    if kind == "sparse":  # 97% of the keys invalid
        drop = torch.rand(kmask.shape, generator=gen).to(device) < 0.97
        kmask = kmask & ~drop
        if self_mode:
            coord, mask = key, kmask
    return [ks._window_probe(coord, key, mask, kmask, k, tile_q, window,
                             ks._PROBE_SHIFTS[p], self_mode) for p in range(P)]


def total_device(fn, reps=10):
    """(device ms per call summed over every kernel ``fn`` launches, device
    launches per call), from torch.profiler."""
    return trace(fn, reps)[1:3]


def bitwise(a, b):
    return bool(torch.equal(a[1], b[1]) and torch.equal(
        a[0].view(torch.int32), b[0].view(torch.int32)))


def check(raw, k, timed):
    cols = list(zip(*raw))
    fused = ks.merge_topk_probes(*cols, k)
    plain = ks.merge_topk_probes_plain(*cols, k)
    tails = [ks._probe_tail(*r) for r in raw]
    d2 = torch.cat([t[0] for t in tails], -1)
    idx = torch.cat([t[1] for t in tails], -1)
    rows = ks.merge_topk(d2, idx, k)
    row_plain = ks.merge_topk_plain(d2, idx, k)
    res = dict(fused_ok=bitwise(fused, plain), rows_ok=bitwise(rows, row_plain),
               missing_slots=int((plain[0] > ks._BIG / 2).sum()))
    if timed:
        def unfused():
            t = [ks._probe_tail(*r) for r in raw]
            return ks.merge_topk(torch.cat([x[0] for x in t], -1),
                                 torch.cat([x[1] for x in t], -1), k)

        res["fused_device_ms"] = device_ms(
            lambda: ks.merge_topk_probes(*cols, k), "merge_topk_probes_kernel")
        res["rows_device_ms"] = device_ms(
            lambda: ks.merge_topk(d2, idx, k), "merge_topk_kernel")
        res["tail_and_rows_device_ms"], res["tail_and_rows_launches"] = (
            total_device(unfused))
        res["fused_total_device_ms"], res["fused_launches"] = total_device(
            lambda: ks.merge_topk_probes(*cols, k))
    return res


# the first design of K2 (one thread per row, the row in local memory,
# runtime width and k), with clock64() read between its phases by every
# thread and summed over lane 0 of each warp; the outputs of the k rounds
# are kept in local memory and stored after the rounds so that the stores
# are a phase of their own
_PHASE_SRC = r"""
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>
__global__ void phase_kernel(const float* d2, const int* idx, float* out_d2,
    int* out_idx, long long rows, int width, int k,
    unsigned long long* cyc, int timed) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long t0 = clock64();
  uint32_t packed[64]; int ids[64];
  const float* dr = d2 + r * width; const int* ir = idx + r * width;
  for (int c = 0; c < width; ++c) {
    packed[c] = (__float_as_uint(fmaxf(dr[c], FLT_MIN)) & ~63u) | (uint32_t)c;
    ids[c] = ir[c];
  }
  uint32_t acc = 0;
  for (int c = 0; c < width; ++c) acc ^= packed[c] ^ (uint32_t)ids[c];
  asm volatile("" : : "r"(acc) : "memory");
  const long long t1 = clock64();
  float od[64]; int oi[64];
  for (int j = 0; j < k; ++j) {
    uint32_t m = packed[0];
    for (int c = 1; c < width; ++c) m = min(m, packed[c]);
    const int am = (int)(m & 63u);
    const int chosen = am < width ? ids[am] : INT_MAX;
    od[j] = __uint_as_float(m & ~63u); oi[j] = chosen;
    for (int c = 0; c < width; ++c)
      if (ids[c] == chosen && __uint_as_float(packed[c]) < 5e29f)
        packed[c] = __float_as_uint(1e30f);
  }
  asm volatile("" : : : "memory");
  const long long t2 = clock64();
  for (int j = 0; j < k; ++j) { out_d2[r * k + j] = od[j]; out_idx[r * k + j] = oi[j]; }
  asm volatile("" : : : "memory");
  const long long t3 = clock64();
  if (timed && (threadIdx.x & 31) == 0) {
    atomicAdd(cyc + 0, (unsigned long long)(t1 - t0));
    atomicAdd(cyc + 1, (unsigned long long)(t2 - t1));
    atomicAdd(cyc + 2, (unsigned long long)(t3 - t2));
  }
}
extern "C" int phase_launch(const void* d2, const void* idx, void* od,
    void* oi, long long rows, int width, int k, void* cyc, int timed,
    void* stream) {
  const long long blocks = (rows + 127) / 128;
  phase_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      (const float*)d2, (const int*)idx, (float*)od, (int*)oi, rows, width,
      k, (unsigned long long*)cyc, timed);
  return cudaGetLastError();
}
"""


def phases(raw, k):
    """Phase shares of the first design's warps on the concatenated tails
    of ``raw``, its device ms with the counters off, and the fused kernel's
    device ms on the same probes."""
    out_dir = _native.BUILD_DIR / "check_merge_topk"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "phase.cu", out_dir / "libphase.so"
    src.write_text(_PHASE_SRC)
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.phase_launch.argtypes = [P_] * 4 + [ctypes.c_longlong, I_, I_, P_, I_, P_]
    lib.phase_launch.restype = I_
    tails = [ks._probe_tail(*r) for r in raw]
    d2 = torch.cat([t[0] for t in tails], -1).contiguous()
    idx = torch.cat([t[1] for t in tails], -1).to(torch.int32).contiguous()
    rows, width = d2.numel() // d2.shape[-1], d2.shape[-1]
    od = torch.empty((rows, k), dtype=torch.float32, device=d2.device)
    oi = torch.empty((rows, k), dtype=torch.int32, device=d2.device)
    cyc = torch.zeros(3, dtype=torch.int64, device=d2.device)

    def launch(timed):
        err = lib.phase_launch(d2.data_ptr(), idx.data_ptr(), od.data_ptr(),
                               oi.data_ptr(), rows, width, k, cyc.data_ptr(),
                               timed, _native.stream_ptr(d2))
        if err:
            raise RuntimeError(f"phase_kernel: CUDA error {err}")

    launch(1)
    torch.cuda.synchronize()
    c = cyc.tolist()
    ref = ks.merge_topk_plain(d2.view(*tails[0][0].shape[:2], width), idx.view(
        *tails[0][1].shape[:2], width), k)
    ok = bitwise((od.view_as(ref[0]), oi.view_as(ref[1])), ref)
    cols = list(zip(*raw))
    return dict(phase_shares=dict(zip(("loads", "rounds", "stores"),
                                      (x / sum(c) for x in c))),
                cycles_per_warp=sum(c) / -(-rows // 32), first_design_ok=ok,
                first_design_device_ms=device_ms(lambda: launch(0),
                                                 "phase_kernel"),
                fused_device_ms=device_ms(
                    lambda: ks.merge_topk_probes(*cols, k),
                    "merge_topk_probes_kernel"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--kinds", nargs="+", default=list(KINDS))
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--phases", action="store_true")
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_merge_topk: needs a CUDA card")
    dev = torch.device("cuda")
    ok = True
    with torch.inference_mode():
        if a.phases:
            raw = probes("clustered", a.seeds[0], SHAPES[0], dev)
            print(json.dumps(dict(shape=SHAPES[0][0], **phases(raw, 3))),
                  flush=True)
        for kind in a.kinds:
            for seed in a.seeds:
                for shape in SHAPES:
                    raw = probes(kind, seed, shape, dev)
                    row = dict(kind=kind, seed=seed, shape=shape[0],
                               B=shape[1], N=shape[2], probes=shape[3],
                               k=shape[4], **check(
                                   raw, shape[4], a.time and seed == a.seeds[0]))
                    ok = ok and row["fused_ok"] and row["rows_ok"]
                    print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("check_merge_topk: K2 disagrees with its plain versions")


if __name__ == "__main__":
    main()
