// K4: relative-position moments of a stage's neighbour graph (PT-v2m2 train).
//
// Replaces both TPU position-moment kernels of ao_tpu:
//   ops/pallas/gva_slab.py  compute_pos_moments_slab -> _pos_kernel
//       (pallas_call in _run at :432) -- Morton-sorted rows, window graph;
//   ops/pallas/gva_fused.py compute_pos_moments -> _pos_kernel
//       (pallas_call in _run at :419) -- pre-gathered rows.
// Per edge (query n, slot s) with v = valid:
//   pos = ((khi + klo) - (qhi + qlo)) * v       (f32, from the bf16 halves)
// and over all edges: sum pos (3), sum pos pos^T (3x3), sum v. The pe-MLP's
// BatchNorm input is linear in pos, so these fold its batch statistics
// (ops/gva.py:fold_pe).
//
// What bounds it on the card: bytes. Each valid edge reads 12 bytes of
// query coordinates, 12 of key coordinates by id, 4 of id and 1 of
// validity for 13 sums. The design: one thread per edge in a grid-stride
// loop, 13 f32 sums in registers, a shuffle-and-shared-memory reduction
// per block, one row of 13 partial sums per block. The wrapper adds the
// rows in f64: no f32 atomics chain into one scalar, so the count of
// ~4M edges at stage 0 stays an exact integer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSums = 13;  // [sum pos (3) | sum pos pos^T (9) | count]

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__global__ void __launch_bounds__(kThreads) gva_pos_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7)
    const int* __restrict__ idx,        // (B, Nq, S)
    const uint8_t* __restrict__ valid,  // (B, Nq, S)
    float* __restrict__ part,           // (gridDim.x, 13)
    int Nsrc, int Nq, int S, int C, long long E) {
  const int rw = 2 * C + 6, qw = C + 7;
  float a[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) a[j] = 0.f;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < E;
       e += (long long)gridDim.x * kThreads) {
    if (!valid[e]) continue;
    const long long bq = e / S;  // b * Nq + q
    const long long b = bq / Nq;
    const int id = min(max(idx[e], 0), Nsrc - 1);
    const bf16* kc = src + ((size_t)b * Nsrc + id) * rw + 2 * C;
    const bf16* qc = qrow + (size_t)bq * qw + C;
    float p[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      p[i] = (bf(kc[i]) + bf(kc[i + 3])) - (bf(qc[i]) + bf(qc[i + 3]));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] += p[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) a[3 + 3 * i + j] += p[i] * p[j];
    }
    a[12] += 1.f;
  }
  __shared__ float red[kThreads / 32][kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float x = a[j];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float x = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) x += red[w][threadIdx.x];
    part[(size_t)blockIdx.x * kSums + threadIdx.x] = x;
  }
}

}  // namespace

extern "C" int gva_pos_launch(const void* src, const void* qrow,
                              const void* idx, const void* valid, void* part,
                              int B, int Nsrc, int Nq, int S, int C, int nblk,
                              void* stream) {
  if (C % 8 != 0 || Nsrc < 1 || nblk < 1) return cudaErrorInvalidValue;
  const long long E = (long long)B * Nq * S;
  gva_pos_kernel<<<nblk, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (float*)part, Nsrc, Nq, S, C, E);
  return cudaGetLastError();
}
