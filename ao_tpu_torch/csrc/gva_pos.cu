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
// What bounds it on the card: bytes. Each query reads 16 ids and 16
// validity bytes and 12 bytes of its own coordinates; each valid edge
// reads 12 bytes of key coordinates by id (mostly from L2: a key is the
// neighbour of about 16 queries), for 13 sums.
//
// What held the first design back: one thread per edge did two 64-bit
// integer divisions (edge -> query -> batch) and a chain of dependent loads
// (validity, then id, then the key's coordinates) for 30 flops, on a grid
// of 4 blocks an SM. The design: one thread per 4 slots of a query, indexed
// with 32-bit arithmetic (a warp covers 8 queries), reads the 4 ids as one
// int4 and the 4 validity bytes as one word, the query's coordinates once,
// and issues the loads of two such groups before the first is used; the
// grid is what the SMs hold at once (the kernel's own occupancy query).
// Each block reduces its 13 f32 sums to one partial row; the last block to
// finish (a counter the launcher zeroes) adds the rows in f64 in a fixed
// order and writes the 13 totals as f32, so the count of ~4M edges stays an
// exact integer, the result is the same on every run, and the wrapper runs
// no reduction of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSums = 13;  // [sum pos (3) | sum pos pos^T (9) | count]
constexpr int kSlots = 16;  // slots a query (the S3DIS config's neighbours)
constexpr int kPer = 4;     // slots a thread
constexpr int kGroups = 2;  // groups whose loads a thread issues before using any

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// a bf16x2 word as its two floats
__device__ __forceinline__ float2 bf2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// the loads of one group (a query's 4 slots), issued before any is used
struct Group {
  uint32_t v4;   // 4 validity bytes
  float q[3];    // query coordinate, hi + lo
  uint32_t k[kPer][3];  // each slot's 6 bf16 coordinates as 3 words
};

__device__ __forceinline__ void load_group(
    Group& g, int it, const bf16* __restrict__ src, const bf16* __restrict__ qrow,
    const int4* __restrict__ idx4, const uint32_t* __restrict__ valid4,
    int Nsrc, int Nq, int C) {
  g.v4 = __ldg(valid4 + it);
  if (!g.v4) return;
  const int4 id4 = __ldg(idx4 + it);
  const int bq = it / (kSlots / kPer);  // b * Nq + n
  const int b = bq / Nq;
  const bf16* qc = qrow + (size_t)bq * (C + 7) + C;
#pragma unroll
  for (int i = 0; i < 3; ++i) g.q[i] = bf(qc[i]) + bf(qc[i + 3]);
  const int ids[kPer] = {id4.x, id4.y, id4.z, id4.w};
  const size_t rw = 2 * C + 6;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    if ((g.v4 >> (8 * s)) & 0xffu) {
      const int id = min(max(ids[s], 0), Nsrc - 1);
      // the coordinate lanes start at 2C of a (2C+6)-wide row: 4-byte aligned
      const uint32_t* kc = reinterpret_cast<const uint32_t*>(
          src + ((size_t)b * Nsrc + id) * rw + 2 * C);
#pragma unroll
      for (int w = 0; w < 3; ++w) g.k[s][w] = __ldg(kc + w);
    }
  }
}

__device__ __forceinline__ void add_group(const Group& g, float* a) {
  if (!g.v4) return;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    if ((g.v4 >> (8 * s)) & 0xffu) {
      // words: (x_hi, y_hi), (z_hi, x_lo), (y_lo, z_lo)
      const float2 w0 = bf2(g.k[s][0]), w1 = bf2(g.k[s][1]), w2 = bf2(g.k[s][2]);
      const float p[3] = {(w0.x + w1.y) - g.q[0], (w0.y + w2.x) - g.q[1],
                          (w1.x + w2.y) - g.q[2]};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a[i] += p[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) a[3 + 3 * i + j] += p[i] * p[j];
      }
      a[12] += 1.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads) gva_pos_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7)
    const int4* __restrict__ idx4,      // (B, Nq, 16) as groups of 4
    const uint32_t* __restrict__ valid4,  // (B, Nq, 16) bytes as groups of 4
    float* __restrict__ part,           // (gridDim.x, 13)
    float* __restrict__ out,            // (13,)
    unsigned int* __restrict__ done,    // blocks finished, zeroed per launch
    int Nsrc, int Nq, int C, int items) {
  float a[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) a[j] = 0.f;
  const int stride = gridDim.x * kThreads;
  int it = blockIdx.x * kThreads + threadIdx.x;
  for (; it + (kGroups - 1) * stride < items; it += kGroups * stride) {
    Group g[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u)
      load_group(g[u], it + u * stride, src, qrow, idx4, valid4, Nsrc, Nq, C);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) add_group(g[u], a);
  }
  for (; it < items; it += stride) {
    Group g0;
    load_group(g0, it, src, qrow, idx4, valid4, Nsrc, Nq, C);
    add_group(g0, a);
  }

  __shared__ float red[kThreads / 32][kSums];
  constexpr int kRowGroups = kThreads / kSums;  // 19
  __shared__ double dred[kRowGroups][kSums];
  __shared__ bool last;
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
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every partial row in f64, each of 19 groups of rows
  // summed by one thread a column, then the groups, in a fixed order
  __threadfence();
  if (threadIdx.x < kRowGroups * kSums) {
    const int j = threadIdx.x % kSums, r0 = threadIdx.x / kSums;
    double x = 0.0;
#pragma unroll 4
    for (int r = r0; r < (int)gridDim.x; r += kRowGroups)
      x += (double)__ldcg(part + (size_t)r * kSums + j);
    dred[r0][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double x = 0.0;
    for (int r = 0; r < kRowGroups; ++r) x += dred[r][threadIdx.x];
    out[threadIdx.x] = (float)x;
  }
}

}  // namespace

extern "C" int gva_pos_launch(const void* src, const void* qrow,
                              const void* idx, const void* valid, void* out,
                              void* part, void* done, int B, int Nsrc, int Nq,
                              int S, int C, int nblk, void* stream) {
  const long long items = (long long)B * Nq * S / kPer;
  if (C % 8 != 0 || Nsrc < 1 || nblk < 1 || S != kSlots ||
      items >= (1ll << 31) || ((uintptr_t)src & 3) || ((uintptr_t)idx & 15) ||
      ((uintptr_t)valid & 3))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(done, 0, sizeof(unsigned int), st);
  if (e != cudaSuccess) return e;
  gva_pos_kernel<<<nblk, kThreads, 0, st>>>(
      (const bf16*)src, (const bf16*)qrow, (const int4*)idx,
      (const uint32_t*)valid, (float*)part, (float*)out, (unsigned int*)done,
      Nsrc, Nq, C, (int)items);
  return cudaGetLastError();
}

// blocks of gva_pos_kernel one SM holds at once (the same at every C)
extern "C" int gva_pos_blocks_per_sm(int /*C*/, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gva_pos_kernel,
                                                       kThreads, 0);
}
