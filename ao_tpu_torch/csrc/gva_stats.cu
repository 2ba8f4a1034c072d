// K5: batch statistics of the weight-encoding BatchNorm (PT-v2m2 train).
//
// Replaces both TPU statistics kernels of ao_tpu:
//   ops/pallas/gva_slab.py  _fwd_inner -> _stats_kernel (pallas_call in
//       _run at :432) -- Morton-sorted rows, window graph;
//   ops/pallas/gva_fused.py _fwd_inner -> _stats_kernel (pallas_call in
//       _run at :419) -- pre-gathered rows.
// Per edge (query n, slot s) with v = valid, it recomputes the attention
// forward up to the weight encoding's first layer with the UNFOLDED W1 and
// the batch-statistic folds (A, cA) of the pe-MLP's BatchNorm:
//   pos  = ((khi + klo) - (qhi + qlo)) * v
//   pe1  = relu((bf16(pos) @ bf16(A) + cA) * v)
//   peb  = bf16(pe1) @ bf16(Wp2) + bp2
//   t    = (bf16(k - q + peb) @ bf16(W1) + b1) * v
// and sums over all edges: sum t (G), sum t^2 (G), sum v, sum pos (3),
// sum pos pos^T (9). The host takes mean = sum t / n and the biased
// variance max(sum t^2 / n - mean^2, 0), as _fwd_inner :526-528 does.
//
// What bounds it on the card: arithmetic, as for K3 (gva_eval.cu): the
// pe-MLP's (Nq*S, C) x (C, C) product is 2*S*C^2 operations per query.
// The design is K3's first four stages (one block of 128 threads holds TQ
// queries with TQ*C ~ 384 and their S gathered neighbours; pe1 and the
// relation live in shared memory as their bf16 roundings; Wp2 and W1 stay
// in L2-resident device memory), run by a persistent grid: each block
// walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... and keeps its 2G+13
// sums in shared memory, written once as one row of partial sums. The
// wrapper adds the rows in f64, so no f32 atomics chain into one scalar.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void load4(const bf16* p, float& a, float& b,
                                      float& c, float& d) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  a = lo.x;
  b = lo.y;
  c = hi.x;
  d = hi.y;
}

constexpr int kThreads = 128;
constexpr int kTileWork = 384;  // TQ * C per block, as in gva_eval.cu

__host__ __device__ inline int tile_queries(int C) {
  return C >= kTileWork ? 1 : kTileWork / C;
}

template <int S>
__global__ void __launch_bounds__(kThreads) gva_stats_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7)
    const int* __restrict__ idx,        // (B, Nq, S)
    const uint8_t* __restrict__ valid,  // (B, Nq, S)
    const bf16* __restrict__ A,         // (3, C)
    const float* __restrict__ cA,       // (C)
    const bf16* __restrict__ Wp2,       // (C, C) [in, out]
    const float* __restrict__ bp2,      // (C)
    const bf16* __restrict__ W1,        // (C, G) unfolded
    const float* __restrict__ b1,       // (G)
    float* __restrict__ part,           // (gridDim.x, 2G + 13)
    int B, int Nsrc, int Nq, int C, int G) {
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const int rw = 2 * C + 6;
  const int qw = C + 7;
  const int P = 2 * G + 13;
  const int ntq = (Nq + TQ - 1) / TQ;
  const int ntiles = B * ntq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tt = reinterpret_cast<float*>(smem_raw);  // R*G
  float* pos = tt + R * G;                         // R*4, f32 (unrounded)
  float* vld = pos + R * 4;                        // R
  float* acc = vld + R;                            // P
  int* rid = reinterpret_cast<int*>(acc + P);      // R
  bf16* pe1 = reinterpret_cast<bf16*>(rid + R + ((R * G + 5 * R + P + R) & 1));
  bf16* rr = pe1 + R * C;                          // R*C
  const int tid = threadIdx.x;

  for (int e = tid; e < P; e += kThreads) acc[e] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / ntq;
    const int q0 = (tile - b * ntq) * TQ;
    const bf16* srcb = src + (size_t)b * Nsrc * rw;

    // 0: slot rows, validity and relative positions
    for (int e = tid; e < R; e += kThreads) {
      const int q = q0 + e / S;
      float v = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
      int id = 0;
      if (q < Nq) {
        const size_t o = ((size_t)b * Nq + q) * S + e % S;
        id = min(max(idx[o], 0), Nsrc - 1);
        v = valid[o] ? 1.f : 0.f;
        const bf16* kc = srcb + (size_t)id * rw + 2 * C;
        const bf16* qc = qrow + ((size_t)b * Nq + q) * qw + C;
        p0 = ((bf(kc[0]) + bf(kc[3])) - (bf(qc[0]) + bf(qc[3]))) * v;
        p1 = ((bf(kc[1]) + bf(kc[4])) - (bf(qc[1]) + bf(qc[4]))) * v;
        p2 = ((bf(kc[2]) + bf(kc[5])) - (bf(qc[2]) + bf(qc[5]))) * v;
      }
      rid[e] = id;
      vld[e] = v;
      pos[4 * e + 0] = p0;
      pos[4 * e + 1] = p1;
      pos[4 * e + 2] = p2;
    }
    __syncthreads();

    // 1: pe1 = relu((pos @ A + cA) * valid), kept as its bf16 rounding
    for (int e = tid; e < R * C; e += kThreads) {
      const int r = e / C, j = e - r * C;
      const float a = rbf(pos[4 * r]) * bf(A[j]) +
                      rbf(pos[4 * r + 1]) * bf(A[C + j]) +
                      rbf(pos[4 * r + 2]) * bf(A[2 * C + j]);
      pe1[e] = __float2bfloat16_rn(fmaxf((a + cA[j]) * vld[r], 0.f));
    }
    __syncthreads();

    // 2: per (query, channel c): peb of the S slots, then the relation
    for (int e = tid; e < TQ * C; e += kThreads) {
      const int qi = e / C, c = e - qi * C;
      const int q = q0 + qi;
      float a[S];
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] = 0.f;
      const bf16* p = pe1 + (size_t)qi * S * C;
      for (int j = 0; j < C; j += 4) {
        const float w0 = bf(Wp2[(size_t)(j + 0) * C + c]);
        const float w1 = bf(Wp2[(size_t)(j + 1) * C + c]);
        const float w2 = bf(Wp2[(size_t)(j + 2) * C + c]);
        const float w3 = bf(Wp2[(size_t)(j + 3) * C + c]);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float x0, x1, x2, x3;
          load4(p + s * C + j, x0, x1, x2, x3);
          a[s] += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
        }
      }
      const float qv = q < Nq ? bf(qrow[((size_t)b * Nq + q) * qw + c]) : 0.f;
      const float bias = bp2[c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        rr[(size_t)r * C + c] =
            __float2bfloat16_rn(bf(srcb[(size_t)rid[r] * rw + c]) - qv + a[s] + bias);
      }
    }
    __syncthreads();

    // 3: t = (relation @ W1 + b1) * valid
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, g = e - r * G;
      const bf16* x = rr + (size_t)r * C;
      float a = 0.f;
      for (int j = 0; j < C; j += 4) {
        float x0, x1, x2, x3;
        load4(x + j, x0, x1, x2, x3);
        a += x0 * bf(W1[(size_t)(j + 0) * G + g]) +
             x1 * bf(W1[(size_t)(j + 1) * G + g]) +
             x2 * bf(W1[(size_t)(j + 2) * G + g]) +
             x3 * bf(W1[(size_t)(j + 3) * G + g]);
      }
      tt[e] = (a + b1[g]) * vld[r];
    }
    __syncthreads();

    // 4: this tile's sums: [sum t | sum t^2 | count | sum pos | sum pos pos^T]
    for (int e = tid; e < P; e += kThreads) {
      float a = 0.f;
      if (e < 2 * G) {
        const int g = e < G ? e : e - G;
        for (int r = 0; r < R; ++r) {
          const float x = tt[r * G + g];
          a += e < G ? x * vld[r] : x * x * vld[r];
        }
      } else if (e == 2 * G) {
        for (int r = 0; r < R; ++r) a += vld[r];
      } else if (e < 2 * G + 4) {
        const int i = e - 2 * G - 1;
        for (int r = 0; r < R; ++r) a += pos[4 * r + i];
      } else {
        const int ij = e - 2 * G - 4, i = ij / 3, j = ij - 3 * i;
        for (int r = 0; r < R; ++r) a += pos[4 * r + i] * pos[4 * r + j];
      }
      acc[e] += a;
    }
    __syncthreads();
  }
  for (int e = tid; e < P; e += kThreads) part[(size_t)blockIdx.x * P + e] = acc[e];
}

}  // namespace

extern "C" int gva_stats_launch(const void* src, const void* qrow,
                                const void* idx, const void* valid,
                                const void* A, const void* cA, const void* Wp2,
                                const void* bp2, const void* W1,
                                const void* b1, void* part, int B, int Nsrc,
                                int Nq, int S, int C, int G, int nblk,
                                void* stream) {
  if (C % 4 != 0 || G < 1 || C % G != 0 || Nsrc < 1 || nblk < 1)
    return cudaErrorInvalidValue;
  // S = 16, the neighbours of every stage of the S3DIS config
  if (S != 16) return cudaErrorInvalidValue;
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const int P = 2 * G + 13;
  const size_t smem = sizeof(float) * ((size_t)R * G + 5 * R + P + 1) +
                      sizeof(int) * R + 2 * sizeof(bf16) * (size_t)R * C;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gva_stats_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  gva_stats_kernel<16><<<nblk, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const float*)bp2, (const bf16*)W1, (const float*)b1,
      (float*)part, B, Nsrc, Nq, C, G);
  return cudaGetLastError();
}
