// K3: eval-mode grouped vector attention (PT-v2m2) with in-kernel gathers.
//
// Replaces both eval GVA kernels of ao_tpu:
//   K3a ops/pallas/gva_slab.py  (gva_slab_core_eval -> _fwd_kernel,
//       pallas_call in _run at :432) -- Morton-sorted rows, window graph;
//   K3b ops/pallas/gva_fused.py (gva_core_eval -> _fwd_kernel,
//       pallas_call in _run at :419) -- pre-gathered rows.
// Hopper has a real row gather, so one kernel serves both: it takes the
// (B, Nsrc, 2C+6) source rows [k | v | coord hi3 | coord lo3] (sorted or
// not), the (B, Nq, S) neighbour ids into them and their validity, and
// gathers each neighbour row directly. Per query n and slot s (v = valid):
//   pos  = ((khi + klo) - (qhi + qlo)) * v
//   pe1  = relu((bf16(pos) @ bf16(A) + cA) * v)
//   peb  = bf16(pe1) @ bf16(Wp2) + bp2
//   t    = (bf16(k - q + peb) @ bf16(W1f) + b1f) * v
//   w    = relu(t) @ W2 + b2
//   sm   = softmax over the valid slots of each group (masked before exp)
//   out  = mrow * sum_s (v + peb) * sm[group of channel]
// with f32 accumulation and the bf16 operand rounding of the TPU kernel's
// _mm_bf16 products. The softmax shift is the per-(query, group) maximum
// (the TPU kernel shifts by its tile maximum; softmax is shift-invariant).
//
// What bounds it on the card: arithmetic. The pe-MLP's second layer is a
// (Nq*S, C) x (C, C) product, 2*S*C^2 operations per query, against
// S*(2C+6)*2 bytes of gathered rows: about C/2 operations per byte, far
// above the card's balance point at C = 48..384.
// What the design does about it (a simple first design, on CUDA cores in
// f32 over bf16-rounded operands, not yet on tensor cores): a block holds
// TQ queries with TQ*C ~ 384 and their S neighbours. pe1 and the relation
// live in shared memory as bf16 (they are bf16-rounded operands anyway)
// and v+peb as f32: 8*S*TQ*C bytes, ~49 KB, so four blocks fit an SM. The
// folded weights do not: Wp2 alone is 288 KB in bf16 at C = 384, over the
// 227 KB a block may use. So Wp2, W1f and the small f32 weights stay in
// device memory, read through the L1/L2 caches (all blocks share them, so
// they stay L2-resident); each thread owns one (query, channel) pair and
// keeps S accumulators in registers, reading Wp2[j, c] once per four
// input channels j for all S slots of its query.

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
constexpr int kTileWork = 384;  // TQ * C per block

__host__ __device__ inline int tile_queries(int C) {
  return C >= kTileWork ? 1 : kTileWork / C;
}

template <int S>
__global__ void __launch_bounds__(kThreads) gva_eval_kernel(
    const bf16* __restrict__ src,      // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,     // (B, Nq, C+7) [q | hi3 | lo3 | mask]
    const int* __restrict__ idx,       // (B, Nq, S)
    const uint8_t* __restrict__ valid, // (B, Nq, S)
    const bf16* __restrict__ A,        // (3, C)
    const float* __restrict__ cA,      // (C)
    const bf16* __restrict__ Wp2,      // (C, C)  [in, out]
    const float* __restrict__ bp2,     // (C)
    const bf16* __restrict__ W1f,      // (C, G)
    const float* __restrict__ b1f,     // (G)
    const float* __restrict__ W2,      // (G, G)
    const float* __restrict__ b2,      // (G)
    float* __restrict__ out,           // (B, Nq, C)
    int Nsrc, int Nq, int C, int G) {
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const int rw = 2 * C + 6;
  const int qw = C + 7;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v2 = reinterpret_cast<float*>(smem_raw);  // R*C
  float* tt = v2 + R * C;                          // R*G: t, then softmax
  float* ww = tt + R * G;                          // R*G
  float* pos = ww + R * G;                         // R*4
  float* vld = pos + R * 4;                        // R
  float* mrow = vld + R;                           // TQ
  int* rid = reinterpret_cast<int*>(mrow + TQ);    // R
  bf16* pe1 = reinterpret_cast<bf16*>(rid + R + ((R + TQ) & 1));  // R*C
  bf16* rr = pe1 + R * C;                                          // R*C

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
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
    pos[4 * e + 0] = rbf(p0);
    pos[4 * e + 1] = rbf(p1);
    pos[4 * e + 2] = rbf(p2);
  }
  for (int qi = tid; qi < TQ; qi += kThreads) {
    const int q = q0 + qi;
    mrow[qi] = q < Nq ? bf(qrow[((size_t)b * Nq + q) * qw + C + 6]) : 0.f;
  }
  __syncthreads();

  // 1: pe1 = relu((pos @ A + cA) * valid), kept as its bf16 rounding
  for (int e = tid; e < R * C; e += kThreads) {
    const int r = e / C, j = e - r * C;
    const float a = pos[4 * r] * bf(A[j]) + pos[4 * r + 1] * bf(A[C + j]) +
                    pos[4 * r + 2] * bf(A[2 * C + j]);
    pe1[e] = __float2bfloat16_rn(fmaxf((a + cA[j]) * vld[r], 0.f));
  }
  __syncthreads();

  // 2: per (query, channel c): peb of the S slots, then relation and v+peb
  for (int e = tid; e < TQ * C; e += kThreads) {
    const int qi = e / C, c = e - qi * C;
    const int q = q0 + qi;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
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
        acc[s] += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
      }
    }
    const float qv = q < Nq ? bf(qrow[((size_t)b * Nq + q) * qw + c]) : 0.f;
    const float bias = bp2[c];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = qi * S + s;
      const bf16* row = srcb + (size_t)rid[r] * rw;
      const float peb = acc[s] + bias;
      rr[(size_t)r * C + c] = __float2bfloat16_rn(bf(row[c]) - qv + peb);
      v2[(size_t)r * C + c] = bf(row[C + c]) + peb;
    }
  }
  __syncthreads();

  // 3: t = (relation @ W1f + b1f) * valid
  for (int e = tid; e < R * G; e += kThreads) {
    const int r = e / G, g = e - r * G;
    const bf16* x = rr + (size_t)r * C;
    float a = 0.f;
    for (int j = 0; j < C; j += 4) {
      float x0, x1, x2, x3;
      load4(x + j, x0, x1, x2, x3);
      a += x0 * bf(W1f[(size_t)(j + 0) * G + g]) +
           x1 * bf(W1f[(size_t)(j + 1) * G + g]) +
           x2 * bf(W1f[(size_t)(j + 2) * G + g]) +
           x3 * bf(W1f[(size_t)(j + 3) * G + g]);
    }
    tt[e] = (a + b1f[g]) * vld[r];
  }
  __syncthreads();

  // 4: w = relu(t) @ W2 + b2
  for (int e = tid; e < R * G; e += kThreads) {
    const int r = e / G, g = e - r * G;
    float a = 0.f;
    for (int h = 0; h < G; ++h) a += fmaxf(tt[r * G + h], 0.f) * W2[h * G + g];
    ww[e] = a + b2[g];
  }
  __syncthreads();

  // 5: softmax over the S slots of each (query, group), masked before exp
  for (int e = tid; e < TQ * G; e += kThreads) {
    const int qi = e / G, g = e - qi * G;
    float mx = -1e30f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = qi * S + s;
      mx = fmaxf(mx, vld[r] > 0.f ? ww[r * G + g] : -1e30f);
    }
    float z[S];
    float Z = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = qi * S + s;
      const float wm = vld[r] > 0.f ? ww[r * G + g] : -1e30f;
      z[s] = __expf(fmaxf(wm - mx, -80.f)) * vld[r];
      Z += z[s];
    }
    const float inv = 1.f / fmaxf(Z, 1e-30f);
#pragma unroll
    for (int s = 0; s < S; ++s) tt[(qi * S + s) * G + g] = z[s] * inv;
  }
  __syncthreads();

  // 6: out = mrow * sum_s (v + peb) * softmax of the channel's group
  const int K = C / G;
  for (int e = tid; e < TQ * C; e += kThreads) {
    const int qi = e / C, c = e - qi * C;
    const int q = q0 + qi;
    if (q >= Nq) continue;
    const int g = c / K;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = qi * S + s;
      a += v2[(size_t)r * C + c] * tt[r * G + g];
    }
    out[((size_t)b * Nq + q) * C + c] = a * mrow[qi];
  }
}

template <int S>
cudaError_t launch(const void* src, const void* qrow, const void* idx,
                   const void* valid, const void* A, const void* cA,
                   const void* Wp2, const void* bp2, const void* W1f,
                   const void* b1f, const void* W2, const void* b2, void* out,
                   int B, int Nsrc, int Nq, int C, int G, cudaStream_t stream) {
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const size_t smem = sizeof(float) * ((size_t)R * C + 2 * R * G + 5 * R +
                                       TQ + ((R + TQ) & 1)) +
                      sizeof(int) * R + 2 * sizeof(bf16) * R * C;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gva_eval_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Nq + TQ - 1) / TQ, B);
  gva_eval_kernel<S><<<grid, kThreads, smem, stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const float*)bp2, (const bf16*)W1f,
      (const float*)b1f, (const float*)W2, (const float*)b2, (float*)out, Nsrc,
      Nq, C, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gva_eval_launch(const void* src, const void* qrow,
                               const void* idx, const void* valid,
                               const void* A, const void* cA, const void* Wp2,
                               const void* bp2, const void* W1f,
                               const void* b1f, const void* W2, const void* b2,
                               void* out, int B, int Nsrc, int Nq, int S, int C,
                               int G, void* stream) {
  if (C % 4 != 0 || G < 1 || C % G != 0 || Nsrc < 1) return cudaErrorInvalidValue;
  if (B == 0 || Nq == 0) return cudaSuccess;
  // S = 16, the neighbours of every stage of the S3DIS config; a config
  // with other counts (ScanNet's patch embedding has 8) adds an instance
  if (S != 16) return cudaErrorInvalidValue;
  return launch<16>(src, qrow, idx, valid, A, cA, Wp2, bp2, W1f, b1f, W2, b2,
                    out, B, Nsrc, Nq, C, G, (cudaStream_t)stream);
}
