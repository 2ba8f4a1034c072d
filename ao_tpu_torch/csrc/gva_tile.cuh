// Shared tensor-core tile routine of the GVA kernels (K3 gva_eval.cu, K5
// gva_stats.cu, K6 gva_bwd.cu).
//
// A tile is R edges: TQ queries x S = 16 neighbour slots, R = 128 (TQ = 8)
// at C <= 96 and R = 64 (TQ = 4) at C >= 192, so every row-by-weight
// product has m >= 64 whatever the width. Per tile the recompute that K3,
// K5 and K6 share (the attention forward up to the weight encoding's first
// layer) is
//   gather   rows of the S neighbours by id, validity v
//   pos      ((khi + klo) - (qhi + qlo)) * v                  CUDA cores, f32
//   pe1      relu((bf16(pos) @ bf16(A) + cA) * v)             CUDA cores (K = 3)
//   peb      bf16(pe1) @ bf16(Wp2) + bp2                      tensor cores
//   r        k - q + peb
//   t        (bf16(r) @ bf16(W1x) + b1x) * v                  tensor cores
// with the bf16 operands and f32 accumulation of the TPU kernels'
// _mm_bf16 products. Tensor-core products are mma.sync m16n8k16 (bf16 in,
// f32 accumulate) on fragments read by ldmatrix (.trans for operands
// stored K-major), or built in registers where an operand is computed on
// the fly. The weights are staged in shared memory once per block (Wp2
// whole at C <= 192, W1x transposed and zero-padded to Gp = 16k columns);
// at C = 384 Wp2 (288 KB) does not fit and the products stream it through
// a two-stage ring of 16-row slabs filled by cp.async. bf16 tiles keep a
// row pitch of C + 8 elements, so the 8 rows of an ldmatrix hit distinct
// banks. Everything here is inline and in an anonymous namespace: three
// translation units of one library include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kS = 16;        // neighbour slots (every stage of the config)
constexpr int kWarps = 8;     // warps per block of K5 and K6
constexpr int kThreads = 32 * kWarps;
constexpr int kSlab = 16;     // rows of a streamed Wp2 slab

// compile-time shape of a tile at width C (group width C / G = 8)
template <int C_>
struct Tile {
  static constexpr int C = C_;
  static constexpr int G = C / 8;
  static constexpr int TQ = C <= 96 ? 8 : 4;
  static constexpr int R = TQ * kS;
  static constexpr int Gp = (G + 15) / 16 * 16;  // G padded for k = 16
  static constexpr int ldc = C + 8;               // pitch of R x C bf16 tiles
  static constexpr int ldg = Gp + 8;              // pitch of R x Gp bf16 tiles
  static constexpr bool kStream = C > 192;        // Wp2 streamed, not resident
  // n8 tiles per warp strip of an (R x C) product: one strip per warp
  static constexpr int NWC = (C / 8) * (R / 16) / kWarps;
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// x summed over the lanes that differ from this one in the bits lo..hi
__device__ __forceinline__ float xor_sum(float x, int lo, int hi) {
  for (int o = lo; o <= hi; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the same into a fresh accumulator, then added to c by an f32 add: the
// recompute's products (peb, t) take it, so that their sums track the
// plain version's f32 sums as closely as an FMA chain does (the tensor
// cores' own accumulation truncates, and bf16(relation) and the gate t > 0
// turn a last-bit difference into a whole step)
__device__ __forceinline__ void mma16816_split(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma16816(p, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
// 4-byte copy, for rows that are only 4-byte aligned (through L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------- fragment loads
// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4): A holds rows
// g, g + 8 at columns 2q, 2q + 1 (+8); B holds k = 2q, 2q + 1 (+8) at
// column g; the accumulator holds rows g, g + 8 at columns 2q, 2q + 1.

// A (16 x 16) at (m0, k0) of X stored row-major X[m][k]
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X, int ld,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, X + (size_t)(m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
// A (16 x 16) at (m0, k0) of A = X^T, X stored X[k][m]
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const bf16* X, int ld,
                                        int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, X + (size_t)(k0 + (l & 7) + (l >> 4) * 8) * ld + m0 +
                   ((l >> 3) & 1) * 8);
}
// B (16 x 8) at (k0, n0) of X stored X[k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2], const bf16* X, int ld,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x2_t(b, X + (size_t)(k0 + (l & 15)) * ld + n0);
}
// two B fragments, at (k0, n0) and (k0, n0 + 8), of X stored X[k][n]
__device__ __forceinline__ void frag_b2_kn(uint32_t (&b)[4], const bf16* X, int ld,
                                           int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, X + (size_t)(k0 + (l & 15)) * ld + n0 + (l >> 4) * 8);
}
// two B fragments, at (k0, n0) and (k0, n0 + 8), of B = X^T, X stored X[n][k]
__device__ __forceinline__ void frag_b2_nk(uint32_t (&b)[4], const bf16* X, int ld,
                                           int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, X + (size_t)(n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
}
// B (16 x 8) at (k0, n0) of B = X^T, X stored X[n][k]
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2], const bf16* X, int ld,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x2(b, X + (size_t)(n0 + (l & 7)) * ld + k0 + ((l >> 3) & 1) * 8);
}

// p[0..1] += (a, b): one vector reduction in device memory (8-byte aligned)
__device__ __forceinline__ void red2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// two mma on the B fragment pair b2 (n8 tiles j and j + 1 of a strip)
template <bool kSplit, int NW>
__device__ __forceinline__ void mma_pair(float (&acc)[NW][4], int j, const uint32_t (&a)[4],
                                         const uint32_t (&b2)[4]) {
  const uint32_t b0[2] = {b2[0], b2[1]}, b1[2] = {b2[2], b2[3]};
  if constexpr (kSplit) {
    mma16816_split(acc[j], a, b0);
    mma16816_split(acc[j + 1], a, b1);
  } else {
    mma16816(acc[j], a, b0);
    mma16816(acc[j + 1], a, b1);
  }
}

// --------------------------------------------------------- block products

// f(row, col, acc[col], acc[col + 1]) for every accumulator pair of a warp's
// 16 x 8NW strip at (m0, n0)
template <int NW, class F>
__device__ __forceinline__ void each_pair(const float (&acc)[NW][4], int m0,
                                          int n0, F f) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = n0 + 8 * j + 2 * q;
    f(m0 + g, c, acc[j][0], acc[j][1]);
    f(m0 + g + 8, c, acc[j][2], acc[j][3]);
  }
}

// The block's warps walk the MT x NS strips (16 rows x 8NW columns) of an
// M x N product over depth K; fa(a, m0, k0) and fb(b, k0, n0) give the
// operand fragments, fe(m0, n0, acc) takes each finished strip.
template <int NW, int MT, int NS, int K, bool kSplit = false, class FA, class FB,
          class FE>
__device__ __forceinline__ void tile_mm(FA fa, FB fb, FE fe) {
  for (int s = threadIdx.x >> 5; s < MT * NS; s += kWarps) {
    const int m0 = (s % MT) * 16, n0 = (s / MT) * (8 * NW);
    float acc[NW][4];
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      fa(a, m0, k0);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        uint32_t b[2];
        fb(b, k0, n0 + 8 * j);
        if constexpr (kSplit) mma16816_split(acc[j], a, b);
        else mma16816(acc[j], a, b);
      }
    }
    fe(m0, n0, acc);
  }
}

// An (R x C) x (C x C) product against Wp2 (kNK false: B = Wp2, the
// recompute's peb) or its transpose (kNK true: B = Wp2^T, the backward's
// dpe0), one 16 x 8NWC strip per warp; kSplit picks the split accumulation
// (by default for peb: K5 and K6 take it, K3 does not need it). Resident
// (by default C <= 192): Wsm holds Wp2 [in][out] at pitch ldc. Streamed
// (kStream; by default C = 384, and K3's C = 192): Wg is B itself in device
// memory, K x N row-major (Wp2, or Wp2^T for kNK), copied 16 rows at a
// time into the two-stage ring while the previous slab is multiplied.
// Every thread of the block must call it.
template <class T, bool kNK, bool kSplit = !kNK, bool kStream = T::kStream, class FA,
          class FE>
__device__ __forceinline__ void mm_wp2(const bf16* Wsm, const bf16* __restrict__ Wg,
                                       bf16* ring, FA fa, FE fe) {
  constexpr int NW = T::NWC, MT = T::R / 16, C = T::C, ld = T::ldc;
  static_assert(MT * (C / 8 / NW) == kWarps && NW % 2 == 0, "one strip per warp");
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp % MT) * 16, n0 = (warp / MT) * (8 * NW);
  float acc[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if constexpr (!kStream) {
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[4];
      fa(a, m0, k0);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t b[4];
        if constexpr (kNK) frag_b2_nk(b, Wsm, ld, k0, n0 + 8 * j);
        else frag_b2_kn(b, Wsm, ld, k0, n0 + 8 * j);
        mma_pair<kSplit>(acc, j, a, b);
      }
    }
  } else {
    constexpr int NSL = C / kSlab, CH = C / 8;  // slabs, 16-byte chunks a row
    auto load = [&](int s) {
      bf16* dst = ring + (s & 1) * kSlab * ld;
      const bf16* src = Wg + (size_t)s * kSlab * C;
      for (int i = threadIdx.x; i < kSlab * CH; i += kThreads) {
        const int r = i / CH, c = (i - r * CH) * 8;
        cp_async16(dst + r * ld + c, src + (size_t)r * C + c);
      }
      cp_async_commit();
    };
    load(0);
    for (int s = 0; s < NSL; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slab s landed; every warp is done with slab s - 1
      if (s + 1 < NSL) load(s + 1);
      const bf16* st = ring + (s & 1) * kSlab * ld;
      uint32_t a[4];
      fa(a, m0, s * kSlab);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t b[4];
        frag_b2_kn(b, st, ld, 0, n0 + 8 * j);
        mma_pair<kSplit>(acc, j, a, b);
      }
    }
    __syncthreads();  // the ring is free again
  }
  fe(m0, n0, acc);
}

// ----------------------------------------------------- staging, recompute

// dst[j * ldc + c] = W[j * C + c]: the C x C weight, resident (C <= 192)
template <class T>
__device__ __forceinline__ void stage_square(bf16* dst, const bf16* __restrict__ W) {
  constexpr int C = T::C, CH = C / 8;
  for (int i = threadIdx.x; i < C * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * T::ldc + c) =
        *reinterpret_cast<const uint4*>(W + (size_t)r * C + c);
  }
}

// dst[g * ldc + c] = W1[c * G + g] for g < G, zero for G <= g < Gp: the
// (C, G) weight transposed, so that it serves as B = W1 (k = c) and as
// B = W1^T (k = g) through ldmatrix
template <class T>
__device__ __forceinline__ void stage_w1t(bf16* dst, const bf16* __restrict__ W1) {
  constexpr int C = T::C, G = T::G;
  for (int i = threadIdx.x; i < T::Gp * C; i += kThreads) {
    const int g = i / C, c = i - g * C;
    dst[g * T::ldc + c] = g < G ? W1[(size_t)c * G + g] : __float2bfloat16_rn(0.f);
  }
}

// 0: slot rows (ids clamped into the source), validity and the f32
// relative positions of the tile's R edges; queries past Nq are invalid
template <class T>
__device__ __forceinline__ void gather_slots(
    const bf16* __restrict__ srcb, const bf16* __restrict__ qrow,
    const int* __restrict__ idx, const uint8_t* __restrict__ valid, int b,
    int q0, int Nsrc, int Nq, int* rid, float* vld, float* pos) {
  constexpr int C = T::C, rw = 2 * C + 6, qw = C + 7;
  for (int e = threadIdx.x; e < T::R; e += kThreads) {
    const int q = q0 + e / kS;
    float v = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
    int id = 0;
    if (q < Nq) {
      const size_t o = ((size_t)b * Nq + q) * kS + e % kS;
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
}

// 1: pe1 = relu((bf16(pos) @ bf16(A) + cA) * v), kept as its bf16 rounding
// (pe1 > 0 exactly where the pre-activation pe0 > 0 on a valid edge)
template <class T>
__device__ __forceinline__ void pe1_rows(const bf16* __restrict__ A,
                                         const float* __restrict__ cA,
                                         const float* pos, const float* vld,
                                         bf16* pe1b) {
  constexpr int C = T::C;
  for (int e = threadIdx.x; e < T::R * C / 2; e += kThreads) {
    const int r = e / (C / 2), j = (e - r * (C / 2)) * 2;
    const float x = rbf(pos[4 * r]), y = rbf(pos[4 * r + 1]), z = rbf(pos[4 * r + 2]);
    float o[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      o[u] = fmaxf((x * bf(A[j + u]) + y * bf(A[C + j + u]) + z * bf(A[2 * C + j + u]) +
                    cA[j + u]) * vld[r], 0.f);
    *reinterpret_cast<uint32_t*>(pe1b + r * T::ldc + j) = pack2(o[0], o[1]);
  }
}

// 3: t = (bf16(r) @ bf16(W1x) + b1x) * v into tt (R x G, f32, row pitch
// ldt), from the relation rr (R x C bf16) and W1x staged transposed
// (stage_w1t); split accumulation unless kSplit is false; the Gp columns
// in NS strips, so that NS x R / 16 warps share the product
template <class T, int ldt = T::G, bool kSplit = true, int NS = 1>
__device__ __forceinline__ void t_rows(const bf16* rr, const bf16* w1t,
                                       const float* __restrict__ b1,
                                       const float* vld, float* tt) {
  constexpr int G = T::G;
  static_assert(G % 2 == 0, "column pairs stay inside G");
  static_assert(T::Gp / 8 % NS == 0, "whole n8 tiles a strip");
  tile_mm<T::Gp / 8 / NS, T::R / 16, NS, T::C, kSplit>(
      [&](uint32_t(&a)[4], int m0, int k0) { frag_a(a, rr, T::ldc, m0, k0); },
      [&](uint32_t(&b)[2], int k0, int n0) { frag_b_nk(b, w1t, T::ldc, k0, n0); },
      [&](int m0, int n0, auto& acc) {
        each_pair(acc, m0, n0, [&](int r, int c, float x0, float x1) {
          if (c < G) {
            tt[r * ldt + c] = (x0 + b1[c]) * vld[r];
            tt[r * ldt + c + 1] = (x1 + b1[c + 1]) * vld[r];
          }
        });
      });
}

}  // namespace
