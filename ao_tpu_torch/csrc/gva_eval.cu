// K3: grouped vector attention forward (PT-v2m2) with folded BatchNorms.
//
// Replaces the forward kernels of ao_tpu, in both call modes:
//   ops/pallas/gva_slab.py  _fwd_kernel :263, reached through
//       gva_slab_core_eval :547 (eval: running statistics) and gva_slab_core
//       :451 (train: batch-statistic folds); pallas_call in _run at :430 --
//       Morton-sorted rows, window graph;
//   ops/pallas/gva_fused.py _fwd_kernel :276, reached through gva_core_eval
//       :563 and gva_core :441; pallas_call in _run at :417 -- pre-gathered
//       rows.
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
// What bounds it on the card: operations. Per query the products with bf16
// operands take 2 S (3C + C^2 + C G) operations on tensor cores (the pe-MLP's
// C x C second layer is most of it) and the G x G product, softmax and
// elementwise steps S (2 G^2 + 8C + 6G) in f32, against about 10C + 100
// bytes if every row is read once: at C = 48 the operations' least time is
// about 1.2x the bytes', and the ratio grows with C.
// What the design does about it: the tile routine of gva_tile.cuh, as K5
// and K6 use it, with every product but the f32 G x G one on tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulated by the tensor cores: the
// output is continuous in t, so unlike K6's gates it needs no sums that
// track the plain version's FMA chains). A persistent grid (as many
// 256-thread blocks as the SMs hold: 4 at C = 48, 2 at C = 96 and 192, 1
// at C = 384 and 512) walks tiles of R = 128 edges (C <= 96), 64 (C = 192,
// 384) or 32 (C = 512).
// W1f^T, W2 (f32), A and cA are staged in shared memory once per block,
// Wp2 too at C <= 96; at C >= 192 Wp2 streams through a cp.async ring of
// 16-row slabs (at C = 192 a resident Wp2, 77 KB, would leave room for one
// block per SM). At C >= 96 the neighbour rows' k and v are copied to
// shared memory by cp.async while pe1 and the peb product run (at C = 48
// four blocks an SM hide the epilogue's own reads). Each warp owns a strip
// of 16 rows, one query's 16 slots, by 8 NWC channels, NWC whole 8-channel
// groups, in every (R x C) product:
//   pe0   one k16 step whose fragments are built in registers (K = 3,
//         zero-padded), then pe1 = relu((pe0 + cA) v) as bf16;
//   peb   the relation written as bf16 to shared memory, v + peb kept in
//         f32 in the warp's registers through t and the tail, so it never
//         touches shared memory (at C = 384 an f32 tile of it would need
//         98 KB more than the 227 KB a block may use);
//   t     (R x G) one 16-row strip per warp too: at C >= 192 the G columns
//         in 8 / (R / 16) strips per 16 rows;
//   tail  in the warp, on its own query and groups, with no block
//         barrier: w = relu(t) W2 + b2 in f32 on CUDA cores (one lane per
//         slot and NWC / 2 groups), the masked softmax over the 16 slots
//         by lane shuffles, then the weighted sum over the slots, whose
//         reduction over the fragment's 8 row lanes is a reduce-scatter.

#include "gva_tile.cuh"

namespace {

template <int C>
struct Eval {
  using T = Tile<C>;
  static constexpr int G = T::G, R = T::R, ld = T::ldc;
  // row pitch of the f32 t tile: ldt / 2 odd, so that the float2 reads of
  // a warp's 16 rows fall in distinct banks
  static constexpr int ldt = (G / 2) % 2 ? G : G + 2;
  static constexpr int NWC = T::NWC;  // groups of a warp's strip
  static constexpr int NG = NWC / 2;  // groups of a lane in the tail
  // Wp2 streamed at C >= 192: at C = 192 the ring (13 KB in place of the
  // resident 77 KB) lets two blocks share an SM
  static constexpr bool kStream = C >= 192;
  // C >= 96: the rows' k and v copied to shared memory ahead of the peb
  // epilogue; at C = 48 four blocks an SM hide the epilogue's own row
  // reads, and the copy costs more than it saves
  static constexpr bool kPrefetch = C >= 96;
  static_assert(NWC % 2 == 0 && T::R / 16 * (C / 8 / NWC) == kWarps,
                "a warp's strip is one query by whole groups");
  // the rows' v (kPrefetch) and, after the epilogue, the f32 t tile share
  // one region
  static_assert(2 * ldt <= ld, "the t tile fits in the v tile it reuses");
  static constexpr size_t vt_bytes =
      kPrefetch ? sizeof(bf16) * R * ld : sizeof(float) * R * ldt;
  // pe0's B operand: bf16 pairs (A[0][c], A[1][c]), then (A[2][c], 0) at
  // an offset of C + 8 words (distinct banks)
  static constexpr int lda = C + 8;
  static constexpr size_t smem =
      sizeof(bf16) * ((2 * R + (kStream ? 2 * kSlab : C) + T::Gp) * (size_t)ld) +
      vt_bytes + sizeof(float) * (G * G + 5 * R + C) + sizeof(uint32_t) * 2 * lda +
      sizeof(int) * R;
};

// x[0..N) = p[0..N), by 16- or 8-byte loads where N allows
template <int N>
__device__ __forceinline__ void lds_row(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 u = reinterpret_cast<const float4*>(p)[k];
      x[4 * k] = u.x;
      x[4 * k + 1] = u.y;
      x[4 * k + 2] = u.z;
      x[4 * k + 3] = u.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float2 u = reinterpret_cast<const float2*>(p)[k];
      x[2 * k] = u.x;
      x[2 * k + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = p[k];
  }
}

// y[i] (i < V / 2) += the partner's (lane ^ M) value of the half this lane
// keeps: lanes with bit M clear keep y[0 .. V/2), the others y[V/2 .. V),
// moved down to y[0 .. V/2)
template <int V, int M, int N>
__device__ __forceinline__ void reduce_scatter(float (&y)[N], int lane) {
  static_assert(V % 2 == 0 && V <= N, "halves of the values held");
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float keep = hi ? y[i + V / 2] : y[i];
    const float send = hi ? y[i] : y[i + V / 2];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, C == 48 ? 4 : C <= 192 ? 2 : 1) gva_eval_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7) [q | hi3 | lo3 | mask]
    const int* __restrict__ idx,        // (B, Nq, S)
    const uint8_t* __restrict__ valid,  // (B, Nq, S)
    const bf16* __restrict__ A,         // (3, C)
    const float* __restrict__ cA,       // (C)
    const bf16* __restrict__ Wp2,       // (C, C) [in, out]
    const float* __restrict__ bp2,      // (C)
    const bf16* __restrict__ W1f,       // (C, G)
    const float* __restrict__ b1f,      // (G)
    const float* __restrict__ W2,       // (G, G)
    const float* __restrict__ b2,       // (G)
    float* __restrict__ out,            // (B, Nq, C)
    int B, int Nsrc, int Nq) {
  using E = Eval<C>;
  using T = typename E::T;
  constexpr int G = E::G, R = E::R, TQ = T::TQ, ld = E::ld, ldt = E::ldt;
  constexpr int NWC = E::NWC, NG = E::NG, MT = R / 16;
  constexpr int rw = 2 * C + 6, qw = C + 7;
  const int ntq = (Nq + TQ - 1) / TQ;
  const int ntiles = B * ntq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pe1b = reinterpret_cast<bf16*>(smem_raw);  // R x ld: bf16(pe1)
  bf16* rr = pe1b + R * ld;   // R x ld: (the rows' k, then) bf16(relation)
  bf16* wsm = rr + R * ld;                         // Wp2, or the slab ring
  bf16* w1t = wsm + (E::kStream ? 2 * kSlab : C) * ld;     // W1f^T, Gp x ld
  bf16* vt = w1t + T::Gp * ld;                     // R x ld: the rows' v
  float* tt = reinterpret_cast<float*>(vt);        // R x ldt: t, over v
  float* w2s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(vt) +
                                        E::vt_bytes);  // G x G: W2
  float* pos = w2s + G * G;                        // R x 4 (f32, unrounded)
  float* vld = pos + R * 4;                        // R
  float* cas = vld + R;                            // C: cA
  uint32_t* apk = reinterpret_cast<uint32_t*>(cas + C);  // 2 x lda: A as pairs
  int* rid = reinterpret_cast<int*>(apk + 2 * E::lda);   // R
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, fg = lane >> 2, fq = lane & 3;
  // the warp's strip of every (R x C) product: rows m0.. (one query),
  // channels n0.. (NWC groups)
  const int m0 = (warp % MT) * 16, n0 = (warp / MT) * (8 * NWC);
  // the tail's lane: slot s, groups gq.. gq + NG - 1
  const int s = lane & 15, gq = n0 / 8 + (lane >> 4) * NG;

  if constexpr (!E::kStream) stage_square<T>(wsm, Wp2);
  stage_w1t<T>(w1t, W1f);
  for (int e = tid; e < G * G; e += kThreads) w2s[e] = W2[e];
  for (int c = tid; c < C; c += kThreads) {
    cas[c] = cA[c];
    apk[c] = pack2(bf(A[c]), bf(A[C + c]));
    apk[E::lda + c] = pack2(bf(A[2 * C + c]), 0.f);
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / ntq;
    const int q0 = (tile - b * ntq) * TQ;
    const bf16* srcb = src + (size_t)b * Nsrc * rw;
    const int q = q0 + m0 / kS;  // the warp's query
    const bool qok = q < Nq;
    const size_t qo = (size_t)b * Nq + q;
    // the tail's slot validity and row mask, read here for the tail
    const bool vs = qok && valid[qo * kS + s];
    const float mr = qok ? bf(qrow[qo * qw + C + 6]) : 0.f;

    // 0-1: slot rows, validity, positions; at C >= 96 the rows' k and v
    //     copied to shared memory (4-byte cp.async: the row pitch 2C + 6
    //     keeps rows 4-byte aligned only) while pe1 and the peb product
    //     run; pe1 of the warp's strip
    gather_slots<T>(srcb, qrow, idx, valid, b, q0, Nsrc, Nq, rid, vld, pos);
    __syncthreads();
    if constexpr (E::kPrefetch) {
      for (int r = warp; r < R; r += kWarps) {
        const bf16* row = srcb + (size_t)rid[r] * rw;
        for (int w = lane; w < C; w += 32)  // word w: channels 2w, 2w + 1
          cp_async4(w < C / 2 ? rr + r * ld + 2 * w : vt + r * ld + 2 * w - C,
                    row + 2 * w);
      }
      cp_async_commit();
    }
    {
      // pe0 = bf16(pos) @ bf16(A) on tensor cores: one k16 step whose
      // fragments are built in registers, zero past k = 2 (the products
      // are exact; their f32 sum is the plain version's up to rounding);
      // then pe1 = relu((pe0 + cA) * v) as bf16
      const int r0 = m0 + fg, r1 = r0 + 8;
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      if (fq < 2) {
        a[0] = fq ? pack2(pos[4 * r0 + 2], 0.f) : pack2(pos[4 * r0], pos[4 * r0 + 1]);
        a[1] = fq ? pack2(pos[4 * r1 + 2], 0.f) : pack2(pos[4 * r1], pos[4 * r1 + 1]);
      }
      const float v0 = vld[r0], v1 = vld[r1];
#pragma unroll
      for (int j = 0; j < NWC; ++j) {
        const uint32_t bb[2] = {fq < 2 ? apk[fq * E::lda + n0 + 8 * j + fg] : 0u, 0u};
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(p, a, bb);
        const int c = n0 + 8 * j + 2 * fq;
        const float2 ca = *reinterpret_cast<const float2*>(cas + c);
        *reinterpret_cast<uint32_t*>(pe1b + r0 * ld + c) =
            pack2(fmaxf((p[0] + ca.x) * v0, 0.f), fmaxf((p[1] + ca.y) * v0, 0.f));
        *reinterpret_cast<uint32_t*>(pe1b + r1 * ld + c) =
            pack2(fmaxf((p[2] + ca.x) * v1, 0.f), fmaxf((p[3] + ca.y) * v1, 0.f));
      }
    }
    __syncthreads();

    // 2: peb = bf16(pe1) @ bf16(Wp2) + bp2 (tensor cores); the relation
    //    k - q + peb to shared memory as its bf16 rounding, v + peb kept in
    //    f32 in registers (vp[j] holds rows m0 + fg, m0 + fg + 8 at
    //    channels n0 + 8j + 2fq, + 1, as the accumulator does)
    float vp[NWC][4];
    mm_wp2<T, false, false, E::kStream>(
        wsm, Wp2, wsm,
        [&](uint32_t(&a)[4], int mm, int k0) { frag_a(a, pe1b, ld, mm, k0); },
        [&](int, int, auto& ac) {
          if constexpr (E::kPrefetch) {
            cp_async_wait_all();  // the rows' k and v
            __syncthreads();
          }
#pragma unroll
          for (int j = 0; j < NWC; ++j) {
            const int c = n0 + 8 * j + 2 * fq;
            float qv0 = 0.f, qv1 = 0.f;
            if (qok) {
              qv0 = bf(qrow[qo * qw + c]);
              qv1 = bf(qrow[qo * qw + c + 1]);
            }
            const float bias0 = bp2[c], bias1 = bp2[c + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + fg + 8 * h;
              const float pb0 = ac[j][2 * h] + bias0, pb1 = ac[j][2 * h + 1] + bias1;
              // the row's k and v at channels c, c + 1: the shared copy, or
              // device memory
              const bf16* kc = E::kPrefetch ? rr + r * ld + c : srcb + (size_t)rid[r] * rw + c;
              const bf16* vc = E::kPrefetch ? vt + r * ld + c : kc + C;
              const float2 k = unpack2(*reinterpret_cast<const uint32_t*>(kc));
              const float2 v = unpack2(*reinterpret_cast<const uint32_t*>(vc));
              *reinterpret_cast<uint32_t*>(rr + r * ld + c) =
                  pack2((k.x - qv0) + pb0, (k.y - qv1) + pb1);
              vp[j][2 * h] = v.x + pb0;
              vp[j][2 * h + 1] = v.y + pb1;
            }
          }
        });
    __syncthreads();

    // 3: t = (bf16(relation) @ bf16(W1f) + b1f) * valid (tensor cores)
    t_rows<T, ldt, false, kWarps / MT>(rr, w1t, b1f, vld, tt);
    __syncthreads();

    // 4: the tail, in each warp on its own query and groups. Once every
    //    warp is past step 3 no shared tile but t and W2 is read again in
    //    this tile, and the next tile overwrites t only after the gather's
    //    barrier, so the warps go on to the next tile's gather without one.
    //    w = relu(t) @ W2 + b2 for slot s and groups gq.. (f32)
    float w[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) w[i] = 0.f;
    const float* trow = tt + (m0 + s) * ldt;
#pragma unroll 2
    for (int h = 0; h < G; h += 2) {
      const float2 th = *reinterpret_cast<const float2*>(trow + h);
      float wa[NG], wb[NG];
      lds_row<NG>(wa, w2s + h * G + gq);
      lds_row<NG>(wb, w2s + (h + 1) * G + gq);
      const float t0 = fmaxf(th.x, 0.f), t1 = fmaxf(th.y, 0.f);
#pragma unroll
      for (int i = 0; i < NG; ++i) w[i] = fmaf(t1, wb[i], fmaf(t0, wa[i], w[i]));
    }
    //    softmax over the 16 slots of each group (lanes s = 0..15 of each
    //    half-warp), masked before exp; an empty group gets weights 0
    const float vm = vs ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const float wm = vs ? w[i] + b2[gq + i] : -1e30f;
      float mx = wm;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float z = __expf(fmaxf(wm - mx, -80.f)) * vm;
      // a fast division (2 ulp; the sum lies in [1, 16], or is 0 for an
      // empty group): the IEEE one cost 6-12% of a launch
      w[i] = __fdividef(z, fmaxf(xor_sum(z, 1, 8), 1e-30f));
    }
    //    out = mrow * sum_s (v + peb) * sm: the weights of rows fg, fg + 8
    //    of group n0 / 8 + j come from the lanes holding them; y[2j + x] is
    //    the lane's part of channel n0 + 8j + 2fq + x, summed over the
    //    accumulator's 8 row lanes (lane bits 4, 3, 2) by a reduce-scatter
    //    that halves the values a lane holds at each step
    float y[2 * NWC];
#pragma unroll
    for (int j = 0; j < NWC; ++j) {
      const int hl = 16 * (j / NG);
      const float a0 = __shfl_sync(0xffffffffu, w[j % NG], hl + fg);
      const float a1 = __shfl_sync(0xffffffffu, w[j % NG], hl + fg + 8);
      y[2 * j] = vp[j][0] * a0 + vp[j][2] * a1;
      y[2 * j + 1] = vp[j][1] * a0 + vp[j][3] * a1;
    }
    reduce_scatter<2 * NWC, 16>(y, lane);
    reduce_scatter<NWC, 8>(y, lane);
    // the lane's values are y[i] for i < NV, of index i + o0 before the steps
    constexpr bool kThird = NWC % 4 == 0;
    constexpr int NV = kThird ? NWC / 4 : NWC / 2;
    int o0 = (lane & 16 ? NWC : 0) + (lane & 8 ? NWC / 2 : 0);
    if constexpr (kThird) {
      reduce_scatter<NWC / 2, 4>(y, lane);
      o0 += lane & 4 ? NWC / 4 : 0;
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) y[i] += __shfl_xor_sync(0xffffffffu, y[i], 4);
    }
    if (qok && (kThird || !(lane & 4))) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int o = i + o0;
        out[qo * C + n0 + 8 * (o >> 1) + 2 * fq + (o & 1)] = y[i] * mr;
      }
    }
  }
}

template <int C>
cudaError_t eval_attr() {
  constexpr size_t smem = Eval<C>::smem;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  return cudaFuncSetAttribute(gva_eval_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C>
int eval_run(const void* src, const void* qrow, const void* idx,
             const void* valid, const void* A, const void* cA, const void* Wp2,
             const void* bp2, const void* W1f, const void* b1f, const void* W2,
             const void* b2, void* out, int B, int Nsrc, int Nq, int nblk,
             void* stream) {
  cudaError_t e = eval_attr<C>();
  if (e != cudaSuccess) return e;
  gva_eval_kernel<C><<<nblk, kThreads, Eval<C>::smem, (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const float*)bp2, (const bf16*)W1f,
      (const float*)b1f, (const float*)W2, (const float*)b2, (float*)out, B,
      Nsrc, Nq);
  return cudaGetLastError();
}

template <int C>
int eval_occupancy(int* blocks) {
  cudaError_t e = eval_attr<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gva_eval_kernel<C>, kThreads, Eval<C>::smem);
}

}  // namespace

// The instances: S = 16 and group width C / G = 8 at C = 48, 96, 192, 384
// (every stage of the S3DIS config) and 512 (the ScanNet config's deepest
// encoder stage, G = 64).
extern "C" int gva_eval_launch(const void* src, const void* qrow,
                               const void* idx, const void* valid,
                               const void* A, const void* cA, const void* Wp2,
                               const void* bp2, const void* W1f,
                               const void* b1f, const void* W2, const void* b2,
                               void* out, int B, int Nsrc, int Nq, int S, int C,
                               int G, int nblk, void* stream) {
  if (S != kS || G * 8 != C || Nsrc < 1 || nblk < 1) return cudaErrorInvalidValue;
  if (B == 0 || Nq == 0) return cudaSuccess;
#define AO_EVAL(CC)                                                              \
  case CC:                                                                       \
    return eval_run<CC>(src, qrow, idx, valid, A, cA, Wp2, bp2, W1f, b1f, W2, b2, \
                        out, B, Nsrc, Nq, nblk, stream);
  switch (C) {
    AO_EVAL(48)
    AO_EVAL(96)
    AO_EVAL(192)
    AO_EVAL(384)
    AO_EVAL(512)
  }
#undef AO_EVAL
  return cudaErrorInvalidValue;
}

// blocks of gva_eval_kernel<C> one SM holds (shared memory, registers)
extern "C" int gva_eval_blocks_per_sm(int C, int* blocks) {
  switch (C) {
    case 48: return eval_occupancy<48>(blocks);
    case 96: return eval_occupancy<96>(blocks);
    case 192: return eval_occupancy<192>(blocks);
    case 384: return eval_occupancy<384>(blocks);
    case 512: return eval_occupancy<512>(blocks);
  }
  return cudaErrorInvalidValue;
}
