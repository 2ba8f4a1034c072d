// K6: backward of the train-mode grouped vector attention (PT-v2m2).
//
// Replaces both TPU backward kernels of ao_tpu:
//   ops/pallas/gva_slab.py  _bwd_vjp -> _bwd_kernel (pallas_call in _run at
//       :432) -- Morton-sorted rows, window graph, the BN-statistics'
//       gradient applied on the host from moments this kernel emits;
//   ops/pallas/gva_fused.py _bwd_vjp -> _bwd_kernel + _bwd_stats_kernel
//       (pallas_call in _run at :419) -- pre-gathered rows, with a second
//       pass for that gradient. Here both call modes take the moments.
// Built for C = 48, 96, 192, 384 and 512 (G = C / 8, S = 16).
// Per tile of TQ queries and their S neighbours it recomputes the forward of
// gva_eval.cu with the folded batch-statistic parameters (A, cA, Wp2, bp2,
// W1f, b1f, W2, b2), then with dout (B, Nq, C) and d = dout * mrow:
//   dv2  = sm[group] * d                      dsm = sum_group(v2 * d)
//   dw   = sm * (dsm - sum_s sm * dsm)        dt  = [t > 0] (dw @ W2^T) * v
//   dr   = bf16(dt) @ bf16(W1f)^T             dpeb = dr + dv2
//   dpe0 = [pe0 > 0] (bf16(dpeb) @ bf16(Wp2)^T) * v
// and writes
//   dkv  (B, Nsrc, 2C): [dr | dv2] added to the row each edge reads (atomics)
//   dq   (B, Nq, C):    -sum_s dr
//   mom  (B, Nsrc, 1+G): [v | t] added to the row each edge reads (atomics)
//   qmom (B, Nq, 1+G):  sum_s [v | t]
//   part (nrow, P): sums over the edges, in the order of ops/gva.py:
//     bwd_par_layout: bf16(r)^T bf16(dt), sum dt, relu(t)^T dw, sum dw,
//     bf16(pe1)^T bf16(dpeb), sum dpeb, pos^T dpe0, sum dpe0, and the
//     (1+G, 6C) moment bf16([v | t])^T bf16([r | pe1 | g | x*g | y*g | z*g]),
//     g = [pe0 > 0] v. Block k adds into row k % nrow.
// The wrapper adds the partial rows; the host (ops/gva.py:_bwd_host)
// turns sums and moments into parameter gradients and the BN-statistics'
// corrections to dk and dq.
//
// What bounds it on the card: arithmetic. Per edge the recompute and the
// backward take about 10 C^2 operations in C x C-class products (peb, its
// transpose dpe0, the sum pe1^T dpeb) plus the G- and 6C-wide ones, against
// ~4C bytes of rows: far above the card's balance point. The first design
// ran them on CUDA cores in f32 (1-3% of the bound) with a tile that shrank
// as C grew and flushed its C x C sums into a per-block row of device
// memory every 16-128 edges. This design: the tile routine of gva_tile.cuh
// (R = 128 edges at C <= 96, 64 at C >= 192, walked by a persistent grid
// of 256-thread blocks, as many as the SMs hold) and every row-by-weight
// product and C x C-class weight sum on tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulation, as the TPU kernel's _mm_bf16 / _mtm
// products):
//   recompute  peb (Wp2 staged in shared memory, streamed at C = 384), t
//   backward   dr = dt W1f^T, dpe0 = dpeb Wp2^T (the same staged weights,
//              read transposed by ldmatrix)
//   sums       pe1^T dpeb, r^T dt and the (1+G) x 6C moment over the
//              tile's R edges (at C >= 192 the first and the last over
//              all edges in a second pass, below); the moment's [v | t]
//              and gate operands are built in registers
// The G x G products (relu(t) W2, dw W2^T, relu(t)^T dw), the softmax and
// the elementwise steps stay on CUDA cores in f32 (W2 staged in shared
// memory). The vector sums (db1f, dbp2, dA, dcA) and dW1f (at C <= 192)
// accumulate in shared memory over every tile a block walks, dW2 and db2 in
// registers, all written once per block. dWp2 (C x C) and the moment have
// no room on chip: at C <= 96 each tile adds them from the mma accumulators
// into the block's partial row (vector red.global adds, the row shared by
// nblk / nrow blocks so that the rows stay in L2); at C >= 192, where those
// adds took over a third of a launch, each tile instead writes its edges'
// bf16 operands [pe1 | dpeb | r | [v | t] | pos] to a scratch row, and a
// second kernel (gva_bwd_sums_kernel, below) sums them as split-K tensor-
// core products, each output tile added into the partial row once per
// block. The (B, Nsrc, *) scatters are f32 atomic adds, whose order changes
// from run to run; dq and the column sums reduce the 16 slots of a query
// inside the mma fragment by lane shuffles.
//
// Exact gates. dt = [t > 0] (...) jumps where t crosses 0, and t depends
// on bf16(relation), which jumps where the relation crosses a bf16
// rounding boundary; so a last-bit difference between the tensor cores'
// f32 sums and the plain version's (cuBLAS's f32 GEMM, an FMA chain in k
// order) can move dq and dkv by several percent at one edge. The kernel
// marks the relation channels within a bound on that difference of a
// bf16 boundary, and where |t| of a group is within what those channels
// and t's own sum can change it by, it recomputes that edge's boundary
// channels and those groups' t as FMA chains in k order on CUDA cores
// (step 3b): the gates then fall as the plain version's do.

#include "gva_tile.cuh"

namespace {

// the least power of two >= n
constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

template <int C>
struct Bwd {
  using T = Tile<C>;
  static constexpr int G = T::G, R = T::R, ld = T::ldc, ldg = T::ldg;
  // rows of the moment: 1 + G in 16-row strips, a power of two of them so
  // that the sums pass' warps split a tile evenly (128 at C = 512)
  static constexpr int Mp = 16 * pow2_ceil((G + 1 + 15) / 16);
  static constexpr int NWW = C == 48 ? 2 : 4;        // strip of pe1^T dpeb
  static constexpr int NREG = (G * G + G + kThreads - 1) / kThreads;
  // words of an edge's mask of relation channels near a bf16 rounding
  // boundary; the masks, the 64-bit masks of the groups to redo, sum
  // |bf16(r)| and its part over the boundary channels borrow the
  // softmax's R x G floats until step 4 writes them
  static constexpr int AW = (C + 31) / 32;
  static_assert(AW + 4 <= G && R * AW % 2 == 0, "gate bookkeeping fits the softmax tile");
  static constexpr bool kSmemW1 = !T::kStream;       // dW1f kept on chip
  // C >= 192: dWp2 and the moment go to the sums pass over a per-edge
  // scratch row [pe1 | dpeb | r | [v | t] (Mp) | bf16 pos (8)] of W bf16
  static constexpr bool kScratch = C >= 192;
  static constexpr int W = 3 * C + Mp + 8;
  static constexpr int oP = 0, oD = C, oR = 2 * C, oT = 3 * C, oX = 3 * C + Mp;
  static constexpr size_t P = (size_t)C * G + G + G * G + G + (size_t)C * C + C +
                              3 * C + C + (size_t)(1 + G) * 6 * C;
  static constexpr size_t smem =
      sizeof(bf16) * ((2 * R + (T::kStream ? 2 * kSlab : C) + T::Gp) * (size_t)ld +
                      (size_t)R * ldg) +
      sizeof(float) * (3 * (size_t)R * G + 5 * R + G + 5 * C + G * (G + 1) +
                       (kSmemW1 ? (size_t)C * G : 0) + C + G) +
      sizeof(int) * R;
};

// x + a[0] b[0] + ... + a[7] b[7] over eight bf16 pairs, as a chain of
// FMAs in element order (each product of two bf16 is exact in f32)
__device__ __forceinline__ float dot8(const uint4 a, const uint4 b, float x) {
  const uint32_t au[4] = {a.x, a.y, a.z, a.w}, bu[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack2(au[i]), q = unpack2(bu[i]);
    x = fmaf(p.x, q.x, x);
    x = fmaf(p.y, q.y, x);
  }
  return x;
}

template <int C>
__global__ void __launch_bounds__(kThreads, C <= 96 ? 2 : 1) gva_bwd_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7)
    const int* __restrict__ idx,        // (B, Nq, S)
    const uint8_t* __restrict__ valid,  // (B, Nq, S)
    const bf16* __restrict__ A,         // (3, C)
    const float* __restrict__ cA,       // (C)
    const bf16* __restrict__ Wp2,       // (C, C) [in, out]
    const bf16* __restrict__ Wp2T,      // (C, C) [out, in], streamed at C = 384
    const float* __restrict__ bp2,      // (C)
    const bf16* __restrict__ W1f,       // (C, G)
    const float* __restrict__ b1f,      // (G)
    const float* __restrict__ W2,       // (G, G)
    const float* __restrict__ b2,       // (G)
    const float* __restrict__ dout,     // (B, Nq, C)
    float* __restrict__ dkv,            // (B, Nsrc, 2C), zeroed
    float* __restrict__ dq,             // (B, Nq, C)
    float* __restrict__ mom,            // (B, Nsrc, 1+G), zeroed
    float* __restrict__ qmom,           // (B, Nq, 1+G)
    float* __restrict__ part,           // (nrow, P), zeroed
    bf16* __restrict__ scr,             // (B * Nq * S, W) if kScratch
    int B, int Nsrc, int Nq, int nrow) {
  using K = Bwd<C>;
  using T = typename K::T;
  constexpr int G = K::G, R = K::R, TQ = T::TQ, ld = K::ld, ldg = K::ldg;
  constexpr int rw = 2 * C + 6, qw = C + 7;
  const int ntq = (Nq + TQ - 1) / TQ;
  const int ntiles = B * ntq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pe1b = reinterpret_cast<bf16*>(smem_raw);  // R x ld: bf16(pe1)
  bf16* rr = pe1b + R * ld;      // R x ld: bf16(relation), later bf16(dpeb)
  bf16* wsm = rr + R * ld;       // Wp2 (C x ld), or the slab ring
  bf16* w1t = wsm + (T::kStream ? 2 * kSlab : C) * ld;  // W1f^T, Gp x ld
  bf16* dtb = w1t + T::Gp * ld;  // R x ldg: bf16(dt), zero past G
  float* tt = reinterpret_cast<float*>(dtb + R * ldg);  // R x G: t
  float* sm = tt + R * G;        // R x G: w, then the softmax
  float* dw = sm + R * G;        // R x G: dsm, then dw
  float* pos = dw + R * G;       // R x 4 (f32, unrounded)
  float* vld = pos + R * 4;      // R
  float* s_db1f = vld + R;       // G
  float* s_dbp2 = s_db1f + G;    // C
  float* s_dA = s_dbp2 + C;      // 4 x C: pos^T dpe0, then sum dpe0
  float* s_dW1f = s_dA + 4 * C;  // C x G (kSmemW1)
  float* w2s = s_dW1f + (K::kSmemW1 ? C * G : 0);  // G x (G + 1): W2
  int* rid = reinterpret_cast<int*>(w2s + G * (G + 1));  // R
  float* cmx = reinterpret_cast<float*>(rid + R);  // C: max_k |Wp2[k][c]|
  float* wmx = cmx + C;                            // G: max_c |W1f[c][g]|
  uint32_t* amb = reinterpret_cast<uint32_t*>(sm);  // R x AW (steps 1-3)
  unsigned long long* redo =                        // R: groups to redo
      reinterpret_cast<unsigned long long*>(amb + R * K::AW);
  float* l1 = reinterpret_cast<float*>(redo + R);   // R: sum |bf16(r)|
  float* la = l1 + R;                               // R: ... boundary part
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, fg = lane >> 2, fq = lane & 3;

  // the partial row this block adds into, in bwd_par_layout order
  float* pb = part + (size_t)(blockIdx.x % nrow) * K::P;
  float* p_dW1f = pb;
  float* p_db1f = p_dW1f + C * G;
  float* p_dW2 = p_db1f + G;  // then db2: the G*G + G register sums
  float* p_dWp2 = p_dW2 + G * G + G;
  float* p_dbp2 = p_dWp2 + C * C;
  float* p_dA = p_dbp2 + C;   // (3, C), then dcA (C)
  float* p_mom = p_dA + 4 * C;  // (1+G, 6C)

  if constexpr (!T::kStream) stage_square<T>(wsm, Wp2);
  stage_w1t<T>(w1t, W1f);
  for (int e = tid; e < R * ldg; e += kThreads) dtb[e] = __float2bfloat16_rn(0.f);
  for (int e = tid; e < G * G; e += kThreads) w2s[e / G * (G + 1) + e % G] = W2[e];
  for (int c = tid; c < C; c += kThreads) {
    float m = 0.f;
    for (int k = 0; k < C; ++k) m = fmaxf(m, fabsf(bf(Wp2[(size_t)k * C + c])));
    cmx[c] = m;
  }
  for (int g = tid; g < G; g += kThreads) {
    float m = 0.f;
    for (int c = 0; c < C; ++c) m = fmaxf(m, fabsf(bf(W1f[(size_t)c * G + g])));
    wmx[g] = m;
  }
  for (int e = tid; e < G + 5 * C + (K::kSmemW1 ? C * G : 0); e += kThreads)
    s_db1f[e] = 0.f;
  float rsum[K::NREG];  // dW2 and db2 entries tid + i * kThreads
#pragma unroll
  for (int i = 0; i < K::NREG; ++i) rsum[i] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / ntq;
    const int q0 = (tile - b * ntq) * TQ;
    const bf16* srcb = src + (size_t)b * Nsrc * rw;

    // 0-1: slot rows, validity, positions; pe1
    gather_slots<T>(srcb, qrow, idx, valid, b, q0, Nsrc, Nq, rid, vld, pos);
    __syncthreads();
    pe1_rows<T>(A, cA, pos, vld, pe1b);
    for (int i = tid; i < R * (K::AW + 4); i += kThreads) amb[i] = 0u;
    __syncthreads();

    // 2: peb = bf16(pe1) @ bf16(Wp2) + bp2 (tensor cores); the relation as
    //    its bf16 rounding, and dsm = sum over each 8-channel group of
    //    (v + peb) * d, reduced over the quad of lanes holding the group;
    //    for the exact gates (step 3b) the channels whose relation lies
    //    within the f32 sums' rounding of a bf16 rounding boundary, and
    //    sum |bf16(r)| per edge
    mm_wp2<T, false>(
        wsm, Wp2, wsm,
        [&](uint32_t(&a)[4], int m0, int k0) { frag_a(a, pe1b, ld, m0, k0); },
        [&](int m0, int n0, auto& ac) {
          const int q = q0 + m0 / kS;
          const bool qok = q < Nq;
          const size_t qo = (size_t)b * Nq + q;
          const float mr = qok ? bf(qrow[qo * qw + C + 6]) : 0.f;
          // sum_k bf16(pe1_k) of the lane's rows m0 + fg + 8h, from the
          // quad's four lanes
          const uint4 ones = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
          float s1[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4* pr = reinterpret_cast<const uint4*>(pe1b + (m0 + fg + 8 * h) * ld);
            float x = 0.f;
            for (int k8 = fq; k8 < C / 8; k8 += 4) x += dot8(pr[k8], ones, 0.f);
            s1[h] = xor_sum(x, 1, 2);
          }
          // |f32 peb - the plain version's| <= 2^-20 sum_k pe1_k max_k
          // |Wp2[k][c]| (measured on random graphs at the train shapes: at
          // most 2^-23.1 of it; PERF.md), plus the bias add's and the
          // relation's own rounding
          auto near_edge = [&](int h, int c, float x, float p) {
            const int r = m0 + fg + 8 * h;
            const float d = 0x1p-20f * s1[h] * cmx[c] + 0x1p-22f * (fabsf(p) + fabsf(x));
            const float xr = rbf(x);
            if (rbf(x + d) != xr || rbf(x - d) != xr) {
              atomicOr(amb + r * K::AW + (c >> 5), 1u << (c & 31));
              atomicAdd(la + r, fabsf(xr));
            }
            return fabsf(xr);
          };
          float sa[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < T::NWC; ++j) {
            const int c = n0 + 8 * j + 2 * fq;
            const float qv0 = qok ? bf(qrow[qo * qw + c]) : 0.f;
            const float qv1 = qok ? bf(qrow[qo * qw + c + 1]) : 0.f;
            const float2 d = qok ? *reinterpret_cast<const float2*>(dout + qo * C + c)
                                 : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m0 + fg + 8 * h;
              const float pb0 = ac[j][2 * h] + bp2[c], pb1 = ac[j][2 * h + 1] + bp2[c + 1];
              const bf16* row = srcb + (size_t)rid[r] * rw + c;
              const float2 k = unpack2(*reinterpret_cast<const uint32_t*>(row));
              const float2 v = unpack2(*reinterpret_cast<const uint32_t*>(row + C));
              const float r0 = (k.x - qv0) + pb0, r1 = (k.y - qv1) + pb1;
              *reinterpret_cast<uint32_t*>(rr + r * ld + c) = pack2(r0, r1);
              sa[h] += near_edge(h, c, r0, pb0) + near_edge(h, c + 1, r1, pb1);
              const float x = xor_sum((v.x + pb0) * d.x * mr + (v.y + pb1) * d.y * mr, 1, 2);
              if (fq == 0) dw[r * G + c / 8] = x;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = xor_sum(sa[h], 1, 2);
            if (fq == 0) atomicAdd(l1 + m0 + fg + 8 * h, x);
          }
        });
    __syncthreads();

    // 3: t = (bf16(relation) @ bf16(W1f) + b1f) * valid (tensor cores; at
    //    C = 512, R = 32: the G columns in four strips, one per warp)
    t_rows<T, G, true, (C > 384 ? kWarps / (R / 16) : 1)>(rr, w1t, b1f, vld, tt);
    __syncthreads();

    // 3b: exact gates. The plain version's products are FMA chains in k
    //     order (cuBLAS's f32 GEMM: bit-equal to the chain at these
    //     shapes), whose f32 sums differ from the tensor cores' in the
    //     last bits; bf16(relation) and t > 0 turn that into a whole step
    //     of dt. A group is redone where |t| is within what the two can
    //     differ by: the t sum's rounding, 2^-18 sum |r| max |W1f[:, g]|
    //     (measured: at most 2^-23.8 of it), plus one bf16 step, 2^-6
    //     |r_c W1f[c][g]|, of each boundary channel (checked first against
    //     its bound max |W1f[:, g]| times sum |r_c|). A warp then redoes
    //     each such edge as the chains: the relation of its boundary
    //     channels (lanes in parallel), then t of those groups.
    int any = 0;
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, g = e - r * G;
      const float at = fabsf(tt[e]) * 0.999f, lt = 0x1p-18f * l1[r] * wmx[g];
      if (vld[r] == 0.f || at > lt + 0x1p-6f * wmx[g] * la[r]) continue;
      float x = 0.f;
      for (int w = 0; w < K::AW; ++w)
        for (uint32_t m = amb[r * K::AW + w]; m; m &= m - 1) {
          const int c = 32 * w + __ffs(m) - 1;
          x += fabsf(bf(rr[r * ld + c]) * bf(w1t[g * ld + c]));
        }
      if (at <= lt + 0x1p-6f * x) {
        atomicOr(redo + r, 1ull << g);
        any = 1;
      }
    }
    if (__syncthreads_or(any)) {  // some edge of the tile to redo
      for (int r = warp; r < R; r += kWarps) {
        const unsigned long long fl = redo[r];
        if (fl == 0ull) continue;
        const uint32_t* am = amb + r * K::AW;
        const bf16* krow = srcb + (size_t)rid[r] * rw;
        const bf16* qr = qrow + ((size_t)b * Nq + q0 + r / kS) * qw;
        int namb = 0;
        for (int w = 0; w < K::AW; ++w) namb += __popc(am[w]);
        for (int j0 = 0; j0 < namb; j0 += 32) {
          // this lane's boundary channel: the (j0 + lane)-th set bit
          int j = j0 + lane, c = -1;
          for (int w = 0; w < K::AW && c < 0; ++w) {
            const int n = __popc(am[w]);
            if (j < n) {
              uint32_t m = am[w];
              for (int i = 0; i < j; ++i) m &= m - 1;
              c = 32 * w + __ffs(m) - 1;
            } else {
              j -= n;
            }
          }
          if (c < 0) continue;
          float x = 0.f;  // sum_k bf16(pe1_k) Wp2[k][c], k ascending
          if constexpr (T::kStream) {  // column c of Wp2 is row c of Wp2^T
            const uint4* wc = reinterpret_cast<const uint4*>(Wp2T + (size_t)c * C);
            const uint4* pr = reinterpret_cast<const uint4*>(pe1b + r * ld);
#pragma unroll 8
            for (int k8 = 0; k8 < C / 8; ++k8) x = dot8(pr[k8], __ldg(wc + k8), x);
          } else {
#pragma unroll 8
            for (int k = 0; k < C; ++k) x = fmaf(bf(pe1b[r * ld + k]), bf(wsm[k * ld + c]), x);
          }
          const float rel = (bf(krow[c]) - bf(qr[c])) + (x + bp2[c]);
          rr[r * ld + c] = __float2bfloat16_rn(rel);
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int g = lane + 32 * u;
          if (g >= G || !((fl >> g) & 1ull)) continue;
          const uint4* ra = reinterpret_cast<const uint4*>(rr + r * ld);
          const uint4* wa = reinterpret_cast<const uint4*>(w1t + g * ld);
          float x = 0.f;  // c ascending
#pragma unroll 6
          for (int c8 = 0; c8 < C / 8; ++c8) x = dot8(ra[c8], wa[c8], x);
          tt[r * G + g] = (x + b1f[g]) * vld[r];
        }
        __syncwarp();
      }
      __syncthreads();
    }

    // 4: w = relu(t) @ W2 + b2
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, g = e - r * G;
      float a = 0.f;
      for (int h = 0; h < G; ++h) a += fmaxf(tt[r * G + h], 0.f) * w2s[h * (G + 1) + g];
      sm[e] = a + b2[g];
    }
    __syncthreads();

    // 5: softmax over the S slots of each (query, group), masked before
    //    exp as in gva_eval.cu; then dw = sm * (dsm - sum_s sm * dsm)
    for (int e = tid; e < TQ * G; e += kThreads) {
      const int qi = e / G, g = e - qi * G;
      float mx = -1e30f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int r = qi * kS + s;
        mx = fmaxf(mx, vld[r] > 0.f ? sm[r * G + g] : -1e30f);
      }
      float z[kS];
      float Z = 0.f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int r = qi * kS + s;
        const float wm = vld[r] > 0.f ? sm[r * G + g] : -1e30f;
        z[s] = __expf(fmaxf(wm - mx, -80.f)) * vld[r];
        Z += z[s];
      }
      const float inv = 1.f / fmaxf(Z, 1e-30f);
      float sd = 0.f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int r = qi * kS + s;
        z[s] *= inv;
        sm[r * G + g] = z[s];
        sd += z[s] * dw[r * G + g];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int r = qi * kS + s;
        dw[r * G + g] = z[s] * (dw[r * G + g] - sd);
      }
    }
    __syncthreads();

    // 6: dt = [t > 0] (dw @ W2^T) * valid as bf16 (sum dt in f32); the
    //    relu(t)^T dw and sum dw entries this thread owns; the [v | t]
    //    moments per source row (scatter) and per query
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, h = e - r * G;
      float a = 0.f;
      for (int g = 0; g < G; ++g) a += dw[r * G + g] * w2s[h * (G + 1) + g];
      const float x = tt[e] > 0.f ? a * vld[r] : 0.f;
      dtb[r * ldg + h] = __float2bfloat16_rn(x);
      atomicAdd(s_db1f + h, x);
    }
#pragma unroll
    for (int i = 0; i < K::NREG; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * G) {
        const int h = e / G, g = e - h * G;
        float a = 0.f;
        for (int r = 0; r < R; ++r) a += fmaxf(tt[r * G + h], 0.f) * dw[r * G + g];
        rsum[i] += a;
      } else if (e < G * G + G) {
        const int g = e - G * G;
        float a = 0.f;
        for (int r = 0; r < R; ++r) a += dw[r * G + g];
        rsum[i] += a;
      }
    }
    for (int e = tid; e < TQ * (1 + G); e += kThreads) {
      const int qi = e / (1 + G), a = e - qi * (1 + G);
      const int q = q0 + qi;
      float acc = 0.f;
      for (int s = 0; s < kS; ++s) {
        const int r = qi * kS + s;
        const float x = a == 0 ? vld[r] : tt[r * G + a - 1];
        acc += x;
        if (vld[r] > 0.f)
          atomicAdd(mom + ((size_t)b * Nsrc + rid[r]) * (1 + G) + a, x);
      }
      if (q < Nq) qmom[((size_t)b * Nq + q) * (1 + G) + a] = acc;
    }
    __syncthreads();

    // 7: the sums over the tile's R edges on tensor cores (K = R):
    //    dW1f += bf16(r)^T bf16(dt); the moment bf16([v | t])^T bf16([r |
    //    pe1 | g | x*g | y*g | z*g]), its [v | t] and gate operands built in
    //    registers, added into the partial row -- or, at C >= 192, the
    //    tile's scratch rows, summed by gva_bwd_sums_kernel
    tile_mm<T::Gp / 8, C / 16, 1, R>(
        [&](uint32_t(&a)[4], int m0, int k0) { frag_at(a, rr, ld, m0, k0); },
        [&](uint32_t(&b)[2], int k0, int n0) { frag_b_kn(b, dtb, ldg, k0, n0); },
        [&](int m0, int n0, auto& ac) {
          each_pair(ac, m0, n0, [&](int j, int g, float x0, float x1) {
            if (g < G) {
              if constexpr (K::kSmemW1) {
                s_dW1f[j * G + g] += x0;
                s_dW1f[j * G + g + 1] += x1;
              } else {
                red2(p_dW1f + j * G + g, x0, x1);
              }
            }
          });
        });
    auto tv = [&](int a, int e) {  // [v | t] of edge e, rows past G zero
      return a == 0 ? vld[e] : (a <= G ? tt[e * G + a - 1] : 0.f);
    };
    if constexpr (K::kScratch) {
      // this tile's scratch rows but dpeb (written after step 8)
      constexpr int W8 = K::W / 8;
      for (int i = tid; i < R * W8; i += kThreads) {
        const int r = i / W8, k = (i - r * W8) * 8;
        const int q = q0 + r / kS;
        if (q >= Nq || (k >= K::oD && k < K::oR)) continue;
        uint4 v;
        if (k < K::oD) {
          v = *reinterpret_cast<const uint4*>(pe1b + r * ld + k);
        } else if (k < K::oT) {
          v = *reinterpret_cast<const uint4*>(rr + r * ld + k - K::oR);
        } else if (k < K::oX) {
          const int a = k - K::oT;
          v = make_uint4(pack2(tv(a, r), tv(a + 1, r)), pack2(tv(a + 2, r), tv(a + 3, r)),
                         pack2(tv(a + 4, r), tv(a + 5, r)), pack2(tv(a + 6, r), tv(a + 7, r)));
        } else {
          v = make_uint4(pack2(pos[4 * r], pos[4 * r + 1]), pack2(pos[4 * r + 2], 0.f), 0u, 0u);
        }
        *reinterpret_cast<uint4*>(scr + (((size_t)b * Nq + q) * kS + r % kS) * K::W + k) = v;
      }
    } else {
      tile_mm<4, K::Mp / 16, 6 * C / 32, R>(
          [&](uint32_t(&a)[4], int m0, int k0) {
            const int r0 = m0 + fg, k = k0 + 2 * fq;
            a[0] = pack2(tv(r0, k), tv(r0, k + 1));
            a[1] = pack2(tv(r0 + 8, k), tv(r0 + 8, k + 1));
            a[2] = pack2(tv(r0, k + 8), tv(r0, k + 9));
            a[3] = pack2(tv(r0 + 8, k + 8), tv(r0 + 8, k + 9));
          },
          [&](uint32_t(&b)[2], int k0, int n0) {
            const int blk = n0 / C, c0 = n0 - blk * C;
            if (blk == 0) {
              frag_b_kn(b, rr, ld, k0, c0);
            } else if (blk == 1) {
              frag_b_kn(b, pe1b, ld, k0, c0);
            } else {  // [pe1 > 0] * (1, x, y, z)
              const int c = c0 + fg;
              float f[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int e = k0 + 2 * fq + (u & 1) + (u >> 1) * 8;
                const float m = blk == 2 ? 1.f : pos[4 * e + blk - 3];
                f[u] = bf(pe1b[e * ld + c]) > 0.f ? m : 0.f;
              }
              b[0] = pack2(f[0], f[1]);
              b[1] = pack2(f[2], f[3]);
            }
          },
          [&](int m0, int n0, auto& ac) {
            each_pair(ac, m0, n0, [&](int a, int col, float x0, float x1) {
              if (a <= G) {
                red2(p_mom + (size_t)a * 6 * C + col, x0, x1);
              }
            });
          });
    }
    __syncthreads();

    // 8: dr = bf16(dt) @ bf16(W1f)^T (tensor cores, K = Gp); dv2, dpeb
    //    (kept as bf16 in the relation's place); [dr | dv2] scattered to
    //    the rows read; dq = -sum_s dr and sum dpeb over the 16 slots of
    //    the strip's query by lane shuffles
    tile_mm<T::NWC, R / 16, C / 8 / T::NWC, T::Gp>(
        [&](uint32_t(&a)[4], int m0, int k0) { frag_a(a, dtb, ldg, m0, k0); },
        [&](uint32_t(&b)[2], int k0, int n0) { frag_b_kn(b, w1t, ld, k0, n0); },
        [&](int m0, int n0, auto& ac) {
          const int q = q0 + m0 / kS;
          const bool qok = q < Nq;
          const size_t qo = (size_t)b * Nq + q;
          const float mr = qok ? bf(qrow[qo * qw + C + 6]) : 0.f;
          const int ra = m0 + fg, rb = ra + 8;
          float* dka = dkv + ((size_t)b * Nsrc + rid[ra]) * (2 * C);
          float* dkb = dkv + ((size_t)b * Nsrc + rid[rb]) * (2 * C);
          const bool va = vld[ra] > 0.f, vb = vld[rb] > 0.f;
#pragma unroll
          for (int j = 0; j < T::NWC; ++j) {
            const int c = n0 + 8 * j + 2 * fq;
            float2 d = qok ? *reinterpret_cast<const float2*>(dout + qo * C + c)
                           : make_float2(0.f, 0.f);
            d.x *= mr;
            d.y *= mr;
            const float sa = sm[ra * G + c / 8], sb = sm[rb * G + c / 8];
            const float va0 = sa * d.x, va1 = sa * d.y, vb0 = sb * d.x, vb1 = sb * d.y;
            const float pa0 = ac[j][0] + va0, pa1 = ac[j][1] + va1;
            const float pb0 = ac[j][2] + vb0, pb1 = ac[j][3] + vb1;
            *reinterpret_cast<uint32_t*>(rr + ra * ld + c) = pack2(pa0, pa1);
            *reinterpret_cast<uint32_t*>(rr + rb * ld + c) = pack2(pb0, pb1);
            if (va) {
              red2(dka + c, ac[j][0], ac[j][1]);
              red2(dka + C + c, va0, va1);
            }
            if (vb) {
              red2(dkb + c, ac[j][2], ac[j][3]);
              red2(dkb + C + c, vb0, vb1);
            }
            const float s0 = xor_sum(ac[j][0] + ac[j][2], 4, 16);
            const float s1 = xor_sum(ac[j][1] + ac[j][3], 4, 16);
            const float u0 = xor_sum(pa0 + pb0, 4, 16);
            const float u1 = xor_sum(pa1 + pb1, 4, 16);
            if (fg == 0) {
              if (qok) {
                dq[qo * C + c] = -s0;
                dq[qo * C + c + 1] = -s1;
              }
              atomicAdd(s_dbp2 + c, u0);
              atomicAdd(s_dbp2 + c + 1, u1);
            }
          }
        });
    __syncthreads();

    // 9: dWp2 += bf16(pe1)^T bf16(dpeb) (tensor cores, K = R), added into
    //    the partial row; with the scratch, dpeb's field of the rows
    if constexpr (K::kScratch) {
      constexpr int C8 = C / 8;
      for (int i = tid; i < R * C8; i += kThreads) {
        const int r = i / C8, k = (i - r * C8) * 8;
        const int q = q0 + r / kS;
        if (q < Nq)
          *reinterpret_cast<uint4*>(scr + (((size_t)b * Nq + q) * kS + r % kS) * K::W +
                                    K::oD + k) =
              *reinterpret_cast<const uint4*>(rr + r * ld + k);
      }
    } else {
      tile_mm<K::NWW, C / 16, C / 8 / K::NWW, R>(
          [&](uint32_t(&a)[4], int m0, int k0) { frag_at(a, pe1b, ld, m0, k0); },
          [&](uint32_t(&b)[2], int k0, int n0) { frag_b_kn(b, rr, ld, k0, n0); },
          [&](int m0, int n0, auto& ac) {
            each_pair(ac, m0, n0, [&](int j, int c, float x0, float x1) {
              red2(p_dWp2 + (size_t)j * C + c, x0, x1);
            });
          });
    }

    // 10: dpe0 = [pe0 > 0] (bf16(dpeb) @ bf16(Wp2)^T) (tensor cores, the
    //     staged Wp2 read transposed, or Wp2^T streamed); pos^T dpe0 and
    //     sum dpe0 reduced over the strip's 16 rows by lane shuffles
    mm_wp2<T, true>(
        wsm, Wp2T, wsm,
        [&](uint32_t(&a)[4], int m0, int k0) { frag_a(a, rr, ld, m0, k0); },
        [&](int m0, int n0, auto& ac) {
          const int ra = m0 + fg, rb = ra + 8;
#pragma unroll
          for (int j = 0; j < T::NWC; ++j) {
            const int c = n0 + 8 * j + 2 * fq;
            const float2 ga = unpack2(*reinterpret_cast<const uint32_t*>(pe1b + ra * ld + c));
            const float2 gb = unpack2(*reinterpret_cast<const uint32_t*>(pe1b + rb * ld + c));
            const float ea0 = ga.x > 0.f ? ac[j][0] : 0.f, ea1 = ga.y > 0.f ? ac[j][1] : 0.f;
            const float eb0 = gb.x > 0.f ? ac[j][2] : 0.f, eb1 = gb.y > 0.f ? ac[j][3] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float xa = i < 3 ? pos[4 * ra + i] : 1.f;
              const float xb = i < 3 ? pos[4 * rb + i] : 1.f;
              const float s0 = xor_sum(xa * ea0 + xb * eb0, 4, 16);
              const float s1 = xor_sum(xa * ea1 + xb * eb1, 4, 16);
              if (fg == 0) {
                atomicAdd(s_dA + i * C + c, s0);
                atomicAdd(s_dA + i * C + c + 1, s1);
              }
            }
          }
        });
    __syncthreads();
  }
  __syncthreads();

  // the block's on-chip sums, added once into its partial row
  for (int e = tid; e < G; e += kThreads) atomicAdd(p_db1f + e, s_db1f[e]);
  for (int e = tid; e < C; e += kThreads) atomicAdd(p_dbp2 + e, s_dbp2[e]);
  for (int e = tid; e < 4 * C; e += kThreads) atomicAdd(p_dA + e, s_dA[e]);
  if constexpr (K::kSmemW1)
    for (int e = tid; e < C * G; e += kThreads) atomicAdd(p_dW1f + e, s_dW1f[e]);
#pragma unroll
  for (int i = 0; i < K::NREG; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * G + G) atomicAdd(p_dW2 + e, rsum[i]);
  }
}

// The sums pass (C >= 192): dWp2 = sum_e bf16(pe1)^T bf16(dpeb) and the
// (1+G, 6C) moment over every edge of the call, from the scratch rows K6
// wrote, as split-K tensor-core products. A block takes one output tile
// (64 or 128 x BN of dWp2, or Mp x BN of the moment; BN = 192, or 128 at
// C = 512) and one range of edges, streams it through shared memory in
// stages of kKE edges (cp.async, two stages; the moment's gate operands
// [pe1 > 0] * (1, x, y, z) are built in registers from the staged pe1
// columns) and adds its f32 tile into partial row 0 once.
constexpr int kKE = 64;   // edges per stage

template <int C>
struct Sums {
  using K = Bwd<C>;
  // output columns of a tile: 192, or 128 where 192 does not divide C
  static constexpr int BN = C % 192 == 0 ? 192 : 128;
  static constexpr int BMW = C % 128 == 0 ? 128 : 64;  // rows of a dWp2 tile
  static_assert(K::Mp <= BMW, "the moment's tile fits the staged rows");
  static constexpr int J1 = (C / BMW) * (C / BN);      // dWp2 tiles
  static constexpr int J = J1 + 6 * C / BN;            // and the moment's
  static constexpr size_t smem = sizeof(bf16) * 2 * kKE * ((BMW + 8) + (BN + 8) + 8);
};

// one output tile: A = scratch columns [aoff, aoff + BM) transposed; B =
// columns [boff, boff + BN) (gate < 0), or [pe1 > 0] * m built from those
// columns (pe1's) and the edge's m = 1 (gate = 3) or bf16 position x, y, z
// (gate = 0, 1, 2), as the main kernel builds the moment's operands
template <int C, int BM, int BN>
__device__ __forceinline__ void sums_tile(const bf16* __restrict__ scr, size_t e_begin,
                                          size_t e_end, int aoff, int boff, int gate,
                                          float* out, int ldo, int rows, bf16* smem) {
  using K = Bwd<C>;
  constexpr int W = K::W, lda = BM + 8, ldb = BN + 8;
  // one 16 x 8NW strip per warp
  constexpr int MT = BM / 16, NW = BN / 8 * MT / kWarps;
  static_assert(MT * (BN / 8 / NW) == kWarps && NW % 2 == 0, "one strip per warp");
  bf16* As = smem;                  // 2 x kKE x lda
  bf16* Bs = As + 2 * kKE * lda;    // 2 x kKE x ldb
  bf16* Ps = Bs + 2 * kKE * ldb;    // 2 x kKE x 8: bf16 positions
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fg = lane >> 2, fq = lane & 3;
  const int m0 = (warp % MT) * 16, n0 = (warp / MT) * (8 * NW);
  const int nst = (int)((e_end - e_begin + kKE - 1) / kKE);
  auto stage = [&](bf16* dst, int ld, int cols, int off, size_t e0) {
    for (int i = threadIdx.x; i < kKE * (cols / 8); i += kThreads) {
      const int r = i / (cols / 8), k = (i - r * (cols / 8)) * 8;
      if (e0 + r < e_end) cp_async16(dst + r * ld + k, scr + (e0 + r) * W + off + k);
      else *reinterpret_cast<uint4*>(dst + r * ld + k) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto load = [&](int st) {
    const size_t e0 = e_begin + (size_t)st * kKE;
    stage(As + (st & 1) * kKE * lda, lda, BM, aoff, e0);
    stage(Bs + (st & 1) * kKE * ldb, ldb, BN, boff, e0);
    if (gate >= 0) stage(Ps + (st & 1) * kKE * 8, 8, 8, K::oX, e0);
    cp_async_commit();
  };
  float acc[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  load(0);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st landed; every warp is done with st - 1
    if (st + 1 < nst) load(st + 1);
    const bf16* a = As + (st & 1) * kKE * lda;
    const bf16* b = Bs + (st & 1) * kKE * ldb;
    const bf16* ps = Ps + (st & 1) * kKE * 8;
#pragma unroll
    for (int k0 = 0; k0 < kKE; k0 += 16) {
      uint32_t af[4];
      frag_at(af, a, lda, m0, k0);
      if (gate < 0) {
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
          uint32_t b2[4];
          frag_b2_kn(b2, b, ldb, k0, n0 + 8 * j);
          mma_pair<false>(acc, j, af, b2);
        }
      } else {
        float m[4];  // the four edges of this lane's B fragment
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = k0 + 2 * fq + (u & 1) + (u >> 1) * 8;
          m[u] = gate == 3 ? 1.f : bf(ps[e * 8 + gate]);
        }
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int c = n0 + 8 * j + fg;
          float f[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = k0 + 2 * fq + (u & 1) + (u >> 1) * 8;
            f[u] = bf(b[e * ldb + c]) > 0.f ? m[u] : 0.f;
          }
          const uint32_t bfr[2] = {pack2(f[0], f[1]), pack2(f[2], f[3])};
          mma16816(acc[j], af, bfr);
        }
      }
    }
  }
  each_pair(acc, m0, n0, [&](int r, int c, float x0, float x1) {
    if (r < rows) red2(out + (size_t)r * ldo + c, x0, x1);
  });
}

template <int C>
__global__ void __launch_bounds__(kThreads) gva_bwd_sums_kernel(
    const bf16* __restrict__ scr,  // (E, W) scratch rows of gva_bwd_kernel
    long long E, float* __restrict__ part, int nsplit) {
  using K = Bwd<C>;
  using S = Sums<C>;
  constexpr int G = K::G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int job = blockIdx.x % S::J, split = blockIdx.x / S::J;
  const long long nch = (E + kKE - 1) / kKE, per = (nch + nsplit - 1) / nsplit;
  const size_t e_begin = (size_t)split * per * kKE;
  const size_t e_end = min((size_t)E, e_begin + (size_t)per * kKE);
  if (e_begin >= e_end) return;
  float* p_dWp2 = part + (size_t)C * G + G + G * G + G;
  float* p_mom = p_dWp2 + (size_t)C * C + 5 * C;
  if (job < S::J1) {
    constexpr int BM = S::BMW;
    const int mi = job % (C / BM), ni = job / (C / BM);
    sums_tile<C, BM, S::BN>(scr, e_begin, e_end, K::oP + mi * BM, K::oD + ni * S::BN,
                            -1, p_dWp2 + (size_t)mi * BM * C + ni * S::BN, C, BM,
                            smem);
  } else {
    const int col0 = (job - S::J1) * S::BN, blk = col0 / C, c0 = col0 - blk * C;
    sums_tile<C, K::Mp, S::BN>(scr, e_begin, e_end, K::oT,
                               (blk == 0 ? K::oR : K::oP) + c0,
                               blk < 2 ? -1 : (blk == 2 ? 3 : blk - 3), p_mom + col0,
                               6 * C, G + 1, smem);
  }
}

template <int C>
cudaError_t bwd_attr() {
  static_assert(Bwd<C>::smem <= 227 * 1024, "shared memory of one block");
  return cudaFuncSetAttribute(gva_bwd_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Bwd<C>::smem);
}

template <int C>
int bwd_run(const void* src, const void* qrow, const void* idx,
            const void* valid, const void* A, const void* cA, const void* Wp2,
            const void* Wp2T, const void* bp2, const void* W1f,
            const void* b1f, const void* W2, const void* b2, const void* dout,
            void* dkv, void* dq, void* mom, void* qmom, void* part, void* scr,
            int B, int Nsrc, int Nq, int nblk, int nrow, int nsplit,
            void* stream) {
  if (Bwd<C>::kScratch && (scr == nullptr || nsplit < 1)) return cudaErrorInvalidValue;
  cudaError_t e = bwd_attr<C>();
  if (e != cudaSuccess) return e;
  gva_bwd_kernel<C><<<nblk, kThreads, Bwd<C>::smem, (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const bf16*)Wp2T, (const float*)bp2,
      (const bf16*)W1f, (const float*)b1f, (const float*)W2,
      (const float*)b2, (const float*)dout, (float*)dkv, (float*)dq,
      (float*)mom, (float*)qmom, (float*)part, (bf16*)scr, B, Nsrc, Nq, nrow);
  e = cudaGetLastError();
  if constexpr (Bwd<C>::kScratch) {
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(gva_bwd_sums_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Sums<C>::smem);
    if (e != cudaSuccess) return e;
    gva_bwd_sums_kernel<C><<<Sums<C>::J * nsplit, kThreads, Sums<C>::smem,
                             (cudaStream_t)stream>>>(
        (const bf16*)scr, (long long)B * Nq * kS, (float*)part, nsplit);
    e = cudaGetLastError();
  }
  return e;
}

template <int C>
int bwd_occupancy(int* blocks) {
  cudaError_t e = bwd_attr<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gva_bwd_kernel<C>, kThreads, Bwd<C>::smem);
}

}  // namespace

// The instances: S = 16 and group width C / G = 8 at C = 48, 96, 192, 384
// (every stage of the S3DIS config) and 512 (the ScanNet config's deepest
// encoder stage, G = 64).
extern "C" int gva_bwd_launch(const void* src, const void* qrow,
                              const void* idx, const void* valid,
                              const void* A, const void* cA, const void* Wp2,
                              const void* Wp2T, const void* bp2,
                              const void* W1f, const void* b1f,
                              const void* W2, const void* b2,
                              const void* dout, void* dkv, void* dq, void* mom,
                              void* qmom, void* part, void* scr, int B,
                              int Nsrc, int Nq, int S, int C, int G, int nblk,
                              int nrow, int nsplit, void* stream) {
  if (S != kS || G * 8 != C || Nsrc < 1 || nblk < 1 || nrow < 1)
    return cudaErrorInvalidValue;
#define AO_BWD(CC)                                                        \
  case CC:                                                                \
    return bwd_run<CC>(src, qrow, idx, valid, A, cA, Wp2, Wp2T, bp2, W1f, \
                       b1f, W2, b2, dout, dkv, dq, mom, qmom, part, scr,  \
                       B, Nsrc, Nq, nblk, nrow, nsplit, stream);
  switch (C) {
    AO_BWD(48)
    AO_BWD(96)
    AO_BWD(192)
    AO_BWD(384)
    AO_BWD(512)
  }
#undef AO_BWD
  return cudaErrorInvalidValue;
}

// blocks of gva_bwd_kernel<C> one SM holds (shared memory, registers)
extern "C" int gva_bwd_blocks_per_sm(int C, int* blocks) {
  switch (C) {
    case 48: return bwd_occupancy<48>(blocks);
    case 96: return bwd_occupancy<96>(blocks);
    case 192: return bwd_occupancy<192>(blocks);
    case 384: return bwd_occupancy<384>(blocks);
    case 512: return bwd_occupancy<512>(blocks);
  }
  return cudaErrorInvalidValue;
}

// bf16 elements of K6's per-edge scratch row at width C (0: no scratch),
// and the output tiles of its sums pass
extern "C" int gva_bwd_scratch_width(int C) {
  switch (C) {
    case 192: return Bwd<192>::kScratch ? Bwd<192>::W : 0;
    case 384: return Bwd<384>::kScratch ? Bwd<384>::W : 0;
    case 512: return Bwd<512>::kScratch ? Bwd<512>::W : 0;
  }
  return 0;
}
extern "C" int gva_bwd_sums_tiles(int C) {
  switch (C) {
    case 192: return Sums<192>::J;
    case 384: return Sums<384>::J;
    case 512: return Sums<512>::J;
  }
  return 0;
}
