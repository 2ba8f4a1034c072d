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
// What bounds it on the card: arithmetic. The pe-MLP's (Nq*S, C) x (C, C)
// product is 2*S*C^2 operations per query against ~S*(2C+6)*2 bytes of
// gathered rows, far above the card's balance point; on CUDA cores in f32
// (the first design) it ran at 0.3-1.3% of the bf16 tensor-core bound.
// The design: the tile routine of gva_tile.cuh. A persistent grid (as
// many blocks of 256 threads as the SMs hold) walks tiles of R = 128 edges
// (C <= 96), 64 (C = 192, 384) or 32 (C = 512); both products (peb and t)
// run on tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) with
// Wp2 and W1 staged in shared memory once per block (Wp2 streamed by
// cp.async at C >= 384); pe1 and the relation live in shared memory as
// their bf16 roundings. Each block keeps its 2G+13 sums in shared memory and writes
// them once as its row of partial sums; the wrapper adds the rows in f64,
// so no f32 atomics chain into one scalar and the count stays exact.

#include "gva_tile.cuh"

namespace {

// shared memory of one block: pe1 and relation tiles, Wp2 (or its ring),
// W1 transposed, then t, positions, validity, the sums and the row ids
template <int C>
constexpr size_t stats_smem() {
  using T = Tile<C>;
  return sizeof(bf16) * ((2 * T::R + (T::kStream ? 2 * kSlab : C) + T::Gp) *
                         (size_t)T::ldc) +
         sizeof(float) * ((size_t)T::R * T::G + 5 * T::R + 2 * T::G + 13) +
         sizeof(int) * T::R;
}

template <int C>
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
    int B, int Nsrc, int Nq) {
  using T = Tile<C>;
  constexpr int G = T::G, R = T::R, TQ = T::TQ, ld = T::ldc;
  constexpr int P = 2 * G + 13, rw = 2 * C + 6, qw = C + 7;
  const int ntq = (Nq + TQ - 1) / TQ;
  const int ntiles = B * ntq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* pe1b = reinterpret_cast<bf16*>(smem_raw);  // R x ld
  bf16* rr = pe1b + R * ld;                        // R x ld: the relation
  bf16* wsm = rr + R * ld;                         // Wp2, or the slab ring
  bf16* w1t = wsm + (T::kStream ? 2 * kSlab : C) * ld;  // Gp x ld
  float* tt = reinterpret_cast<float*>(w1t + T::Gp * ld);  // R x G
  float* pos = tt + R * G;                         // R x 4, f32 (unrounded)
  float* vld = pos + R * 4;                        // R
  float* acc = vld + R;                            // P
  int* rid = reinterpret_cast<int*>(acc + P);      // R
  const int tid = threadIdx.x;

  if constexpr (!T::kStream) stage_square<T>(wsm, Wp2);
  stage_w1t<T>(w1t, W1);
  for (int e = tid; e < P; e += kThreads) acc[e] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / ntq;
    const int q0 = (tile - b * ntq) * TQ;
    const bf16* srcb = src + (size_t)b * Nsrc * rw;

    gather_slots<T>(srcb, qrow, idx, valid, b, q0, Nsrc, Nq, rid, vld, pos);
    __syncthreads();
    pe1_rows<T>(A, cA, pos, vld, pe1b);
    __syncthreads();

    // 2: peb = bf16(pe1) @ bf16(Wp2) + bp2 on tensor cores; the relation
    //    k - q + peb kept as its bf16 rounding
    mm_wp2<T, false>(
        wsm, Wp2, wsm,
        [&](uint32_t(&a)[4], int m0, int k0) { frag_a(a, pe1b, ld, m0, k0); },
        [&](int m0, int n0, auto& ac) {
          each_pair(ac, m0, n0, [&](int r, int c, float x0, float x1) {
            const int q = q0 + r / kS;
            float q0v = 0.f, q1v = 0.f;
            if (q < Nq) {
              const bf16* qr = qrow + ((size_t)b * Nq + q) * qw + c;
              q0v = bf(qr[0]);
              q1v = bf(qr[1]);
            }
            const float2 k = unpack2(
                *reinterpret_cast<const uint32_t*>(srcb + (size_t)rid[r] * rw + c));
            *reinterpret_cast<uint32_t*>(rr + r * ld + c) =
                pack2((k.x - q0v) + (x0 + bp2[c]), (k.y - q1v) + (x1 + bp2[c + 1]));
          });
        });
    __syncthreads();

    // 3: t = (bf16(relation) @ bf16(W1) + b1) * valid on tensor cores (at
    //    C = 512, R = 32: the G columns in four strips, one per warp)
    t_rows<T, G, true, (C > 384 ? kWarps / (R / 16) : 1)>(rr, w1t, b1, vld, tt);
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

template <int C>
cudaError_t stats_attr() {
  constexpr size_t smem = stats_smem<C>();
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  return cudaFuncSetAttribute(gva_stats_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C>
int stats_run(const void* src, const void* qrow, const void* idx,
              const void* valid, const void* A, const void* cA, const void* Wp2,
              const void* bp2, const void* W1, const void* b1, void* part,
              int B, int Nsrc, int Nq, int nblk, void* stream) {
  cudaError_t e = stats_attr<C>();
  if (e != cudaSuccess) return e;
  gva_stats_kernel<C><<<nblk, kThreads, stats_smem<C>(), (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const float*)bp2, (const bf16*)W1, (const float*)b1,
      (float*)part, B, Nsrc, Nq);
  return cudaGetLastError();
}

template <int C>
int stats_occupancy(int* blocks) {
  cudaError_t e = stats_attr<C>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gva_stats_kernel<C>, kThreads, stats_smem<C>());
}

}  // namespace

// The instances: S = 16 and group width C / G = 8 at C = 48, 96, 192, 384
// (every stage of the S3DIS config) and 512 (the ScanNet config's deepest
// encoder stage, G = 64).
extern "C" int gva_stats_launch(const void* src, const void* qrow,
                                const void* idx, const void* valid,
                                const void* A, const void* cA, const void* Wp2,
                                const void* bp2, const void* W1,
                                const void* b1, void* part, int B, int Nsrc,
                                int Nq, int S, int C, int G, int nblk,
                                void* stream) {
  if (S != kS || G * 8 != C || Nsrc < 1 || nblk < 1) return cudaErrorInvalidValue;
#define AO_STATS(CC)                                                          \
  case CC:                                                                    \
    return stats_run<CC>(src, qrow, idx, valid, A, cA, Wp2, bp2, W1, b1, part, \
                         B, Nsrc, Nq, nblk, stream);
  switch (C) {
    AO_STATS(48)
    AO_STATS(96)
    AO_STATS(192)
    AO_STATS(384)
    AO_STATS(512)
  }
#undef AO_STATS
  return cudaErrorInvalidValue;
}

// blocks of gva_stats_kernel<C> one SM holds (shared memory, registers)
extern "C" int gva_stats_blocks_per_sm(int C, int* blocks) {
  switch (C) {
    case 48: return stats_occupancy<48>(blocks);
    case 96: return stats_occupancy<96>(blocks);
    case 192: return stats_occupancy<192>(blocks);
    case 384: return stats_occupancy<384>(blocks);
    case 512: return stats_occupancy<512>(blocks);
  }
  return cudaErrorInvalidValue;
}
