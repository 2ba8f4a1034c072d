// K2: merge multi-probe kNN candidates with duplicate suppression.
//
// Replaces ao_tpu/ops/pallas/merge_topk.py (merge_topk_dedup ->
// _merge_kernel, pallas_call at :91). Each row holds P probes x k
// candidates (width <= 64). The output contract is reproduced bit for bit:
// every score is clamped to FLT_MIN, its 6 low mantissa bits are replaced
// by its column, and k rounds take the minimum of these packed values
// (so ties go to the lowest column), emit the packed score with the
// column bits cleared and the id of that column, then mask every
// still-active slot holding the emitted id to 1e30. A masked slot can win
// a later round only when fewer than k distinct ids exist; the packed bits
// of 1e30 then name a column as in the TPU kernel, and a column past the
// width yields INT32_MAX.
//
// Two entry points:
//
// * merge_topk_launch: rows of already concatenated candidates, (rows,
//   width) scores and ids. Instances with every loop unrolled for the
//   path's widths (W, k) = (6, 3) and (48, 16), and a generic one with
//   runtime width <= 64 and k.
// * merge_topk_probes_launch: the whole tail of a multi-probe search in
//   one pass. Each probe p hands over what its window search left in its
//   own curve-sorted query order: scores s_p (B, Nqp, k) without |q|^2,
//   ids (B, Nqp, k), |q|^2 q2_p (B, Nqp), and the inverse permutation
//   inv_p (B, Nq) from original query to sorted row. A thread of original
//   query q reads row inv_p[q] of every probe, forms d2 = s + q2 as one
//   f32 add (1e30 where s > 1e30 / 2), clamps ids at 0 and merges; so the
//   probes' concatenation and their gathers back to query order never
//   touch device memory. Instances (P, k) = (2, 3) (the unpool search)
//   and (3, 16) (a multi-probe self graph).
//
// What bounds it on the card: device memory. A query of the fused pass
// reads P x (4 + 8k + 4) bytes (inverse row, scores and ids, |q|^2) and
// writes 8k; the merge does about 3 x k x width integer operations, all in
// registers. What the design does about it: one thread per row keeps the
// row in registers (loops unrolled over compile-time widths, so no array
// goes to local memory) and every input byte is read once and every output
// written once; in the fused pass a warp gathers its 32 queries' scattered
// probe rows cooperatively through shared memory, so that a warp-wide load
// touches about 32 / k lines instead of 32, and stores its outputs as
// contiguous words. Blocks of 256 threads.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kHalfBig = kBig / 2.0f;

__device__ __forceinline__ uint32_t pack(float s, int c) {
  return (__float_as_uint(fmaxf(s, FLT_MIN)) & ~63u) | (uint32_t)c;
}

// k rounds over a register row of W packed scores and ids; scores are
// positive normal floats, so their bit patterns order as the floats do
template <int W, int K>
__device__ __forceinline__ void merge_row(uint32_t (&packed)[W],
                                          const int (&ids)[W],
                                          float* __restrict__ out_d2,
                                          int* __restrict__ out_idx) {
  const uint32_t half_big = __float_as_uint(kHalfBig);
  const uint32_t big = __float_as_uint(kBig);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t m = packed[0];
#pragma unroll
    for (int c = 1; c < W; ++c) m = min(m, packed[c]);
    const uint32_t am = m & 63u;
    int chosen = INT_MAX;
#pragma unroll
    for (int c = 0; c < W; ++c) chosen = am == (uint32_t)c ? ids[c] : chosen;
    out_d2[j] = __uint_as_float(m & ~63u);
    out_idx[j] = chosen;
    if (j + 1 < K) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (ids[c] == chosen && packed[c] < half_big) packed[c] = big;
      }
    }
  }
}

template <int W, int K>
__global__ void __launch_bounds__(256)
    merge_topk_kernel(const float* __restrict__ d2,
                      const int* __restrict__ idx, float* __restrict__ out_d2,
                      int* __restrict__ out_idx, long long rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  uint32_t packed[W];
  int ids[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    packed[c] = pack(__ldg(d2 + r * W + c), c);
    ids[c] = __ldg(idx + r * W + c);
  }
  float od[K];
  int oi[K];
  merge_row<W, K>(packed, ids, od, oi);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d2[r * K + j] = od[j];
    out_idx[r * K + j] = oi[j];
  }
}

// any width <= 64 and k: the row lives in local memory
__global__ void __launch_bounds__(128)
    merge_topk_generic_kernel(const float* __restrict__ d2,
                              const int* __restrict__ idx,
                              float* __restrict__ out_d2,
                              int* __restrict__ out_idx, long long rows,
                              int width, int k) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  uint32_t packed[64];
  int ids[64];
  for (int c = 0; c < width; ++c) {
    packed[c] = pack(d2[r * width + c], c);
    ids[c] = idx[r * width + c];
  }
  const uint32_t half_big = __float_as_uint(kHalfBig);
  for (int j = 0; j < k; ++j) {
    uint32_t m = packed[0];
    for (int c = 1; c < width; ++c) m = min(m, packed[c]);
    const int am = (int)(m & 63u);
    const int chosen = am < width ? ids[am] : INT_MAX;
    out_d2[r * k + j] = __uint_as_float(m & ~63u);
    out_idx[r * k + j] = chosen;
    for (int c = 0; c < width; ++c) {
      if (ids[c] == chosen && packed[c] < half_big)
        packed[c] = __float_as_uint(kBig);
    }
  }
}

constexpr int kMaxProbes = 3;

struct Probes {
  const float* s[kMaxProbes];
  const int* idx[kMaxProbes];
  const float* q2[kMaxProbes];
  const int* inv[kMaxProbes];
};

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// A warp takes 32 consecutive original queries. Their rows in a probe's
// sorted order are scattered, so a thread loading its own k scores would
// issue k loads to k words of one random row, each a warp-wide request to
// 32 scattered lines; instead the warp loads its 32 rows' scores and ids
// cooperatively (lane e of pass i takes word (32 i + e) of the 32 rows'
// concatenation: rows of k words sit on neighbouring lanes, about 32 / k
// lines a request) into shared memory, and each thread reads its own row
// from there. The outputs leave the same way, as contiguous words.
template <int P, int K>
__global__ void __launch_bounds__(kThreads)
    merge_topk_probes_kernel(Probes pr, float* __restrict__ out_d2,
                             int* __restrict__ out_idx, int B, int Nq,
                             int Nqp) {
  constexpr int W = P * K;
  constexpr int KS = K | 1;  // an odd row stride: no bank conflicts
  // every probe's rows in flight at once where they fit in shared memory
  // (k = 3); otherwise one probe after the other through one buffer
  constexpr int D = P * KS <= 16 ? P : 1;
  __shared__ float s_sh[kThreads / 32][D][32 * KS];
  __shared__ int i_sh[kThreads / 32][D][32 * KS];
  const int lane = threadIdx.x & 31;
  float(*ws)[32 * KS] = s_sh[threadIdx.x >> 5];
  int(*wi)[32 * KS] = i_sh[threadIdx.x >> 5];
  const int n = B * Nq;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = t - lane;  // the warp's first query
  if (base >= n) return;      // whole warps only: the rest shuffle
  const bool live = t < n;
  const int b = live ? t / Nq : 0;
  int row[P];
  float q2[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    row[p] = live ? b * Nqp + __ldg(pr.inv[p] + t) : -1;
#pragma unroll
  for (int p = 0; p < P; ++p) q2[p] = live ? __ldg(pr.q2[p] + row[p]) : 0.0f;
  uint32_t packed[W];
  int ids[W];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float* bs = ws[p % D];
    int* bi = wi[p % D];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int e = i * 32 + lane;
      const int qi = e / K, j = e - qi * K;
      const int r = __shfl_sync(kFull, row[p], qi);
      if (r >= 0) {
        bs[qi * KS + j] = __ldg(pr.s[p] + (long long)r * K + j);
        bi[qi * KS + j] = __ldg(pr.idx[p] + (long long)r * K + j);
      }
    }
    if (D == 1 || p == P - 1) {
      __syncwarp();
#pragma unroll
      for (int pp = D == 1 ? p : 0; pp <= p; ++pp) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float sj = ws[pp % D][lane * KS + j];
          const float d = sj > kHalfBig ? kBig : __fadd_rn(sj, q2[pp]);
          packed[pp * K + j] = pack(d, pp * K + j);
          ids[pp * K + j] = max(wi[pp % D][lane * KS + j], 0);
        }
      }
      __syncwarp();
    }
  }
  float od[K];
  int oi[K];
  merge_row<W, K>(packed, ids, od, oi);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ws[0][lane * KS + j] = od[j];
    wi[0][lane * KS + j] = oi[j];
  }
  __syncwarp();
  const long long o = (long long)base * K;
  const int words = min(32, n - base) * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int e = i * 32 + lane;
    if (e < words) {
      const int qi = e / K, j = e - qi * K;
      out_d2[o + e] = ws[0][qi * KS + j];
      out_idx[o + e] = wi[0][qi * KS + j];
    }
  }
}

template <int W, int K>
cudaError_t launch_rows(const void* d2, const void* idx, void* out_d2,
                        void* out_idx, long long rows, cudaStream_t stream) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  merge_topk_kernel<W, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)d2, (const int*)idx, (float*)out_d2, (int*)out_idx, rows);
  return cudaGetLastError();
}

template <int P, int K>
cudaError_t launch_probes(const Probes& pr, void* out_d2, void* out_idx,
                          int B, int Nq, int Nqp, cudaStream_t stream) {
  const long long n = (long long)B * Nq;
  const long long blocks = (n + kThreads - 1) / kThreads;
  merge_topk_probes_kernel<P, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      pr, (float*)out_d2, (int*)out_idx, B, Nq, Nqp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int merge_topk_launch(const void* d2, const void* idx,
                                 void* out_d2, void* out_idx, long long rows,
                                 int width, int k, void* stream) {
  if (width < 1 || width > 64 || k < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 6 && k == 3)
    return launch_rows<6, 3>(d2, idx, out_d2, out_idx, rows, st);
  if (width == 48 && k == 16)
    return launch_rows<48, 16>(d2, idx, out_d2, out_idx, rows, st);
  const int threads = 128;
  const long long blocks = (rows + threads - 1) / threads;
  merge_topk_generic_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      (const float*)d2, (const int*)idx, (float*)out_d2, (int*)out_idx, rows,
      width, k);
  return cudaGetLastError();
}

// s, idx, q2, inv: arrays of P device pointers each (host memory)
extern "C" int merge_topk_probes_launch(const void* const* s,
                                        const void* const* idx,
                                        const void* const* q2,
                                        const void* const* inv, void* out_d2,
                                        void* out_idx, int P, int k, int B,
                                        int Nq, int Nqp, void* stream) {
  const bool instance = (P == 2 && k == 3) || (P == 3 && k == 16);
  if (!instance || Nq > Nqp ||
      (long long)B * Nqp * k >= INT_MAX)
    return cudaErrorInvalidValue;
  if ((long long)B * Nq == 0) return cudaSuccess;
  Probes pr{};
  for (int p = 0; p < P; ++p) {
    pr.s[p] = (const float*)s[p];
    pr.idx[p] = (const int*)idx[p];
    pr.q2[p] = (const float*)q2[p];
    pr.inv[p] = (const int*)inv[p];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (P == 2) return launch_probes<2, 3>(pr, out_d2, out_idx, B, Nq, Nqp, st);
  return launch_probes<3, 16>(pr, out_d2, out_idx, B, Nq, Nqp, st);
}
