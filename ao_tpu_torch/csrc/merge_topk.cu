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
// What bounds it on the card: device memory. A row reads width x 8 bytes
// and writes k x 8 bytes and does about 3 x k x width integer operations.
// What the design does about it: one thread per row keeps its row in
// registers and local memory (at most 64 packed scores and ids), so every
// input byte is read once and every output written once.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

__global__ void merge_topk_kernel(const float* __restrict__ d2,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out_d2,
                                  int* __restrict__ out_idx, long long rows,
                                  int width, int k) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  uint32_t packed[64];
  int ids[64];
  const float* dr = d2 + r * width;
  const int* ir = idx + r * width;
  for (int c = 0; c < width; ++c) {
    const float s = fmaxf(dr[c], FLT_MIN);
    packed[c] = (__float_as_uint(s) & ~63u) | (uint32_t)c;
    ids[c] = ir[c];
  }
  const float big = 1e30f;
  const float half_big = big / 2.0f;
  for (int j = 0; j < k; ++j) {
    // scores are positive normal floats: their bit patterns order as the
    // floats do
    uint32_t m = packed[0];
    for (int c = 1; c < width; ++c) m = min(m, packed[c]);
    const int am = (int)(m & 63u);
    const int chosen = am < width ? ids[am] : INT_MAX;
    out_d2[r * k + j] = __uint_as_float(m & ~63u);
    out_idx[r * k + j] = chosen;
    for (int c = 0; c < width; ++c) {
      if (ids[c] == chosen && __uint_as_float(packed[c]) < half_big) {
        packed[c] = __float_as_uint(big);
      }
    }
  }
}

}  // namespace

extern "C" int merge_topk_launch(const void* d2, const void* idx,
                                 void* out_d2, void* out_idx, long long rows,
                                 int width, int k, void* stream) {
  if (width < 1 || width > 64 || k < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (rows + threads - 1) / threads;
  merge_topk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)d2, (const int*)idx, (float*)out_d2, (int*)out_idx, rows,
      width, k);
  return cudaGetLastError();
}
