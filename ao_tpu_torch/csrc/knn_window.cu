// K1: windowed k-nearest-neighbour search over curve-sorted keys.
//
// Replaces ao_tpu/ops/pallas/knn_window.py (knn_window_pallas ->
// _knn_window_kernel, pallas_call at :108). For every tile of `tile_q`
// curve-sorted queries it scores the `window` sorted keys starting at
// window_starts[b, t] as  s = |k|^2 - 2 q.k  (|k|^2 carries the 1e30
// penalty of invalid keys) and emits the k smallest scores ascending, with
// the ORIGINAL id order[col] of each. Ties go to the lowest window column,
// as in the TPU kernel's k rounds of min / argmin.
//
// What bounds it on the card: arithmetic. Each query does `window`
// 3-term dot products plus a compare (about 8 f32 operations per pair);
// the bytes (keys read once per tile, k outputs per query) are a few
// percent of that at window = 512..640.
// What the design does about it: one block per (batch, tile) stages the
// window's keys, |k|^2 and ids in shared memory (640 x 20 B = 13 KB), so
// every key is read from device memory once per tile and then broadcast
// to all queries of the tile. One thread per query keeps its k best in
// registers as a sorted list (fully unrolled insertion, K is a template
// parameter), so no score tile is ever materialised. Window starts out of
// range clamp to [0, Nk - window], as the TPU kernel's dynamic slice does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int K>
__global__ void knn_window_kernel(
    const float* __restrict__ keys,    // (B, Nk, 3) curve-sorted
    const float* __restrict__ k2,      // (B, Nk) |k|^2 + invalid penalty
    const int* __restrict__ order,     // (B, Nk) original id per sorted row
    const float* __restrict__ queries, // (B, Nq, 3) curve-sorted, Nq = T * tile_q
    const int* __restrict__ ws,        // (B, T) window starts
    float* __restrict__ d2_out,        // (B, Nq, K)
    int* __restrict__ idx_out,         // (B, Nq, K)
    int Nk, int Nq, int T, int tile_q, int window) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + window;
  float* sz = sy + window;
  float* sk2 = sz + window;
  int* sord = reinterpret_cast<int*>(sk2 + window);

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  int start = ws[(size_t)b * T + t];
  start = min(max(start, 0), Nk - window);
  const float* kb = keys + ((size_t)b * Nk + start) * 3;
  for (int c = threadIdx.x; c < window; c += blockDim.x) {
    sx[c] = kb[3 * c + 0];
    sy[c] = kb[3 * c + 1];
    sz[c] = kb[3 * c + 2];
    sk2[c] = k2[(size_t)b * Nk + start + c];
    sord[c] = order[(size_t)b * Nk + start + c];
  }
  __syncthreads();

  for (int qi = threadIdx.x; qi < tile_q; qi += blockDim.x) {
    const size_t q = (size_t)b * Nq + (size_t)t * tile_q + qi;
    const float qx = queries[3 * q + 0];
    const float qy = queries[3 * q + 1];
    const float qz = queries[3 * q + 2];
    float bd[K];
    int bc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[j] = INFINITY;
      bc[j] = 0;
    }
    for (int c = 0; c < window; ++c) {
      const float s = sk2[c] - 2.0f * (qx * sx[c] + qy * sy[c] + qz * sz[c]);
      if (s < bd[K - 1]) {
        // insert keeping ascending order; a later column never passes an
        // equal score, so ties stay in column order
        bool placed = false;
#pragma unroll
        for (int j = K - 1; j >= 0; --j) {
          if (!placed) {
            if (j > 0 && bd[j - 1] > s) {
              bd[j] = bd[j - 1];
              bc[j] = bc[j - 1];
            } else {
              bd[j] = s;
              bc[j] = c;
              placed = true;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d2_out[q * K + j] = bd[j];
      idx_out[q * K + j] = sord[bc[j]];
    }
  }
}

template <int K>
cudaError_t launch(const float* keys, const float* k2, const int* order,
                   const float* queries, const int* ws, float* d2, int* idx,
                   int B, int Nk, int Nq, int T, int tile_q, int window,
                   cudaStream_t stream) {
  const size_t smem = (size_t)window * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_window_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = tile_q < 256 ? ((tile_q + 31) / 32) * 32 : 256;
  knn_window_kernel<K><<<dim3(T, B), threads, smem, stream>>>(
      keys, k2, order, queries, ws, d2, idx, Nk, Nq, T, tile_q, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_window_launch(const void* keys, const void* k2,
                                 const void* order, const void* queries,
                                 const void* ws, void* d2, void* idx, int B,
                                 int Nk, int Nq, int T, int k, int tile_q,
                                 int window, void* stream) {
  if (window < k || window > Nk || Nq != T * tile_q) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
#define AO_KNN_CASE(KK)                                                        \
  case KK:                                                                     \
    return launch<KK>((const float*)keys, (const float*)k2, (const int*)order, \
                      (const float*)queries, (const int*)ws, (float*)d2,       \
                      (int*)idx, B, Nk, Nq, T, tile_q, window,                 \
                      (cudaStream_t)stream);
  // k = 16 builds the S3DIS config's self graphs, k = 3 the unpool
  // (interpolation) graph; a config with other counts adds an instance
  switch (k) {
    AO_KNN_CASE(3) AO_KNN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef AO_KNN_CASE
}

extern "C" const char* ao_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
