// Farthest point sampling (FPS), one thread block a scene.
//
// Replaces no TPU kernel: ao_tpu computes FPS (ao_tpu/ops/sampling.py:22-57)
// as one compiled lax.fori_loop, and PyTorch has no such loop, so a plain
// version launches a handful of small kernels for each of the m samples.
// PT-v1's TransitionDown samples m = N / 4 points of each scene at four
// stages (20480 + 5120 + 1280 + 320 = 27200 samples a forward at 81920
// points), so this kernel takes the whole loop on the card.
//
// Contract (equal, index for index, to the plain version in
// ops/sampling.py and to ao_tpu's): the first sample is start_idx; every
// point's running min_d2 starts at 1e30; each step takes the last sample
// p and sets min_d2[i] = min(min_d2[i], d2(i, p)) with d2 =
// fma(dz, dz, fma(dy, dy, dx * dx)), the order of XLA's fused
// multiply-adds in ao_tpu's jnp.sum(diff * diff, -1), each fma written out
// as a float64 product and sum rounded to f32 (explicit _rn intrinsics:
// no contraction by nvcc may move a near tie, and the plain version does
// the same float64 operations, so the two agree bit for bit). That is
// fmaf's result except where the float64 sum, rounded once already, lies
// exactly halfway between two floats (a double rounding, about 2^-29 of
// operations on random inputs); against ao_tpu a sample can differ only
// where such a step decides a tie. Padded points score -1e30; the next sample
// is the first maximum (the lowest index among equal scores). Samples at
// or past the scene's valid count n_valid hold index 0; the loop stops
// there.
//
// Design: one block of 1024 threads per scene; thread t owns the points t,
// t + 1024, ... and keeps their running min_d2 in shared memory when the
// scene's N floats fit (N <= 51200), else in a global scratch row (L2
// resident). The coordinates come as three planes (x, y, z), so a warp's
// loads are contiguous. A step: each thread scans its points in increasing
// index (so its own first maximum wins), then a warp argmax by shuffles
// and one across the 32 warps through shared memory, ties to the lower
// index; the chosen index goes through shared memory to every thread,
// which reads its coordinates (a broadcast load).
//
// What bounds it on this card: the m - 1 sequential steps. The bytes (each
// coordinate and mask byte read once, each index written once) are
// microseconds; the operations, about 12 a point and step (4 of them in
// float64), are a few ms at the card's rate, but one block runs on one
// SM, so only B of the
// 132 SMs work and a 81920-point scene's coordinates (960 KiB) do not fit
// one SM's shared memory: every step reads them again from L2. Spreading a
// scene over a thread-block cluster with distributed shared memory is
// later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;
constexpr float kNegBig = -1e30f;
// the running distances stay in shared memory up to this many bytes
constexpr int kMaxSharedBytes = 200 * 1024;

// (v, i) <- (ov, oi) when ov is larger, or equal at a lower index
__device__ __forceinline__ void take(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// fma(c, c, fma(b, b, a * a)) with each fma as a float64 product and sum
// rounded to f32: the plain version's arithmetic (ops/knn.py: fma_chain),
// a true fmaf but for the double rounding of a midpoint (about 2^-29)
__device__ __forceinline__ float fma_chain(float a, float b, float c) {
  const float acc = __fmul_rn(a, a);
  const float t = __double2float_rn(
      __dadd_rn(__dmul_rn((double)b, (double)b), (double)acc));
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)c, (double)c), (double)t));
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz,     // (3, B, N) planes
               const uint8_t* __restrict__ mask,  // (B, N)
               float* __restrict__ scratch,       // (B, N), when not shared
               int* __restrict__ out,             // (B, m)
               int B, int N, int m, int start_idx, int shared_d2) {
  extern __shared__ float sh_d2[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_sel;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* X = xyz + (size_t)b * N;
  const float* Y = xyz + (size_t)(B + b) * N;
  const float* Z = xyz + (size_t)(2 * B + b) * N;
  const uint8_t* mk = mask + (size_t)b * N;
  float* d2s = shared_d2 ? sh_d2 : scratch + (size_t)b * N;
  int* o = out + (size_t)b * m;

  int cnt = 0;
  for (int i = tid; i < N; i += kThreads) {
    d2s[i] = kBig;
    cnt += mk[i] != 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) red_i[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    int c = red_i[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) s_sel = c;
  }
  __syncthreads();
  const int n_valid = s_sel;
  const int steps = min(m, n_valid);
  for (int i = tid; i < m; i += kThreads)
    o[i] = (i == 0 && n_valid > 0) ? start_idx : 0;
  __syncthreads();  // every thread has read n_valid before s_sel is reused

  int last = start_idx;
  for (int it = 1; it < steps; ++it) {
    const float px = X[last], py = Y[last], pz = Z[last];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < N; i += kThreads) {
      float s = kNegBig;
      if (mk[i]) {
        const float dx = __fsub_rn(X[i], px);
        const float dy = __fsub_rn(Y[i], py);
        const float dz = __fsub_rn(Z[i], pz);
        const float d2 = fma_chain(dx, dy, dz);
        s = fminf(d2s[i], d2);
        d2s[i] = s;
      }
      if (s > bv) {  // strictly: the thread's first maximum
        bv = s;
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_sel = bi;
        o[it] = bi;
      }
    }
    __syncthreads();
    last = s_sel;
  }
}

}  // namespace

extern "C" int fps_launch(const void* xyz, const void* mask, void* scratch,
                          void* out, int B, int N, int m, int start_idx,
                          void* stream) {
  if (B < 0 || N < 1 || m < 0 || start_idx < 0 || start_idx >= N)
    return cudaErrorInvalidValue;
  if (B == 0 || m == 0) return cudaSuccess;
  const long long bytes = (long long)N * (long long)sizeof(float);
  const int shared_d2 = bytes <= kMaxSharedBytes;
  const size_t smem = shared_d2 ? (size_t)bytes : 0;
  if (shared_d2) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const uint8_t*)mask, (float*)scratch, (int*)out, B,
      N, m, start_idx, shared_d2);
  return cudaGetLastError();
}
