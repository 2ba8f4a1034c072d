// PointBatchNorm (models/utils.py) on the card: the masked BatchNorm over
// the valid rows of a padded batch, with the ReLU after it fused when the
// caller asks, forward and backward.
//
// Replaces no TPU kernel: ao_tpu computes PointBatchNorm
// (ao_tpu/models/utils.py) as jnp ops that XLA fuses. PyTorch runs the same
// composite as about 44 launches forward and 45 backward a call, each a
// pass over the activation, and autograd keeps f32 copies of it (about 12
// bytes an element in bf16). PT-v2m2 calls it 86 times a forward in the
// S3DIS config, on 2.6 G elements.
//
// Contract (ops/point_bn.py, point_batch_norm_plain), over rows r with
// mask m_r (1 when there is no mask) and channels c:
//   train: n = max(sum m, 1), mean = sum m x / n, var = sum m (x - mean)^2
//     / n (two passes), the running statistics updated in place as torch's
//     BatchNorm1d does (the variance unbiased, n / max(n - 1, 1));
//   eval: mean and var the running ones;
//   rstd = 1 / sqrt(var + eps), xhat = (x - mean) * rstd,
//   y = m ? [relu](xhat * w + b) : 0 in x's type, each f32 operation
//     rounded in that order (no contraction), as the composite computes;
//   backward, g' = m g [y > 0] (y recomputed from x when the ReLU is fused):
//     db = sum g', dw = sum g' xhat,
//     dx = m rstd w (g' - (db + xhat dw) / n) (train), m rstd w g' (eval).
//
// What bounds it: bytes. An element is 2 (bf16) or 4 (f32) bytes, read
// three times and written once forward (both statistics passes, then the
// normalisation), read twice as x and twice as g and written once backward;
// the operations are a few an element.
//
// Design. Five kernels, three launches forward in train mode (one in eval)
// and two backward. A block of 512 threads walks row strips of the batch:
// a thread owns a chunk of 8 channels (one 16-byte load of bf16, two of
// f32; 1 channel on the scalar path, for widths that are not a multiple of
// 8) at one row of the strip, and issues the loads of several strips
// before it uses any. A row's chunks take at most 32 threads; wider rows
// split into channel tiles along the grid's y. Rows whose mask byte is 0
// are neither read nor summed. Each statistics pass ends in a block
// reduction to one f32 partial row per block; the next kernel's prologue
// adds the partial rows in f64 in an order fixed by the grid, so the
// results are the same on every run (no atomics). The grid is one block an
// SM, so that the prologues, which every block runs, read at most one
// partial row an SM. Under a process group the wrapper adds the partial
// rows and all-reduces them between the launches, and hands the next kernel
// the one global row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kMaxLanes = 32;  // threads a row's tile at most
constexpr int kVec = 8;        // channels of a chunk on the vector path

// ---- one chunk as f32 --------------------------------------------------

__device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}

__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

__device__ __forceinline__ void store(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  p[0] = v[0];
}

// v rounded to the type T (the composite's cast of y to x's type)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- where a thread works ----------------------------------------------

// A block covers `rows` rows of a strip at once; thread t works at row
// t / lanes of it, on chunk t % lanes of the tile blockIdx.y, whose
// channels are [c0, c0 + nc).
template <int V>
struct Place {
  int lanes, rows, lane, rl, cc, c0, nc;
  bool active;

  __device__ Place(int C, int lanes_) {
    lanes = lanes_;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    rl = threadIdx.x / lanes;
    const int chunk = blockIdx.y * lanes + lane;
    c0 = blockIdx.y * lanes * V;
    nc = min(lanes * V, C - c0);
    cc = chunk * V;
    active = rl < rows && chunk < C / V;
  }
};

// out[k] = the sum over r < nrow of at(r, k), for k < K <= kThreads, in f64
// and in an order fixed by (nrow, K): each of G = kThreads / K groups adds
// the rows g, g + G, ..., then the G sums are added in order. `out` may be
// `scratch` (kThreads doubles). Every thread of the block calls it.
template <typename At>
__device__ void column_sums(At at, int nrow, int K, double* scratch,
                            double* out) {
  const int G = kThreads / K;
  const int k = threadIdx.x % K, g = threadIdx.x / K;
  if (g < G) {
    double s = 0.0;
#pragma unroll 4
    for (int r = g; r < nrow; r += G) s += (double)at(r, k);
    scratch[g * K + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = 0.0;
    for (int i = 0; i < G; ++i) s += scratch[i * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// the block's sums of acc over its rows, one per channel of the tile, into
// scratch[0, nc)
template <int V>
__device__ void block_sums(const Place<V>& p, const float (&acc)[V],
                           float* red, double* scratch) {
  if (p.rl < p.rows) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[threadIdx.x * V + j] = acc[j];
  }
  __syncthreads();
  const int K = p.lanes * V;
  column_sums([&](int r, int k) { return red[r * K + k]; }, p.rows, K,
              scratch, scratch);
}

// the sum of v over the block's threads (every thread calls it)
__device__ int block_count(int v, int* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
  return s;
}

// ---- forward -------------------------------------------------------------

// pass 1: part[block] = [sum m x (C) | sum m]
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    sum_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
               float* __restrict__ part, int R, int C, int lanes) {
  __shared__ float red[kThreads * V];
  __shared__ double scratch[kThreads];
  __shared__ int warp_sums[kThreads / 32];
  const Place<V> p(C, lanes);
  float acc[V] = {};
  int cnt = 0;
  if (p.active) {
    const long long step = (long long)gridDim.x * p.rows;
    for (long long r0 = (long long)blockIdx.x * p.rows + p.rl; r0 < R;
         r0 += step * U) {
      float v[U][V];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long r = r0 + u * step;
        ok[u] = r < R && (mask == nullptr || mask[r]);
        if (ok[u]) load(x + r * C + p.cc, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        ++cnt;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[u][j];
      }
    }
  }
  const int n = block_count(p.active && p.lane == 0 ? cnt : 0, warp_sums);
  block_sums(p, acc, red, scratch);
  float* row = part + (size_t)blockIdx.x * (C + 1);
  if (threadIdx.x < p.nc) row[p.c0 + threadIdx.x] = (float)scratch[threadIdx.x];
  if (blockIdx.y == 0 && threadIdx.x == 0) row[C] = (float)n;
}

// pass 2: the mean from pass 1's partial rows `sums` (nrow of them), then
// part[block] = sum m (x - mean)^2; block (0, y) writes the mean and n
// into stats = [mean (C) | rstd (C) | n]
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    sqdev_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                 const float* __restrict__ sums, float* __restrict__ part,
                 float* __restrict__ stats, int nrow, int R, int C,
                 int lanes) {
  __shared__ float red[kThreads * V];
  __shared__ double scratch[kThreads];
  __shared__ float mean_s[kMaxLanes * V];
  const Place<V> p(C, lanes);
  const int ld = C + 1;
  column_sums(
      [&](int r, int k) {
        return sums[(size_t)r * ld + (k < p.nc ? p.c0 + k : C)];
      },
      nrow, p.nc + 1, scratch, scratch);
  const double n = fmax(scratch[p.nc], 1.0);
  if (threadIdx.x < p.nc) {
    const float mean = (float)(scratch[threadIdx.x] / n);
    mean_s[threadIdx.x] = mean;
    if (blockIdx.x == 0) stats[p.c0 + threadIdx.x] = mean;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    stats[2 * C] = (float)n;
  __syncthreads();
  float m[V], acc[V] = {};
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = p.active ? mean_s[p.lane * V + j] : 0.f;
  if (p.active) {
    const long long step = (long long)gridDim.x * p.rows;
    for (long long r0 = (long long)blockIdx.x * p.rows + p.rl; r0 < R;
         r0 += step * U) {
      float v[U][V];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long r = r0 + u * step;
        ok[u] = r < R && (mask == nullptr || mask[r]);
        if (ok[u]) load(x + r * C + p.cc, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = __fsub_rn(v[u][j], m[j]);
          acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
        }
      }
    }
  }
  block_sums(p, acc, red, scratch);
  if (threadIdx.x < p.nc)
    part[(size_t)blockIdx.x * C + p.c0 + threadIdx.x] =
        (float)scratch[threadIdx.x];
}

// the normalisation: in train mode the variance from pass 2's partial rows
// `sq` (nrow of them) and the mean and n from stats; in eval mode the
// running statistics. Block (0, y) writes rstd (and, in eval mode, the
// mean) into stats and, in train mode, updates the running statistics and
// num_batches_tracked in place.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    norm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                const float* __restrict__ sq, float* __restrict__ stats,
                const float* __restrict__ weight,
                const float* __restrict__ bias, float* running_mean,
                float* running_var, long long* num_batches,
                T* __restrict__ y, int nrow, int R, int C, int lanes,
                int train, int relu, float eps, float momentum,
                float keep) {
  __shared__ double scratch[kThreads];
  __shared__ float mean_s[kMaxLanes * V], rstd_s[kMaxLanes * V];
  const Place<V> p(C, lanes);
  if (train)
    column_sums([&](int r, int k) { return sq[(size_t)r * C + p.c0 + k]; },
                nrow, p.nc, scratch, scratch);
  if (threadIdx.x < p.nc) {
    const int c = p.c0 + threadIdx.x;
    float mean, var;
    if (train) {
      const float n = stats[2 * C];
      mean = stats[c];
      var = (float)(scratch[threadIdx.x] / (double)n);
      if (blockIdx.x == 0) {
        const float unbiased =
            __fdiv_rn(__fmul_rn(var, n), fmaxf(__fsub_rn(n, 1.f), 1.f));
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep),
                                    __fmul_rn(momentum, mean));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], keep),
                                   __fmul_rn(momentum, unbiased));
      }
    } else {
      mean = running_mean[c];
      var = running_var[c];
    }
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    mean_s[threadIdx.x] = mean;
    rstd_s[threadIdx.x] = rstd;
    if (blockIdx.x == 0) {
      stats[C + c] = rstd;
      if (!train) stats[c] = mean;
    }
  }
  if (train && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    num_batches[0] += 1;
  __syncthreads();
  if (!p.active) return;
  float m[V], rs[V], w[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean_s[p.lane * V + j];
    rs[j] = rstd_s[p.lane * V + j];
    w[j] = weight[p.cc + j];
    b[j] = bias[p.cc + j];
  }
  const long long step = (long long)gridDim.x * p.rows;
  for (long long r0 = (long long)blockIdx.x * p.rows + p.rl; r0 < R;
       r0 += step * U) {
    float v[U][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * step;
      ok[u] = r < R && (mask == nullptr || mask[r]);
      if (ok[u]) load(x + r * C + p.cc, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * step;
      if (r >= R) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = 0.f;
        if (!ok[u]) continue;
        const float t = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[u][j], m[j]), rs[j]), w[j]), b[j]);
        o[j] = relu && t <= 0.f ? 0.f : t;
      }
      store(y + r * C + p.cc, o);
    }
  }
}

// ---- backward ------------------------------------------------------------

// this thread's per-channel constants of the backward
template <int V>
struct Coef {
  float m[V], rs[V], w[V], b[V];

  __device__ Coef(const Place<V>& p, const float* stats,
                  const float* weight, const float* bias, int C) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = stats[p.cc + j];
      rs[j] = stats[C + p.cc + j];
      w[j] = weight[p.cc + j];
      b[j] = bias[p.cc + j];
    }
  }

  // xhat of one chunk, and g zeroed where the fused ReLU's output is not
  // positive (y recomputed as the forward computed and rounded it)
  template <typename T>
  __device__ __forceinline__ void gate(const float (&x)[V], float (&g)[V],
                                       float (&xh)[V], int relu) const {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xh[j] = __fmul_rn(__fsub_rn(x[j], m[j]), rs[j]);
      if (relu) {
        const float t = round_to(__fadd_rn(__fmul_rn(xh[j], w[j]), b[j]),
                                 (const T*)nullptr);
        if (!(t > 0.f)) g[j] = 0.f;
      }
    }
  }
};

// part[block] = [sum g' (C) | sum g' xhat (C)]
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_sums_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                    const T* __restrict__ g, const float* __restrict__ stats,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ part,
                    int R, int C, int lanes, int relu) {
  __shared__ float red[kThreads * V];
  __shared__ double scratch[kThreads];
  const Place<V> p(C, lanes);
  float sb[V] = {}, sw[V] = {};
  if (p.active) {
    const Coef<V> k(p, stats, weight, bias, C);
    const long long step = (long long)gridDim.x * p.rows;
    for (long long r0 = (long long)blockIdx.x * p.rows + p.rl; r0 < R;
         r0 += step * U) {
      float xv[U][V], gv[U][V];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long r = r0 + u * step;
        ok[u] = r < R && (mask == nullptr || mask[r]);
        if (ok[u]) {
          load(x + r * C + p.cc, xv[u]);
          load(g + r * C + p.cc, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        float xh[V];
        k.template gate<T>(xv[u], gv[u], xh, relu);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sb[j] += gv[u][j];
          sw[j] = __fadd_rn(sw[j], __fmul_rn(gv[u][j], xh[j]));
        }
      }
    }
  }
  float* row = part + (size_t)blockIdx.x * 2 * C;
  block_sums(p, sb, red, scratch);
  if (threadIdx.x < p.nc) row[p.c0 + threadIdx.x] = (float)scratch[threadIdx.x];
  __syncthreads();
  block_sums(p, sw, red, scratch);
  if (threadIdx.x < p.nc)
    row[C + p.c0 + threadIdx.x] = (float)scratch[threadIdx.x];
}

// dx from the sums kernel's partial rows `part` (nrow of them); block
// (0, y) writes db and dw when they are given
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dx_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                  const T* __restrict__ g, const float* __restrict__ stats,
                  const float* __restrict__ weight,
                  const float* __restrict__ bias,
                  const float* __restrict__ part, float* __restrict__ dweight,
                  float* __restrict__ dbias, T* __restrict__ dx, int nrow,
                  int R, int C, int lanes, int train, int relu) {
  __shared__ double scratch[kThreads];
  __shared__ float a_s[kMaxLanes * V], b_s[kMaxLanes * V];
  const Place<V> p(C, lanes);
  const int ld = 2 * C;
  column_sums(
      [&](int r, int k) {
        return part[(size_t)r * ld +
                    (k < p.nc ? p.c0 + k : C + p.c0 + k - p.nc)];
      },
      nrow, 2 * p.nc, scratch, scratch);
  if (threadIdx.x < p.nc) {
    const int c = p.c0 + threadIdx.x;
    const double db = scratch[threadIdx.x], dw = scratch[p.nc + threadIdx.x];
    const double n = stats[2 * C];
    if (blockIdx.x == 0 && dbias != nullptr) {
      dbias[c] = (float)db;
      dweight[c] = (float)dw;
    }
    a_s[threadIdx.x] = train ? (float)(db / n) : 0.f;
    b_s[threadIdx.x] = train ? (float)(dw / n) : 0.f;
  }
  __syncthreads();
  if (!p.active) return;
  const Coef<V> k(p, stats, weight, bias, C);
  float a[V], bc[V], wr[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = a_s[p.lane * V + j];
    bc[j] = b_s[p.lane * V + j];
    wr[j] = __fmul_rn(k.w[j], k.rs[j]);
  }
  const long long step = (long long)gridDim.x * p.rows;
  for (long long r0 = (long long)blockIdx.x * p.rows + p.rl; r0 < R;
       r0 += step * U) {
    float xv[U][V], gv[U][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * step;
      ok[u] = r < R && (mask == nullptr || mask[r]);
      if (ok[u]) {
        load(x + r * C + p.cc, xv[u]);
        load(g + r * C + p.cc, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * step;
      if (r >= R) continue;
      float o[V];
      if (ok[u]) {
        float xh[V];
        k.template gate<T>(xv[u], gv[u], xh, relu);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = __fmul_rn(
              wr[j], __fsub_rn(gv[u][j],
                               __fadd_rn(a[j], __fmul_rn(xh[j], bc[j]))));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = 0.f;
      }
      store(dx + r * C + p.cc, o);
    }
  }
}

// ---- launch --------------------------------------------------------------

// the grid of a launch, or an invalid one (x = 0) for arguments the kernels
// do not take
dim3 grid_of(int R, int C, int vec, int lanes, int gx,
             std::initializer_list<const void*> rows) {
  const int V = vec ? kVec : 1;
  if (R < 0 || C < 1 || gx < 1 || lanes < 1 || lanes > kMaxLanes ||
      (vec && C % kVec != 0))
    return dim3(0);
  for (const void* q : rows)
    if (vec && ((uintptr_t)q & 15)) return dim3(0);
  const int nch = C / V;
  const int tiles = (nch + lanes - 1) / lanes;
  if (tiles > 65535) return dim3(0);
  return dim3(gx, tiles);
}

// KERNEL<T, V, U> on the vector path (U strips in flight) or the scalar one
#define POINT_BN_LAUNCH(KERNEL, T, U, ...)                          \
  do {                                                              \
    if (vec)                                                        \
      KERNEL<T, kVec, U><<<grid, kThreads, 0, st>>>(__VA_ARGS__);   \
    else                                                            \
      KERNEL<T, 1, 4><<<grid, kThreads, 0, st>>>(__VA_ARGS__);      \
  } while (0)

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

}  // namespace

// x (R, C) bf16 (bf = 1) or f32; mask (R) bytes or null; part (gx, C + 1)
extern "C" int point_bn_sum_launch(const void* x, const void* mask,
                                   void* part, int R, int C, int bf, int vec,
                                   int lanes, int gx, void* stream) {
  const dim3 grid = grid_of(R, C, vec, lanes, gx, {x});
  if (grid.x == 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = in<uint8_t>(mask);
  float* pt = static_cast<float*>(part);
  if (bf)
    POINT_BN_LAUNCH(sum_kernel, bf16, 4, in<bf16>(x), m, pt, R, C, lanes);
  else
    POINT_BN_LAUNCH(sum_kernel, float, 4, in<float>(x), m, pt, R, C, lanes);
  return cudaGetLastError();
}

// sums (nrow, C + 1) pass 1's rows; part (gx, C); stats (2 C + 1)
extern "C" int point_bn_sqdev_launch(const void* x, const void* mask,
                                     const void* sums, void* part,
                                     void* stats, int nrow, int R, int C,
                                     int bf, int vec, int lanes, int gx,
                                     void* stream) {
  const dim3 grid = grid_of(R, C, vec, lanes, gx, {x});
  if (grid.x == 0 || nrow < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = in<uint8_t>(mask);
  const float* s = in<float>(sums);
  float* pt = static_cast<float*>(part);
  float* sv = static_cast<float*>(stats);
  if (bf)
    POINT_BN_LAUNCH(sqdev_kernel, bf16, 4, in<bf16>(x), m, s, pt, sv, nrow, R, C,
                      lanes);
  else
    POINT_BN_LAUNCH(sqdev_kernel, float, 4, in<float>(x), m, s, pt, sv, nrow, R,
                      C, lanes);
  return cudaGetLastError();
}

// sq (nrow, C) pass 2's rows (unread in eval mode); y (R, C) in x's type;
// keep = 1 - momentum as the composite rounds it
extern "C" int point_bn_norm_launch(
    const void* x, const void* mask, const void* sq, void* stats,
    const void* weight, const void* bias, void* running_mean,
    void* running_var, void* num_batches, void* y, int nrow, int R, int C,
    int bf, int vec, int lanes, int gx, int train, int relu, float eps,
    float momentum, float keep, void* stream) {
  const dim3 grid = grid_of(R, C, vec, lanes, gx, {x, y});
  if (grid.x == 0 || (train && nrow < 1)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = in<uint8_t>(mask);
  const float* s = in<float>(sq);
  float* sv = static_cast<float*>(stats);
  const float* w = in<float>(weight);
  const float* b = in<float>(bias);
  float* rm = static_cast<float*>(running_mean);
  float* rv = static_cast<float*>(running_var);
  long long* nb = static_cast<long long*>(num_batches);
  if (bf)
    POINT_BN_LAUNCH(norm_kernel, bf16, 4, in<bf16>(x), m, s, sv, w, b, rm, rv, nb,
                      static_cast<bf16*>(y), nrow, R, C, lanes, train, relu,
                      eps, momentum, keep);
  else
    POINT_BN_LAUNCH(norm_kernel, float, 4, in<float>(x), m, s, sv, w, b, rm, rv,
                      nb, static_cast<float*>(y), nrow, R, C, lanes, train,
                      relu, eps, momentum, keep);
  return cudaGetLastError();
}

// g (R, C) in x's type; part (gx, 2 C)
extern "C" int point_bn_bwd_sums_launch(const void* x, const void* mask,
                                        const void* g, const void* stats,
                                        const void* weight, const void* bias,
                                        void* part, int R, int C, int bf,
                                        int vec, int lanes, int gx, int relu,
                                        void* stream) {
  const dim3 grid = grid_of(R, C, vec, lanes, gx, {x, g});
  if (grid.x == 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = in<uint8_t>(mask);
  const float* sv = in<float>(stats);
  const float* w = in<float>(weight);
  const float* b = in<float>(bias);
  float* pt = static_cast<float*>(part);
  if (bf)
    POINT_BN_LAUNCH(bwd_sums_kernel, bf16, 2, in<bf16>(x), m, in<bf16>(g), sv, w,
                      b, pt, R, C, lanes, relu);
  else
    POINT_BN_LAUNCH(bwd_sums_kernel, float, 2, in<float>(x), m, in<float>(g), sv,
                      w, b, pt, R, C, lanes, relu);
  return cudaGetLastError();
}

// part (nrow, 2 C) the sums' rows; dweight, dbias (C) f32 or both null;
// dx (R, C) in x's type
extern "C" int point_bn_bwd_dx_launch(
    const void* x, const void* mask, const void* g, const void* stats,
    const void* weight, const void* bias, const void* part, void* dweight,
    void* dbias, void* dx, int nrow, int R, int C, int bf, int vec,
    int lanes, int gx, int train, int relu, void* stream) {
  const dim3 grid = grid_of(R, C, vec, lanes, gx, {x, g, dx});
  if (grid.x == 0 || nrow < 1 || (dweight == nullptr) != (dbias == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = in<uint8_t>(mask);
  const float* sv = in<float>(stats);
  const float* w = in<float>(weight);
  const float* b = in<float>(bias);
  const float* pt = in<float>(part);
  float* dw = static_cast<float*>(dweight);
  float* db = static_cast<float*>(dbias);
  if (bf)
    POINT_BN_LAUNCH(bwd_dx_kernel, bf16, 2, in<bf16>(x), m, in<bf16>(g), sv, w, b,
                      pt, dw, db, static_cast<bf16*>(dx), nrow, R, C, lanes,
                      train, relu);
  else
    POINT_BN_LAUNCH(bwd_dx_kernel, float, 2, in<float>(x), m, in<float>(g), sv, w,
                      b, pt, dw, db, static_cast<float*>(dx), nrow, R, C,
                      lanes, train, relu);
  return cudaGetLastError();
}
