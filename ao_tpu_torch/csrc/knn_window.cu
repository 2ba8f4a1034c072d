// K1: windowed k-nearest-neighbour search over curve-sorted keys.
//
// Replaces ao_tpu/ops/pallas/knn_window.py (knn_window_pallas ->
// _knn_window_kernel, pallas_call at :108). For every tile of `tile_q`
// curve-sorted queries it scores the `window` sorted keys starting at
// window_starts[b, t] as  s = |k|^2 - 2 q.k  (|k|^2 carries the 1e30
// penalty of invalid keys) and emits the k smallest scores ascending, with
// the ORIGINAL id order[col] of each. Ties go to the lowest window column,
// as in the TPU kernel's k rounds of min / argmin. (Past a window's valid
// keys, where every score is 1e30, the port emits the invalid keys in
// column order, each once, as its plain version's stable sort does; the
// TPU kernel repeats its lowest column there. The graphs drop those slots.)
//
// What bounds it on the card: arithmetic. Each query does `window`
// 3-term dot products plus a compare (about 8 f32 operations per pair);
// the bytes (keys read once per tile, k outputs per query) are a few
// percent of that at window = 512..1152.
//
// What held the first design back (clock64() phase counters on the card):
// it kept a sorted list of the k best per query and inserted every column
// that beat the list's last entry, in column order. Curve-sorted keys put
// a query's neighbours near its own column, so scores fall as the scan
// nears it: 110-147 of 512-1152 columns inserted per query (k = 16), some
// lane of a warp inserted at 40% of the columns, and the warp paid each
// 16-step insertion for it. Four 4-byte shared loads a column came on top.
//
// The design: one block per (batch, tile) stages the window's keys in
// shared memory as float4 {x, y, z, |k|^2} (one broadcast 16-byte load a
// column, read by the Q = 1 or 2 queries of a thread) and the original ids.
// For k = 3 the list is short: one scan in column order inserts into it
// at every column that beats it. For k = 16, three steps per query:
//   1. Threshold. The running minimum of the scores in each of G = 2k
//      column classes (column mod G). The k-th smallest of the G class
//      minima, tau, bounds the k-th smallest score of the window from
//      above: k distinct columns score at most tau. It needs no knowledge
//      of where the query sits in its window, so self graphs and cross
//      probes share it. On curve-sorted windows about k + 2 columns score
//      at most tau.
//   2. Candidates. A second scan, with the same fused multiply-adds as
//      step 1 (so a score equal to tau lands on the same side in both),
//      sets one bit in a 32-column mask per column scoring <= tau, with no
//      branch; the set bits are appended, lowest first, to the query's
//      buffer of column numbers in shared memory. A full buffer (CAP = 2k:
//      exact ties, or a window of invalid keys all at 1e30) keeps its k
//      best in column order and tau tightens to just below the k-th, so
//      the result stays exact.
//   3. Selection. The buffered columns, rescored, are inserted in column
//      order into a sorted register list, every entry above a new score
//      moving down one place, so equal scores keep the lowest column
//      first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the grid's warps an SM at least, before a thread takes a second query
constexpr int kWarpsPerSM = 8;

template <int K>
struct Shape {
  // a list this short is cheap to insert into at every column that beats
  // it: one scan (k = 3); longer lists take the three steps (k = 16)
  static constexpr bool kOnePass = K <= 4;
  static constexpr int G = 2 * K;    // column classes
  static constexpr int CAP = 2 * K;  // buffered columns a query
  // columns scored between two branches of the one-pass scan
  static constexpr int kChunk = 4;
};

// the score of one key for a query given as -2q; step 1, step 2 and the
// selection call this one function, so they agree bit for bit
__device__ __forceinline__ float score(const float4 k, float mx, float my,
                                       float mz) {
  return __fmaf_rn(mz, k.z, __fmaf_rn(my, k.y, __fmaf_rn(mx, k.x, k.w)));
}

// sorts v ascending (bitonic network, every index a constant)
template <int N>
__device__ __forceinline__ void sort_net(float* v) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float a = v[i], b = v[l];
          const bool up = (i & k) == 0;
          v[i] = up ? fminf(a, b) : fmaxf(a, b);
          v[l] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
  }
}

// the K-th smallest of 2K values: with both halves sorted, the K smallest
// of the union are min(a_i, b_{K-1-i}), and the K-th is the largest of them
template <int K>
__device__ __forceinline__ float kth_smallest(float* m) {
  sort_net<K>(m);
  sort_net<K>(m + K);
  float tau = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) tau = fmaxf(tau, fminf(m[i], m[2 * K - 1 - i]));
  return tau;
}

// inserts (s, c), s < bd[K-1], into the ascending list (bd, bc): every
// entry above s moves down one place, so entries keep their order and an
// equal score already listed stays ahead of s
template <int K>
__device__ __forceinline__ void insert(float* bd, int* bc, float s, int c) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool down = s < bd[j - 1];
    const bool here = !down && s < bd[j];
    bd[j] = down ? bd[j - 1] : (here ? s : bd[j]);
    bc[j] = down ? bc[j - 1] : (here ? c : bc[j]);
  }
  if (s < bd[0]) {
    bd[0] = s;
    bc[0] = c;
  }
}

// A full buffer (cnt = CAP, every score <= tau): keeps only its k best
// columns in column order (scores below the k-th smallest, then those
// equal to it, lowest columns first), which are the k best of every column
// scanned so far, and tightens tau to just below the k-th score, so only a
// lower score can still enter
template <int K, int CAP>
__device__ __forceinline__ void compact(uint16_t* buf, int stride, int& cnt,
                                        float& tau, const float4* skey,
                                        float mx, float my, float mz) {
  float v[CAP], w[CAP];
  int col[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    col[i] = i < cnt ? buf[i * stride] : 0;
    v[i] = i < cnt ? score(skey[col[i]], mx, my, mz) : INFINITY;
    w[i] = v[i];
  }
  static_assert(CAP == 2 * K, "the selection network takes 2k values");
  const float kth = kth_smallest<K>(w);
  int quota = K;
#pragma unroll
  for (int i = 0; i < CAP; ++i) quota -= v[i] < kth;
  int n = 0;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    bool keep = v[i] < kth;
    if (v[i] == kth && quota > 0) {
      keep = true;
      --quota;
    }
    if (keep) buf[n++ * stride] = (uint16_t)col[i];
  }
  cnt = n;
  tau = fminf(tau, nextafterf(kth, -INFINITY));
}

// writes one query's list: scores and the original ids of its columns
template <int K>
__device__ __forceinline__ void write_out(const float* bd, const int* bc,
                                          const int* sord, size_t q,
                                          float* d2_out, int* idx_out) {
  if constexpr (K % 4 == 0) {
    float4* d4 = reinterpret_cast<float4*>(d2_out + q * K);
    int4* i4 = reinterpret_cast<int4*>(idx_out + q * K);
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      d4[i] = make_float4(bd[4 * i], bd[4 * i + 1], bd[4 * i + 2], bd[4 * i + 3]);
      i4[i] = make_int4(sord[bc[4 * i]], sord[bc[4 * i + 1]],
                        sord[bc[4 * i + 2]], sord[bc[4 * i + 3]]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      d2_out[q * K + i] = bd[i];
      idx_out[q * K + i] = sord[bc[i]];
    }
  }
}

template <int K, int Q>
__global__ void __launch_bounds__(256) knn_window_kernel(
    const float* __restrict__ keys,    // (B, Nk, 3) curve-sorted
    const float* __restrict__ k2,      // (B, Nk) |k|^2 + invalid penalty
    const int* __restrict__ order,     // (B, Nk) original id per sorted row
    const float* __restrict__ queries, // (B, Nq, 3) curve-sorted, Nq = T * tile_q
    const int* __restrict__ ws,        // (B, T) window starts
    float* __restrict__ d2_out,        // (B, Nq, K)
    int* __restrict__ idx_out,         // (B, Nq, K)
    int Nk, int Nq, int T, int tile_q, int window) {
  constexpr int G = Shape<K>::G, CAP = Shape<K>::CAP, kChunk = Shape<K>::kChunk;
  // [window] keys, [window] ids, [CAP][tile_q] candidate columns
  extern __shared__ float4 skey[];
  int* sord = reinterpret_cast<int*>(skey + window);
  uint16_t* sbuf = reinterpret_cast<uint16_t*>(sord + window);

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int nthr = blockDim.x;
  int start = ws[(size_t)b * T + t];
  start = min(max(start, 0), Nk - window);
  const float* kb = keys + ((size_t)b * Nk + start) * 3;
  const float* k2b = k2 + (size_t)b * Nk + start;
  const int* ob = order + (size_t)b * Nk + start;
  for (int c = threadIdx.x; c < window; c += nthr) {
    skey[c] = make_float4(kb[3 * c], kb[3 * c + 1], kb[3 * c + 2], k2b[c]);
    sord[c] = ob[c];
  }
  __syncthreads();
  const size_t q_tile = (size_t)b * Nq + (size_t)t * tile_q;

  // this thread's queries: rows q0 + threadIdx.x + j * nthr of the tile
  for (int q0 = 0; q0 < tile_q; q0 += nthr * Q) {
    float mx[Q], my[Q], mz[Q];  // -2q
    bool on[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int qi = q0 + threadIdx.x + j * nthr;
      on[j] = qi < tile_q;
      const float* qp = queries + 3 * (q_tile + (on[j] ? qi : 0));
      mx[j] = -2.f * qp[0];
      my[j] = -2.f * qp[1];
      mz[j] = -2.f * qp[2];
    }

    if constexpr (Shape<K>::kOnePass) {
      // small k: one scan in column order, each query's list in registers
      float bd[Q][K];
      int bc[Q][K];
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int i = 0; i < K; ++i) {
          bd[j][i] = INFINITY;
          bc[j][i] = 0;
        }
      int c0 = 0;
      for (; c0 + kChunk <= window; c0 += kChunk) {
        float s[kChunk][Q];
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float4 k = skey[c0 + u];
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            s[u][j] = score(k, mx[j], my[j], mz[j]);
            hit |= s[u][j] < bd[j][K - 1];
          }
        }
        if (hit) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
#pragma unroll
            for (int j = 0; j < Q; ++j)
              if (s[u][j] < bd[j][K - 1]) insert<K>(bd[j], bc[j], s[u][j], c0 + u);
        }
      }
      for (; c0 < window; ++c0) {
        const float4 k = skey[c0];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const float sc = score(k, mx[j], my[j], mz[j]);
          if (sc < bd[j][K - 1]) insert<K>(bd[j], bc[j], sc, c0);
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j)
        if (on[j])
          write_out<K>(bd[j], bc[j], sord, q_tile + q0 + threadIdx.x + j * nthr,
                       d2_out, idx_out);
    } else {
      // 1. threshold from the class minima
      float tau[Q];
      {
        float mn[Q][G];
#pragma unroll
        for (int j = 0; j < Q; ++j)
#pragma unroll
          for (int g = 0; g < G; ++g) mn[j][g] = INFINITY;
        int c0 = 0;
        for (; c0 + G <= window; c0 += G) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 k = skey[c0 + g];
#pragma unroll
            for (int j = 0; j < Q; ++j)
              mn[j][g] = fminf(mn[j][g], score(k, mx[j], my[j], mz[j]));
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (c0 + g < window) {
            const float4 k = skey[c0 + g];
#pragma unroll
            for (int j = 0; j < Q; ++j)
              mn[j][g] = fminf(mn[j][g], score(k, mx[j], my[j], mz[j]));
          }
        }
#pragma unroll
        for (int j = 0; j < Q; ++j)
          tau[j] = on[j] ? kth_smallest<K>(mn[j]) : -INFINITY;
      }

      // 2. candidates in column order: each block of 32 columns sets one
      // bit a column scoring <= tau in a mask per query, with no branch;
      // the set bits are then appended to the buffer, lowest first
      int cnt[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) cnt[j] = 0;
      uint16_t* buf = sbuf + q0 + threadIdx.x;  // query j: buf[j * nthr + i * tile_q]
      for (int c0 = 0; c0 < window; c0 += 32) {
        uint32_t m[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) m[j] = 0u;
        if (c0 + 32 <= window) {
#pragma unroll
          for (int u = 0; u < 32; ++u) {
            const float4 k = skey[c0 + u];
#pragma unroll
            for (int j = 0; j < Q; ++j)
              if (score(k, mx[j], my[j], mz[j]) <= tau[j]) m[j] |= 1u << u;
          }
        } else {
          for (int u = 0; c0 + u < window; ++u) {
            const float4 k = skey[c0 + u];
#pragma unroll
            for (int j = 0; j < Q; ++j)
              if (score(k, mx[j], my[j], mz[j]) <= tau[j]) m[j] |= 1u << u;
          }
        }
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          while (m[j]) {
            const int u = __ffs(m[j]) - 1;
            m[j] &= m[j] - 1;
            // a full buffer keeps its k best first (tau only tightens, so a
            // column admitted under the old tau stays a valid candidate)
            if (cnt[j] == CAP)
              compact<K, CAP>(buf + j * nthr, tile_q, cnt[j], tau[j], skey,
                              mx[j], my[j], mz[j]);
            buf[j * nthr + cnt[j]++ * tile_q] = (uint16_t)(c0 + u);
          }
        }
      }

      // 3. selection: the buffered columns, rescored, in column order
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (!on[j]) continue;
        float bd[K];
        int bc[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          bd[i] = INFINITY;
          bc[i] = 0;
        }
        const uint16_t* bj = buf + j * nthr;
        for (int i = 0; i < cnt[j]; ++i) {
          const int c = bj[i * tile_q];
          const float sc = score(skey[c], mx[j], my[j], mz[j]);
          if (sc < bd[K - 1]) insert<K>(bd, bc, sc, c);
        }
        write_out<K>(bd, bc, sord, q_tile + q0 + threadIdx.x + j * nthr, d2_out,
                     idx_out);
      }
    }
  }
}

template <int K, int Q>
cudaError_t launch(const float* keys, const float* k2, const int* order,
                   const float* queries, const int* ws, float* d2, int* idx,
                   int B, int Nk, int Nq, int T, int tile_q, int window,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)window * (sizeof(float4) + sizeof(int)) +
      (Shape<K>::kOnePass ? 0 : (size_t)Shape<K>::CAP * tile_q * sizeof(uint16_t));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_window_kernel<K, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  // one pass of Q queries a thread covers the tile, up to 256 threads
  const int threads = min(256, (tile_q + 32 * Q - 1) / (32 * Q) * 32);
  knn_window_kernel<K, Q><<<dim3(T, B), threads, smem, stream>>>(
      keys, k2, order, queries, ws, d2, idx, Nk, Nq, T, tile_q, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_window_launch(const void* keys, const void* k2,
                                 const void* order, const void* queries,
                                 const void* ws, void* d2, void* idx, int B,
                                 int Nk, int Nq, int T, int k, int tile_q,
                                 int window, void* stream) {
  // candidate columns are buffered as 16-bit numbers
  if (window < k || window > Nk || window > 65535 || Nq != T * tile_q)
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  // Queries a thread: each key a thread loads from shared memory feeds Q
  // queries, while the grid keeps at least kWarpsPerSM warps an SM busy
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long warps = (long long)B * T * ((tile_q + 31) / 32);
  auto fits = [&](int q) {
    return tile_q % (32 * q) == 0 && warps / q >= (long long)kWarpsPerSM * sms;
  };
  const float* kf = (const float*)keys;
  const float* k2f = (const float*)k2;
  const int* of = (const int*)order;
  const float* qf = (const float*)queries;
  const int* wf = (const int*)ws;
  float* d2f = (float*)d2;
  int* idxf = (int*)idx;
  cudaStream_t st = (cudaStream_t)stream;
#define AO_KNN_LAUNCH(KK, QQ)                                                  \
  return launch<KK, QQ>(kf, k2f, of, qf, wf, d2f, idxf, B, Nk, Nq, T, tile_q, \
                        window, st)
  // k = 16 builds the S3DIS config's self graphs, k = 3 the unpool
  // (interpolation) graph; a config with other counts adds an instance
  if (k == 16) {
    if (fits(2)) AO_KNN_LAUNCH(16, 2);
    AO_KNN_LAUNCH(16, 1);
  }
  if (k == 3) {
    if (fits(2)) AO_KNN_LAUNCH(3, 2);
    AO_KNN_LAUNCH(3, 1);
  }
#undef AO_KNN_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" const char* ao_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
