// K6: backward of the train-mode grouped vector attention (PT-v2m2).
//
// Replaces both TPU backward kernels of ao_tpu:
//   ops/pallas/gva_slab.py  _bwd_vjp -> _bwd_kernel (pallas_call in _run at
//       :432) -- Morton-sorted rows, window graph, the BN-statistics'
//       gradient applied on the host from moments this kernel emits;
//   ops/pallas/gva_fused.py _bwd_vjp -> _bwd_kernel + _bwd_stats_kernel
//       (pallas_call in _run at :419) -- pre-gathered rows, with a second
//       pass for that gradient. Here both call modes take the moments.
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
//   part (gridDim.x, P): per-block sums, in the order of ops/gva.py:
//     bwd_par_layout: r^T dt, sum dt, relu(t)^T dw, sum dw, pe1^T dpeb,
//     sum dpeb, pos^T dpe0, sum dpe0, and the (1+G, 6C) moment
//     bf16([v | t])^T bf16([r | pe1 | g | x*g | y*g | z*g]), g = [pe0 > 0] v.
// The wrapper adds the partial rows; the host (ops/gva.py:_bwd_host)
// turns sums and moments into parameter gradients and the BN-statistics'
// corrections to dk and dq.
//
// What bounds it on the card: arithmetic. Per edge the recompute and the
// backward take about 3.5 * 2 * C^2 operations (pe-MLP forward, its
// transpose, and the pe1^T dpeb sum) against ~4C bytes of rows, far above
// the card's balance point. The design (simple first, CUDA cores in f32
// over bf16-rounded operands, not yet tensor cores): a block of 256 threads
// holds a tile of TQ queries (TQ*C ~ 384) in shared memory: pe0, the
// relation and dpeb as f32 rows (pe0's buffer then takes dpe0), plus the
// per-group t, softmax, dw and dt. The (B, Nsrc, *) scatters are f32
// atomicAdds, whose order changes from run to run. The parameter sums
// span every edge of the batch; a persistent grid of at most two blocks
// per SM walks the tiles, and each block adds every tile's sums into its
// own row of partial sums in device memory (read-modify-write, no atomics:
// the C x C sum pe1^T dpeb does not fit a block's shared memory at
// C = 384). Wp2, W1f and the small weights stay in L2-resident device
// memory; Wp2 and W1f also come transposed (Wp2T, W1fT), so that the
// products with their transposes read them along rows. pe1 and dpeb are
// also kept as their bf16 roundings, the operands of the C x C products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void load4(const bf16* p, float& a, float& b,
                                      float& c, float& d) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  a = lo.x;
  b = lo.y;
  c = hi.x;
  d = hi.y;
}

constexpr int kThreads = 256;
constexpr int kTileWork = 384;  // TQ * C per block, as in gva_eval.cu

__host__ __device__ inline int tile_queries(int C) {
  return C >= kTileWork ? 1 : kTileWork / C;
}

// dst[e] += f(e) for e < n over the block's threads, eight elements a
// thread at a time with their loads issued together: the partial rows are
// too large for L2 at C >= 192, and one load in flight per thread leaves
// the add latency-bound.
template <typename F>
__device__ __forceinline__ void add_into(float* __restrict__ dst, int n, F f) {
  constexpr int U = 8;
  for (int base = 0; base < n; base += kThreads * U) {
    float old[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      old[u] = e < n ? dst[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * kThreads + threadIdx.x;
      if (e < n) dst[e] = old[u] + f(e);
    }
  }
}

// dst[u * ld + 0..3] += acc[u][0..3] for u < rows (16-byte aligned rows),
// the loads issued together
__device__ __forceinline__ void add4x4(float* __restrict__ dst, int ld,
                                       const float (&acc)[4][4], int rows = 4) {
  float4 o[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < rows) o[u] = *reinterpret_cast<const float4*>(dst + (size_t)u * ld);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < rows) {
      o[u].x += acc[u][0];
      o[u].y += acc[u][1];
      o[u].z += acc[u][2];
      o[u].w += acc[u][3];
      *reinterpret_cast<float4*>(dst + (size_t)u * ld) = o[u];
    }
  }
}

__host__ __device__ inline long long par_size(int C, int G) {
  return (long long)C * G + G + G * G + G + (long long)C * C + C + 3 * C + C +
         (long long)(1 + G) * 6 * C;
}

template <int S>
__global__ void __launch_bounds__(kThreads) gva_bwd_kernel(
    const bf16* __restrict__ src,       // (B, Nsrc, 2C+6)
    const bf16* __restrict__ qrow,      // (B, Nq, C+7)
    const int* __restrict__ idx,        // (B, Nq, S)
    const uint8_t* __restrict__ valid,  // (B, Nq, S)
    const bf16* __restrict__ A,         // (3, C)
    const float* __restrict__ cA,       // (C)
    const bf16* __restrict__ Wp2,       // (C, C) [in, out]
    const bf16* __restrict__ Wp2T,      // (C, C) [out, in]
    const float* __restrict__ bp2,      // (C)
    const bf16* __restrict__ W1f,       // (C, G)
    const bf16* __restrict__ W1fT,      // (G, C)
    const float* __restrict__ b1f,      // (G)
    const float* __restrict__ W2,       // (G, G)
    const float* __restrict__ b2,       // (G)
    const float* __restrict__ dout,     // (B, Nq, C)
    float* __restrict__ dkv,            // (B, Nsrc, 2C), zeroed
    float* __restrict__ dq,             // (B, Nq, C)
    float* __restrict__ mom,            // (B, Nsrc, 1+G), zeroed
    float* __restrict__ qmom,           // (B, Nq, 1+G)
    float* __restrict__ part,           // (gridDim.x, P), zeroed
    int B, int Nsrc, int Nq, int C, int G) {
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const int K = C / G;
  const int rw = 2 * C + 6;
  const int qw = C + 7;
  const int ntq = (Nq + TQ - 1) / TQ;
  const int ntiles = B * ntq;
  extern __shared__ __align__(16) float sm_f[];
  float* pe0 = sm_f;          // R*C: pe0, later dpe0
  float* rr = pe0 + R * C;    // R*C: relation (f32)
  float* dpeb = rr + R * C;   // R*C
  float* tt = dpeb + R * C;   // R*G: t (folded, masked)
  float* sm = tt + R * G;     // R*G: w, then softmax
  float* dw = sm + R * G;     // R*G: dsm, then dw
  float* dt = dw + R * G;     // R*G
  float* doq = dt + R * G;    // TQ*C: dout * mrow
  float* pos = doq + TQ * C;  // R*4 (f32, unrounded)
  float* vld = pos + R * 4;   // R
  int* rid = reinterpret_cast<int*>(vld + R);  // R
  // bf16 roundings of pe1 and dpeb: the operands of the two C x C products
  bf16* pe1b = reinterpret_cast<bf16*>(rid + R + ((TQ * C + R) & 1));  // R*C
  bf16* dpebb = pe1b + R * C;                                         // R*C
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // this block's row of partial sums, in bwd_par_layout order
  float* pb = part + (size_t)blockIdx.x * par_size(C, G);
  float* p_dW1f = pb;
  float* p_db1f = p_dW1f + C * G;
  float* p_dW2 = p_db1f + G;
  float* p_db2 = p_dW2 + G * G;
  float* p_dWp2 = p_db2 + G;
  float* p_dbp2 = p_dWp2 + (size_t)C * C;
  float* p_dA = p_dbp2 + C;  // (3, C), then dcA (C)
  float* p_mom = p_dA + 4 * C;  // (1+G, 6C)

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / ntq;
    const int q0 = (tile - b * ntq) * TQ;
    const bf16* srcb = src + (size_t)b * Nsrc * rw;

    // 0: slot rows, validity, relative positions, masked dout
    for (int e = tid; e < R; e += kThreads) {
      const int q = q0 + e / S;
      float v = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
      int id = 0;
      if (q < Nq) {
        const size_t o = ((size_t)b * Nq + q) * S + e % S;
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
    for (int e = tid; e < TQ * C; e += kThreads) {
      const int qi = e / C, c = e - qi * C;
      const int q = q0 + qi;
      float d = 0.f;
      if (q < Nq) {
        const size_t o = (size_t)b * Nq + q;
        d = dout[o * C + c] * bf(qrow[o * qw + C + 6]);
      }
      doq[e] = d;
    }
    __syncthreads();

    // 1: pe0 = (bf16(pos) @ bf16(A) + cA) * valid, f32
    for (int e = tid; e < R * C; e += kThreads) {
      const int r = e / C, j = e - r * C;
      const float a = rbf(pos[4 * r]) * bf(A[j]) +
                      rbf(pos[4 * r + 1]) * bf(A[C + j]) +
                      rbf(pos[4 * r + 2]) * bf(A[2 * C + j]);
      const float x = (a + cA[j]) * vld[r];
      pe0[e] = x;
      pe1b[e] = __float2bfloat16_rn(fmaxf(x, 0.f));
    }
    __syncthreads();

    // 2: per (query, channel c): peb of the S slots, the relation, and
    //    dsm = sum over the channel's group of (v + peb) * d (lane shuffles
    //    over the K consecutive threads of a group)
    for (int base = 0; base < TQ * C; base += kThreads) {
      const int e = base + tid;
      const bool on = e < TQ * C;
      const int qi = on ? e / C : 0, c = on ? e - qi * C : 0;
      const int q = q0 + qi;
      float a[S];
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] = 0.f;
      if (on) {
        const bf16* p = pe1b + (size_t)qi * S * C;
        for (int j = 0; j < C; j += 4) {
          const float w0 = bf(Wp2[(size_t)(j + 0) * C + c]);
          const float w1 = bf(Wp2[(size_t)(j + 1) * C + c]);
          const float w2 = bf(Wp2[(size_t)(j + 2) * C + c]);
          const float w3 = bf(Wp2[(size_t)(j + 3) * C + c]);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float x0, x1, x2, x3;
            load4(p + s * C + j, x0, x1, x2, x3);
            a[s] += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
          }
        }
      }
      const float qv = on && q < Nq ? bf(qrow[((size_t)b * Nq + q) * qw + c]) : 0.f;
      const float bias = on ? bp2[c] : 0.f;
      const float d = on ? doq[e] : 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        float x = 0.f;
        if (on) {
          const bf16* row = srcb + (size_t)rid[r] * rw;
          const float peb = a[s] + bias;
          rr[(size_t)r * C + c] = bf(row[c]) - qv + peb;
          x = (bf(row[C + c]) + peb) * d;
        }
        for (int o = K >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (on && (lane & (K - 1)) == 0) dw[r * G + c / K] = x;
      }
    }
    __syncthreads();

    // 3: t = (bf16(relation) @ bf16(W1f) + b1f) * valid
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, g = e - r * G;
      const float* x = rr + (size_t)r * C;
      float a = 0.f;
      for (int j = 0; j < C; ++j) a += rbf(x[j]) * bf(W1f[(size_t)j * G + g]);
      tt[e] = (a + b1f[g]) * vld[r];
    }
    __syncthreads();

    // 4: w = relu(t) @ W2 + b2
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, g = e - r * G;
      float a = 0.f;
      for (int h = 0; h < G; ++h) a += fmaxf(tt[r * G + h], 0.f) * W2[h * G + g];
      sm[e] = a + b2[g];
    }
    __syncthreads();

    // 5: softmax over the S slots of each (query, group), masked before
    //    exp as in gva_eval.cu; then dw = sm * (dsm - sum_s sm * dsm)
    for (int e = tid; e < TQ * G; e += kThreads) {
      const int qi = e / G, g = e - qi * G;
      float mx = -1e30f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        mx = fmaxf(mx, vld[r] > 0.f ? sm[r * G + g] : -1e30f);
      }
      float z[S];
      float Z = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        const float wm = vld[r] > 0.f ? sm[r * G + g] : -1e30f;
        z[s] = __expf(fmaxf(wm - mx, -80.f)) * vld[r];
        Z += z[s];
      }
      const float inv = 1.f / fmaxf(Z, 1e-30f);
      float sd = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        z[s] *= inv;
        sm[r * G + g] = z[s];
        sd += z[s] * dw[r * G + g];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        dw[r * G + g] = z[s] * (dw[r * G + g] - sd);
      }
    }
    __syncthreads();

    // 6: dt = [t > 0] (dw @ W2^T) * valid
    for (int e = tid; e < R * G; e += kThreads) {
      const int r = e / G, h = e - r * G;
      float a = 0.f;
      for (int g = 0; g < G; ++g) a += dw[r * G + g] * W2[h * G + g];
      dt[e] = tt[e] > 0.f ? a * vld[r] : 0.f;
    }
    __syncthreads();

    // 7: per (query, channel c): dr = bf16(dt) @ bf16(W1f)^T, dv2, dpeb;
    //    scatter [dr | dv2] to the rows read, dq = -sum_s dr
    for (int e = tid; e < TQ * C; e += kThreads) {
      const int qi = e / C, c = e - qi * C;
      const int q = q0 + qi;
      const int g0 = c / K;
      const float d = doq[e];
      float a[S];
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] = 0.f;
      for (int g = 0; g < G; ++g) {
        const float w = bf(W1fT[(size_t)g * C + c]);
#pragma unroll
        for (int s = 0; s < S; ++s) a[s] += rbf(dt[(qi * S + s) * G + g]) * w;
      }
      float dqa = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        const float dv2 = sm[r * G + g0] * d;
        const float x = a[s] + dv2;
        dpeb[(size_t)r * C + c] = x;
        dpebb[(size_t)r * C + c] = __float2bfloat16_rn(x);
        dqa += a[s];
        if (vld[r] > 0.f) {
          float* o = dkv + ((size_t)b * Nsrc + rid[r]) * (2 * C);
          atomicAdd(o + c, a[s]);
          atomicAdd(o + C + c, dv2);
        }
      }
      if (q < Nq) dq[((size_t)b * Nq + q) * C + c] = -dqa;
    }
    // 8: [v | t] moments per source row (scatter) and per query
    for (int e = tid; e < TQ * (1 + G); e += kThreads) {
      const int qi = e / (1 + G), a = e - qi * (1 + G);
      const int q = q0 + qi;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        const float x = a == 0 ? vld[r] : tt[r * G + a - 1];
        acc += x;
        if (vld[r] > 0.f)
          atomicAdd(mom + ((size_t)b * Nsrc + rid[r]) * (1 + G) + a, x);
      }
      if (q < Nq) qmom[((size_t)b * Nq + q) * (1 + G) + a] = acc;
    }
    __syncthreads();

    // 9: this tile's parameter sums, added into the block's partial row
    add_into(p_dW1f, C * G, [&](int e) {
      const int c = e / G, g = e - c * G;
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += rr[(size_t)r * C + c] * dt[r * G + g];
      return a;
    });
    add_into(p_db1f, G, [&](int g) {
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += dt[r * G + g];
      return a;
    });
    add_into(p_dW2, G * G, [&](int e) {
      const int h = e / G, g = e - h * G;
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += fmaxf(tt[r * G + h], 0.f) * dw[r * G + g];
      return a;
    });
    add_into(p_db2, G, [&](int g) {
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += dw[r * G + g];
      return a;
    });
    // pe1^T dpeb in 4 x 4 register tiles: two 16-byte shared loads for
    // sixteen products
    for (int t = tid; t < (C / 4) * (C / 4); t += kThreads) {
      const int j0 = 4 * (t / (C / 4)), c0 = 4 * (t % (C / 4));
      float acc[4][4] = {};
      for (int r = 0; r < R; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(pe0 + (size_t)r * C + j0);
        const float4 d = *reinterpret_cast<const float4*>(dpeb + (size_t)r * C + c0);
        const float av[4] = {fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                             fmaxf(a.w, 0.f)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u][0] += av[u] * d.x;
          acc[u][1] += av[u] * d.y;
          acc[u][2] += av[u] * d.z;
          acc[u][3] += av[u] * d.w;
        }
      }
      add4x4(p_dWp2 + (size_t)j0 * C + c0, C, acc);
    }
    add_into(p_dbp2, C, [&](int c) {
      float a = 0.f;
      for (int r = 0; r < R; ++r) a += dpeb[(size_t)r * C + c];
      return a;
    });
    // the (1+G, 6C) moment in 4 x 4 register tiles: rows a0..a0+3 of
    // bf16([v | t]), columns c0..c0+3 of one of the six feature blocks
    for (int t = tid; t < ((G + 4) / 4) * (6 * C / 4); t += kThreads) {
      const int a0 = 4 * (t / (6 * C / 4)), col = 4 * (t % (6 * C / 4));
      const int blk = col / C, c0 = col - blk * C;
      float acc[4][4] = {};
      for (int r = 0; r < R; ++r) {
        float tv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int a = a0 + u;
          tv[u] = a == 0 ? vld[r] : (a <= G ? rbf(tt[r * G + a - 1]) : 0.f);
        }
        float f[4];
        if (blk == 0) {
          const float4 x = *reinterpret_cast<const float4*>(rr + (size_t)r * C + c0);
          f[0] = rbf(x.x); f[1] = rbf(x.y); f[2] = rbf(x.z); f[3] = rbf(x.w);
        } else if (blk == 1) {
          load4(pe1b + (size_t)r * C + c0, f[0], f[1], f[2], f[3]);
        } else {
          const float4 x = *reinterpret_cast<const float4*>(pe0 + (size_t)r * C + c0);
          const float m = blk == 2 ? vld[r] : pos[4 * r + blk - 3] * vld[r];
          f[0] = x.x > 0.f ? rbf(m) : 0.f;
          f[1] = x.y > 0.f ? rbf(m) : 0.f;
          f[2] = x.z > 0.f ? rbf(m) : 0.f;
          f[3] = x.w > 0.f ? rbf(m) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] += tv[u] * f[w];
        }
      }
      const int rows = min(4, G + 1 - a0);
      add4x4(p_mom + (size_t)a0 * 6 * C + col, 6 * C, acc, rows);
    }
    __syncthreads();

    // 10: dpe0 = [pe0 > 0] (bf16(dpeb) @ bf16(Wp2)^T) * valid, in pe0's place
    for (int e = tid; e < TQ * C; e += kThreads) {
      const int qi = e / C, j = e - qi * C;
      float a[S];
#pragma unroll
      for (int s = 0; s < S; ++s) a[s] = 0.f;
      const bf16* p = dpebb + (size_t)qi * S * C;
      for (int c = 0; c < C; c += 4) {
        const float w0 = bf(Wp2T[(size_t)(c + 0) * C + j]);
        const float w1 = bf(Wp2T[(size_t)(c + 1) * C + j]);
        const float w2 = bf(Wp2T[(size_t)(c + 2) * C + j]);
        const float w3 = bf(Wp2T[(size_t)(c + 3) * C + j]);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float x0, x1, x2, x3;
          load4(p + s * C + c, x0, x1, x2, x3);
          a[s] += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = qi * S + s;
        float* x = pe0 + (size_t)r * C + j;
        *x = *x > 0.f ? a[s] * vld[r] : 0.f;
      }
    }
    __syncthreads();

    // 11: pos^T dpe0 and sum dpe0 (dA and dcA are adjacent in the row)
    add_into(p_dA, 4 * C, [&](int e) {
      const int i = e / C, c = e - i * C;
      float a = 0.f;
      for (int r = 0; r < R; ++r)
        a += (i < 3 ? pos[4 * r + i] : 1.f) * pe0[(size_t)r * C + c];
      return a;
    });
    __syncthreads();
  }
}

}  // namespace

extern "C" int gva_bwd_launch(const void* src, const void* qrow,
                              const void* idx, const void* valid,
                              const void* A, const void* cA, const void* Wp2,
                              const void* Wp2T, const void* bp2,
                              const void* W1f, const void* W1fT,
                              const void* b1f, const void* W2,
                              const void* b2, const void* dout, void* dkv,
                              void* dq, void* mom, void* qmom, void* part,
                              int B, int Nsrc, int Nq, int S, int C, int G,
                              int nblk, void* stream) {
  if (C % 4 != 0 || G < 1 || C % G != 0 || Nsrc < 1 || nblk < 1)
    return cudaErrorInvalidValue;
  // the group width K = C / G is reduced by lane shuffles: a power of two
  // up to a warp (8 at every stage of the S3DIS config)
  const int K = C / G;
  if (K > 32 || (K & (K - 1)) != 0) return cudaErrorInvalidValue;
  // G even keeps the partial row's C x C and moment blocks 16-byte aligned
  if (G % 2 != 0) return cudaErrorInvalidValue;
  // S = 16, the neighbours of every stage of the S3DIS config
  if (S != 16) return cudaErrorInvalidValue;
  const int TQ = tile_queries(C);
  const int R = TQ * S;
  const size_t smem = sizeof(float) * (3 * (size_t)R * C + 4 * (size_t)R * G +
                                       (size_t)TQ * C + 5 * R + 1) +
                      sizeof(int) * R + 2 * sizeof(bf16) * (size_t)R * C;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gva_bwd_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  gva_bwd_kernel<16><<<nblk, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)src, (const bf16*)qrow, (const int*)idx,
      (const uint8_t*)valid, (const bf16*)A, (const float*)cA,
      (const bf16*)Wp2, (const bf16*)Wp2T, (const float*)bp2,
      (const bf16*)W1f, (const bf16*)W1fT, (const float*)b1f, (const float*)W2,
      (const float*)b2, (const float*)dout, (float*)dkv, (float*)dq,
      (float*)mom, (float*)qmom, (float*)part, B, Nsrc, Nq, C, G);
  return cudaGetLastError();
}
