// Flash attention over [B, S, H, D], forward and backward, f32 and bf16 IO,
// f32 arithmetic, for Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/flash_attention.py:flash_attention: the
// forward (_flash_attention_fwd_impl -> _attn_kernel, K8f) and its
// custom_vjp backward (_flash_attention_bwd_impl -> _attn_bwd_kernel, K8b).
// For each (batch, head): P = softmax(Q K^T / sqrt(D)) over the S keys, out =
// P V, with every input upcast to f32 and the outputs cast to the input type;
// the backward recomputes P and forms delta = rowsum(P * dP), dS = P (dP -
// delta) / sqrt(D), dQ = dS K, dK = dS^T Q, dV = P^T dO, as the TPU kernel
// does. The TPU pads S to a multiple of 128 lanes and masks the pad keys
// inside its kernel; here nothing is padded: the key loops stop at S and a
// partial query tile is masked at S.
//
// What bounds it on the H100: at the denoiser's shapes (S 513, D 64) the
// forward is 4*S*S*D flops per (batch, head) and the backward 16*S*S*D
// (Q K^T and dO V^T twice in the dQ pass, whose first sweep sums delta, then
// again in the dK/dV pass, and dQ, dK, dV), against one read of q, k, v
// (and dO) and one write of each output: compute-bound, on the f32 FMA pipes
// (the TPU kernel's contract is f32 math). One (batch, head)'s K and V at S
// 513, D 64 in f32 are 263 KB, above the 227 KB of shared memory a block can
// hold, so K1's streaming design serves: each kernel keeps its own rows in
// registers and streams tiles of the other side through shared memory (as
// f32), with an online softmax in the forward, which keeps the base-e
// log-sum-exp [B, H, S] for the backward (the TPU recomputes the max and the
// sum instead):
//   * forward: one block per (batch, head, query tile); D / 32 threads per
//     query, each owning 32 of the head dims in interleaved float4 chunks
//     (the query's threads read contiguous shared memory together) and
//     combining partial dot products by shuffles; K/V tiles of 32 keys whose
//     scores are accumulated side by side (32 independent FMA chains);
//   * backward, dQ: the same layout over K/V tiles of 4 keys (s and dp for
//     each); a first sweep over the keys sums delta = rowsum(p * dp) with
//     p = exp(s - lse), a second accumulates dq += ds k;
//   * backward, dK/dV: one block per (batch, head, key tile), D / 32 threads
//     per key, streaming Q/dO tiles of 4 queries with their lse and delta:
//     dv += p dO, dk += ds q.
// The backward's tiles are small because each thread already holds 96
// floats of its own rows: with 16- or 8-key dQ tiles (and 8-query dK/dV
// tiles) ptxas spilled the dQ pass's registers to local memory, and the
// backward ran slower the more it spilled.
// D 64 and D 128 are instantiated; another head dim is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int CH = 8;   // float4 chunks per thread: 32 head dims
constexpr int KT = 32;  // keys per shared-memory tile (forward)
constexpr int KQ = 4;   // keys per shared-memory tile (dQ)
constexpr int QB = 4;   // queries per shared-memory tile (dK/dV)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float4 ld4(const float* row, int c4) {
  return reinterpret_cast<const float4*>(row)[c4];
}

__device__ __forceinline__ float4 ld4(const bf16* row, int c4) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[c4];
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* row, int c4, float4 v) {
  reinterpret_cast<float4*>(row)[c4] = v;
}

__device__ __forceinline__ void st4(bf16* row, int c4, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  reinterpret_cast<uint2*>(row)[c4] = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float4& y) {
  y.x = fmaf(s, x.x, y.x);
  y.y = fmaf(s, x.y, y.y);
  y.z = fmaf(s, x.z, y.z);
  y.w = fmaf(s, x.w, y.w);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// The sum of v over the TPQ threads of one query (or key): neighbouring lanes.
template <int TPQ>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < TPQ; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row r of head h of sequence b in a [B, S, H, D] tensor.
template <typename T, int D>
__device__ __forceinline__ const T* row_of(const T* x, int b, int r, int h, int seq, int heads) {
  return x + (((long)b * seq + r) * heads + h) * D;
}

// Stage rows [r0, r0 + n) of head h of a and b ([B, S, H, D]) into shared
// memory as f32 (zeros past n); rows of `ROWS`.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(const T* a, const T* b_, int b, int h, int seq,
                                          int heads, int r0, int n, float (*as)[D],
                                          float (*bs)[D]) {
  for (int idx = threadIdx.x; idx < ROWS * D / 4; idx += THREADS) {
    const int j = idx / (D / 4), c4 = idx % (D / 4);
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (j < n) {
      av = ld4(row_of<T, D>(a, b, r0 + j, h, seq, heads), c4);
      if (bs != nullptr) bv = ld4(row_of<T, D>(b_, b, r0 + j, h, seq, heads), c4);
    }
    reinterpret_cast<float4*>(&as[j][0])[c4] = av;
    if (bs != nullptr) reinterpret_cast<float4*>(&bs[j][0])[c4] = bv;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ out, float* __restrict__ lse, int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, QT = THREADS / TPQ;
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];
  const int part = threadIdx.x % TPQ;
  const int qi = blockIdx.x * QT + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_ok = qi < seq;
  const T* qrow = row_of<T, D>(q, b, q_ok ? qi : 0, h, seq, heads);
  float4 qr[CH], o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    qr[c] = ld4(qrow, c * TPQ + part);
    o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  for (int k0 = 0; k0 < seq; k0 += KT) {
    const int nk = min(KT, seq - k0);
    __syncthreads();
    load_tile<T, D, KT>(k, v, b, h, seq, heads, k0, nk, ks, vs);
    __syncthreads();
    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) s[j] = dot4(qr[c], k4[j * (D / 4) + c * TPQ + part], s[j]);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float sj = lane_sum<TPQ>(s[j]) * scale;
      s[j] = j < nk ? sj : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c] = scale4(o[c], alpha);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - m_new);  // keys past S: exp(-inf) = 0
      l += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) axpy4(p, v4[j * (D / 4) + c * TPQ + part], o[c]);
    }
    m = m_new;
  }
  if (q_ok) {
    T* orow = out + (((long)b * seq + qi) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      st4(orow, c * TPQ + part, make_float4(o[c].x / l, o[c].y / l, o[c].z / l, o[c].w / l));
    if (part == 0) lse[((long)b * heads + h) * seq + qi] = m + logf(l);
  }
}

// p = exp(s - lse) and dp = dO . v for the KQ keys of a shared-memory tile
// (keys past nk: p = 0), from the query's own rows qr and g. A function
// forced inline, not a lambda: a lambda the compiler keeps out of line
// passes the arrays through local memory.
template <int D>
__device__ __forceinline__ void tile_p_dp(const float4 (&qr)[CH], const float4 (&g)[CH],
                                          const float4* k4, const float4* v4, int part, int nk,
                                          float scale, float lse_i, float (&p)[KQ],
                                          float (&dp)[KQ]) {
  constexpr int TPQ = D / 32;
#pragma unroll
  for (int j = 0; j < KQ; ++j) p[j] = dp[j] = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      p[j] = dot4(qr[c], k4[j * (D / 4) + c * TPQ + part], p[j]);
      dp[j] = dot4(g[c], v4[j * (D / 4) + c * TPQ + part], dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < KQ; ++j) {
    const float sj = lane_sum<TPQ>(p[j]) * scale;
    dp[j] = lane_sum<TPQ>(dp[j]);
    p[j] = j < nk ? expf(sj - lse_i) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
          T* __restrict__ dq_out, int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, QT = THREADS / TPQ;
  __shared__ __align__(16) float ks[KQ][D];
  __shared__ __align__(16) float vs[KQ][D];
  const int part = threadIdx.x % TPQ;
  const int qi = blockIdx.x * QT + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_ok = qi < seq;
  const T* qrow = row_of<T, D>(q, b, q_ok ? qi : 0, h, seq, heads);
  const T* grow = row_of<T, D>(dout, b, q_ok ? qi : 0, h, seq, heads);
  float4 qr[CH], g[CH], dq[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    qr[c] = ld4(qrow, c * TPQ + part);
    g[c] = ld4(grow, c * TPQ + part);
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long stat = ((long)b * heads + h) * seq + qi;
  const float lse_i = q_ok ? lse[stat] : INFINITY;  // rows past S: p = 0
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  float dl = 0.f;  // delta = rowsum(p * dp)
  for (int k0 = 0; k0 < seq; k0 += KQ) {
    const int nk = min(KQ, seq - k0);
    __syncthreads();
    load_tile<T, D, KQ>(k, v, b, h, seq, heads, k0, nk, ks, vs);
    __syncthreads();
    float p[KQ], dp[KQ];
    tile_p_dp<D>(qr, g, k4, v4, part, nk, scale, lse_i, p, dp);
#pragma unroll
    for (int j = 0; j < KQ; ++j) dl = fmaf(p[j], dp[j], dl);
  }
  if (q_ok && part == 0) delta[stat] = dl;

  for (int k0 = 0; k0 < seq; k0 += KQ) {
    const int nk = min(KQ, seq - k0);
    __syncthreads();
    load_tile<T, D, KQ>(k, v, b, h, seq, heads, k0, nk, ks, vs);
    __syncthreads();
    float p[KQ], dp[KQ];
    tile_p_dp<D>(qr, g, k4, v4, part, nk, scale, lse_i, p, dp);
#pragma unroll
    for (int j = 0; j < KQ; ++j) p[j] = p[j] * (dp[j] - dl) * scale;  // ds
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) axpy4(p[j], k4[j * (D / 4) + c * TPQ + part], dq[c]);
    }
  }
  if (q_ok) {
    T* drow = dq_out + (((long)b * seq + qi) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) st4(drow, c * TPQ + part, dq[c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk_out, T* __restrict__ dv_out,
            int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, KBLK = THREADS / TPQ;
  __shared__ __align__(16) float qs[QB][D];
  __shared__ __align__(16) float gs[QB][D];
  __shared__ float lses[QB], dls[QB];
  const int part = threadIdx.x % TPQ;
  const int kj = blockIdx.x * KBLK + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool k_ok = kj < seq;
  const T* krow = row_of<T, D>(k, b, k_ok ? kj : 0, h, seq, heads);
  const T* vrow = row_of<T, D>(v, b, k_ok ? kj : 0, h, seq, heads);
  float4 kr[CH], vr[CH], dk[CH], dv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    kr[c] = ld4(krow, c * TPQ + part);
    vr[c] = ld4(vrow, c * TPQ + part);
    dk[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const long stat0 = ((long)b * heads + h) * seq;
  const float4* q4 = reinterpret_cast<const float4*>(&qs[0][0]);
  const float4* g4 = reinterpret_cast<const float4*>(&gs[0][0]);

  for (int q0 = 0; q0 < seq; q0 += QB) {
    const int nq = min(QB, seq - q0);
    __syncthreads();
    load_tile<T, D, QB>(q, dout, b, h, seq, heads, q0, nq, qs, gs);
    if (threadIdx.x < QB) {
      const int i = threadIdx.x;
      lses[i] = i < nq ? lse[stat0 + q0 + i] : INFINITY;  // absent queries: p = 0
      dls[i] = i < nq ? delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();
    float p[QB], dp[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) p[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        p[i] = dot4(kr[c], q4[i * (D / 4) + c * TPQ + part], p[i]);
        dp[i] = dot4(vr[c], g4[i * (D / 4) + c * TPQ + part], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      const float pi = expf(lane_sum<TPQ>(p[i]) * scale - lses[i]);
      dp[i] = pi * (lane_sum<TPQ>(dp[i]) - dls[i]) * scale;  // ds
      p[i] = pi;
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        axpy4(p[i], g4[i * (D / 4) + c * TPQ + part], dv[c]);
        axpy4(dp[i], q4[i * (D / 4) + c * TPQ + part], dk[c]);
      }
    }
  }
  if (k_ok) {
    const long r = (((long)b * seq + kj) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      st4(dk_out + r, c * TPQ + part, dk[c]);
      st4(dv_out + r, c * TPQ + part, dv[c]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
               int seq, int heads, void* stream) {
  constexpr int QT = THREADS / (D / 32);
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fa_fwd<T, D><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), seq, heads, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               void* delta, void* dq, void* dk, void* dv, int batch, int seq, int heads,
               void* stream) {
  constexpr int QT = THREADS / (D / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / sqrtf((float)D);
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fa_bwd_dq<T, D><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), seq, heads, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dkdv<T, D><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq, heads,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out [batch, seq, heads, d] of one type (bf16 != 0: bfloat16, else
// float32), lse [batch, heads, seq] f32; all contiguous, 16-byte aligned.
// d is 64 or 128 (cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int seq, int heads, int d, int bf16_io,
                                   void* stream) {
  if (d == 64)
    return bf16_io ? launch_fwd<bf16, 64>(q, k, v, out, lse, batch, seq, heads, stream)
                   : launch_fwd<float, 64>(q, k, v, out, lse, batch, seq, heads, stream);
  if (d == 128)
    return bf16_io ? launch_fwd<bf16, 128>(q, k, v, out, lse, batch, seq, heads, stream)
                   : launch_fwd<float, 128>(q, k, v, out, lse, batch, seq, heads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward from q, k, v, the output's cotangent dout and the forward's
// lse; delta [batch, heads, seq] f32 scratch; dq, dk, dv in the IO type.
// Two launches on one stream: dQ (which writes delta), then dK/dV.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int batch, int seq, int heads, int d, int bf16_io,
                                   void* stream) {
  if (d == 64)
    return bf16_io ? launch_bwd<bf16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                                          heads, stream)
                   : launch_bwd<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                                           heads, stream);
  if (d == 128)
    return bf16_io ? launch_bwd<bf16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                                           heads, stream)
                   : launch_bwd<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq,
                                            heads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
