// Fused-qkv attention, forward and backward, f32 and bf16, for Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/fused_qkv_attention.py:fused_qkv_attention_2d:
// the forward (_fwd_impl -> _fwd_kernel, K1f) and its custom_vjp backward
// (_bwd_impl -> _bwd_kernel, K1b). softmax(Q K^T / sqrt(D)) V per head, read
// in place from the fused qkv projection [B*S, 3W] in the grouped [Q|K|V]
// column order (G head groups; head h of group g = h / (H/G) has its Q
// columns at g*3*Wg + (h mod H/G)*D, K at +Wg, V at +2*Wg, Wg = W/G).
// Keys at positions >= valid_len are masked; the output is [B*S, W]
// head-major. Query rows in [valid_len, S) are computed like any other row
// (finite: they attend to the valid keys) and discarded by the caller.
// Scores are kept in base 2 (log2(e) folded into the query scale), as in the
// TPU kernel, and the forward writes the base-2 log-sum-exp [B, H, S] when
// the backward needs it.
//
// Two flavours, one template on the IO type T: exact f32 (T = float), and
// bf16 (T = __nv_bfloat16) with the TPU kernel's rounding points. Loads are
// bf16, arithmetic f32 (bf16 values are held as f32, products of two are
// exact), and values are rounded to bf16 where npcd_tpu's kernel casts:
//   * forward: c2 = bf16(scale * log2 e) (passed in), q_s = bf16(q * c2);
//     s = q_s . k in f32; m = the row max over all valid keys; e =
//     bf16(exp2(s - m)); l = the f32 sum of the bf16 e (the TPU's sum-dot
//     at D 64); out = bf16((sum_j e_j v_j) / l); lse = m + log2(l) in f32.
//     The TPU takes m before any exponent, so the bf16 forward makes two
//     passes over the keys (the max, then e, l and o) instead of the f32
//     flavour's online softmax, whose running max would round e elsewhere;
//   * backward: p = exp2(s - lse) in f32 from the same q_s; dV sums
//     bf16(p) dO; delta = rowsum(p * dp) over the keys, as the TPU computes
//     it (the f32 flavour's rowsum(dO * O) would read the bf16-rounded
//     output); ds = bf16(p (dp - delta)); dQ = bf16(scale * sum ds k), dK =
//     bf16(scale * sum ds q) with the unscaled q, dV rounded to bf16.
//
// What bounds it on the H100: at the denoiser's shapes (S 520, D 64) the
// forward is 4*S*S*D flops per (sequence, head) (6*S*S*D in bf16, whose
// first pass recomputes Q K^T) and the backward 14*S*S*D (18 in bf16, whose
// dQ pass sweeps the keys twice), against a few reads of the [B*S, 3W] qkv:
// both are compute-bound, on the f32 FMA pipes (no tensor cores: bf16 values
// are multiplied in f32). One (sequence, head)'s K and V in f32 are 2*520*64*4
// = 266 KB, above the 227 KB of shared memory a block can hold, so every
// kernel streams tiles of the other side through shared memory (as f32) and
// keeps its own rows in registers:
//   * forward: one block per (sequence, head, 64-query tile), two threads per
//     query that split the 64 head dims in interleaved float4 chunks (the
//     pair reads 32 contiguous bytes of shared memory per load) and combine
//     partial dot products with one shuffle per key; K/V tiles of 32 keys,
//     online softmax (running max and sum) in f32; the 32 keys' scores are
//     accumulated side by side, so the FMAs form 32 independent chains.
//   * backward, dQ: the same layout over query tiles. In f32 each pair
//     computes delta = rowsum(dO * O) from the saved output (the same number
//     as the TPU kernel's rowsum(P * dP), cheaper); in bf16 a first sweep
//     over the keys sums p * dp. It writes delta for the dK/dV pass, then
//     streams K/V tiles: p = exp2(s - lse), dp = dO . v, ds = p (dp - delta),
//     dq += ds k.
//   * backward, dK/dV: one block per (sequence, head, 64-key tile), two
//     threads per key, streaming Q/dO tiles of 16 queries (all S queries, pad
//     queries included): dv += p dO, dk += ds q.
// dq, dk and dv are written straight into the grouped [Q_g|K_g|V_g] columns
// of one dqkv [B*S, 3W], every element of it: pad-key rows (>= valid_len) of
// dk and dv are written as exact zeros, and pad-query rows of dq are
// computed (0 when their dO rows are 0, as in the denoiser, whose pad rows
// are sliced off). The next weight gradient dW_qkv = X^T dqkv reads every row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int D = 64;            // head dim
constexpr int QT = 64;           // queries per block (forward, dQ)
constexpr int KT = 32;           // keys per shared-memory tile (forward, dQ)
constexpr int KB = 64;           // keys per block (dK/dV)
constexpr int QB = 16;           // queries per shared-memory tile (dK/dV)
constexpr int CH = D / 8;        // float4 chunks per thread: half h owns chunks 2c + h
constexpr int THREADS = 128;     // two threads per query (or key)

typedef __nv_bfloat16 bf16;

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w));
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Elements [4 c4, 4 c4 + 4) of a row as f32 (16-byte loads in f32, 8-byte in
// bf16, whose f32 value is its bits shifted up).
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

template <typename T>
struct Layout {
  const T* base;      // qkv rows of this sequence
  long row_stride;    // 3W
  int col;            // this head's Q column; K at +wg, V at +2wg
  int wg;
  int w;
};

template <typename T>
__device__ __forceinline__ Layout<T> layout(const T* qkv, int b, int h, int seq, int heads,
                                            int groups) {
  Layout<T> l;
  l.w = heads * D;
  l.wg = l.w / groups;
  const int hg = heads / groups;
  l.col = (h / hg) * 3 * l.wg + (h % hg) * D;
  l.row_stride = 3L * l.w;
  l.base = qkv + (long)b * seq * l.row_stride;
  return l;
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

// Stage keys [k0, k0 + nk) of K (and V unless vs is null) into shared memory
// as f32 (zeros past nk).
template <typename T>
__device__ __forceinline__ void load_kv_tile(const Layout<T>& l, int k0, int nk,
                                             float (*ks)[D], float (*vs)[D]) {
  for (int idx = threadIdx.x; idx < KT * D / 4; idx += THREADS) {
    const int j = idx / (D / 4), c4 = idx % (D / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j < nk) {
      const T* r = l.base + (long)(k0 + j) * l.row_stride + l.col;
      kv = ld4(r + l.wg, c4);
      if (vs != nullptr) vv = ld4(r + 2 * l.wg, c4);
    }
    reinterpret_cast<float4*>(&ks[j][0])[c4] = kv;
    if (vs != nullptr) reinterpret_cast<float4*>(&vs[j][0])[c4] = vv;
  }
}

// The 32 keys' scores of this thread's query (the pair's halves combined),
// keys past nk at -inf.
__device__ __forceinline__ void tile_scores(const float4 (&q)[CH], const float4* k4, int half,
                                            int nk, float (&s)[KT]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = dot4(q[c], k4[j * (D / 4) + 2 * c + half], s[j]);
  }
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float sj = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1);
    s[j] = j < nk ? sj : -INFINITY;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fqa_fwd(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
        int seq, int heads, int groups, int valid_len, float scale_log2) {
  constexpr bool BF = is_bf16<T>();
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * QT + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout<T> l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const T* qrow = l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col;
  float4 q[CH], o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 t = scale4(ld4(qrow, 2 * c + half), scale_log2);
    q[c] = BF ? rnd4(t) : t;
    o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, lsum = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  if constexpr (BF) {  // first pass: the row max over all valid keys
    for (int k0 = 0; k0 < valid_len; k0 += KT) {
      const int nk = min(KT, valid_len - k0);
      __syncthreads();
      load_kv_tile(l, k0, nk, ks, nullptr);
      __syncthreads();
      float s[KT];
      tile_scores(q, k4, half, nk, s);
#pragma unroll
      for (int j = 0; j < KT; ++j) m = fmaxf(m, s[j]);
    }
  }

  for (int k0 = 0; k0 < valid_len; k0 += KT) {
    const int nk = min(KT, valid_len - k0);
    __syncthreads();  // the previous tile is fully consumed
    load_kv_tile(l, k0, nk, ks, vs);
    __syncthreads();

    float s[KT];
    tile_scores(q, k4, half, nk, s);
    if constexpr (BF) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float e = rnd(exp2f(s[j] - m));  // masked keys give exp2(-inf) = 0
        lsum += e;
#pragma unroll
        for (int c = 0; c < CH; ++c) axpy4(e, v4[j * (D / 4) + 2 * c + half], o[c]);
      }
    } else {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT; ++j) mt = fmaxf(mt, s[j]);
      const float m_new = fmaxf(m, mt);
      const float alpha = exp2f(m - m_new);  // 0 on the first tile
      lsum *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        o[c].x *= alpha; o[c].y *= alpha; o[c].z *= alpha; o[c].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float p = exp2f(s[j] - m_new);  // masked keys give exp2(-inf) = 0
        lsum += p;
#pragma unroll
        for (int c = 0; c < CH; ++c) axpy4(p, v4[j * (D / 4) + 2 * c + half], o[c]);
      }
      m = m_new;
    }
  }

  if (q_ok) {
    T* orow = out + ((long)b * seq + qi) * l.w + h * D;
    const float inv = 1.f / lsum;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if constexpr (BF)  // o / l, rounded once
        st4(orow, 2 * c + half, make_float4(o[c].x / lsum, o[c].y / lsum, o[c].z / lsum,
                                            o[c].w / lsum));
      else
        st4(orow, 2 * c + half, scale4(o[c], inv));
    }
    if (lse != nullptr && half == 0) lse[((long)b * heads + h) * seq + qi] = m + log2f(lsum);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fqa_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ out,
           const T* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ delta, T* __restrict__ dqkv, int seq, int heads,
           int groups, int valid_len, float scale_log2, float scale) {
  constexpr bool BF = is_bf16<T>();
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * QT + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout<T> l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const long row = (long)b * seq + (q_ok ? qi : 0);
  const T* qrow = l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col;
  const T* grow = dout + row * l.w + h * D;
  float4 q[CH], g[CH], dq[CH];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 t = scale4(ld4(qrow, 2 * c + half), scale_log2);
    q[c] = BF ? rnd4(t) : t;
    g[c] = ld4(grow, 2 * c + half);
    if constexpr (!BF) dl = dot4(g[c], ld4(out + row * l.w + h * D, 2 * c + half), dl);
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (!BF) dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  const long stat = ((long)b * heads + h) * seq + qi;
  const float lse_i = q_ok ? lse[stat] : INFINITY;  // rows past seq: p = 0
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  // s = q . k (the pair's halves combined) and dp = dO . v for a tile
  auto scores = [&](int nk, float (&s)[KT], float (&dp)[KT]) {
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        s[j] = dot4(q[c], k4[j * (D / 4) + 2 * c + half], s[j]);
        dp[j] = dot4(g[c], v4[j * (D / 4) + 2 * c + half], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float sj = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1);
      dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
      s[j] = j < nk ? exp2f(sj - lse_i) : 0.f;  // p
    }
  };

  if constexpr (BF) {  // first sweep: delta = rowsum(p * dp), the TPU kernel's formula
    for (int k0 = 0; k0 < valid_len; k0 += KT) {
      const int nk = min(KT, valid_len - k0);
      __syncthreads();
      load_kv_tile(l, k0, nk, ks, vs);
      __syncthreads();
      float p[KT], dp[KT];
      scores(nk, p, dp);
#pragma unroll
      for (int j = 0; j < KT; ++j) dl = fmaf(p[j], dp[j], dl);
    }
  }
  if (q_ok && half == 0) delta[stat] = dl;

  for (int k0 = 0; k0 < valid_len; k0 += KT) {
    const int nk = min(KT, valid_len - k0);
    __syncthreads();
    load_kv_tile(l, k0, nk, ks, vs);
    __syncthreads();

    float p[KT], dp[KT];
    scores(nk, p, dp);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float ds = p[j] * (dp[j] - dl);
      p[j] = BF ? rnd(ds) : ds;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) axpy4(p[j], k4[j * (D / 4) + 2 * c + half], dq[c]);
    }
  }

  if (q_ok) {
    T* drow = dqkv + row * l.row_stride + l.col;
#pragma unroll
    for (int c = 0; c < CH; ++c) st4(drow, 2 * c + half, scale4(dq[c], scale));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fqa_bwd_dkdv(const T* __restrict__ qkv, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dqkv, int seq, int heads, int groups, int valid_len,
             float scale_log2, float scale) {
  constexpr bool BF = is_bf16<T>();
  // f32: qs holds q and the scale multiplies the score; bf16: qs holds
  // bf16(q * c2) for the score and qr the unscaled q for dk
  __shared__ __align__(16) float qs[QB][D];
  __shared__ __align__(16) float qr[BF ? QB : 1][D];
  __shared__ __align__(16) float gs[QB][D];
  __shared__ float lses[QB], dls[QB];

  const int half = threadIdx.x & 1;
  const int kj = blockIdx.x * KB + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout<T> l = layout(qkv, b, h, seq, heads, groups);
  const long stat0 = ((long)b * heads + h) * seq;

  const bool k_ok = kj < valid_len;  // a real key; pad keys get dk = dv = 0
  const T* krow = l.base + (long)(k_ok ? kj : 0) * l.row_stride + l.col;
  float4 k[CH], v[CH], dk[CH], dv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    k[c] = ld4(krow + l.wg, 2 * c + half);
    v[c] = ld4(krow + 2 * l.wg, 2 * c + half);
    dk[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* q4 = reinterpret_cast<const float4*>(&qs[0][0]);
  const float4* r4 = reinterpret_cast<const float4*>(BF ? &qr[0][0] : &qs[0][0]);
  const float4* g4 = reinterpret_cast<const float4*>(&gs[0][0]);

  if (blockIdx.x * KB < valid_len) {  // uniform over the block
    for (int q0 = 0; q0 < seq; q0 += QB) {
      const int nq = min(QB, seq - q0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < QB * D / 4; idx += THREADS) {
        const int i = idx / (D / 4), c4 = idx % (D / 4);
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), gv = qv;
        if (i < nq) {
          const long r = (long)b * seq + q0 + i;
          qv = ld4(l.base + (long)(q0 + i) * l.row_stride + l.col, c4);
          gv = ld4(dout + r * l.w + h * D, c4);
        }
        if constexpr (BF) {
          reinterpret_cast<float4*>(&qr[i][0])[c4] = qv;
          qv = rnd4(scale4(qv, scale_log2));
        }
        reinterpret_cast<float4*>(&qs[i][0])[c4] = qv;
        reinterpret_cast<float4*>(&gs[i][0])[c4] = gv;
      }
      if (threadIdx.x < QB) {
        const int i = threadIdx.x;
        lses[i] = i < nq ? lse[stat0 + q0 + i] : INFINITY;  // absent queries: p = 0
        dls[i] = i < nq ? delta[stat0 + q0 + i] : 0.f;
      }
      __syncthreads();

      float s[QB], dp[QB];
#pragma unroll
      for (int i = 0; i < QB; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          s[i] = dot4(k[c], q4[i * (D / 4) + 2 * c + half], s[i]);
          dp[i] = dot4(v[c], g4[i * (D / 4) + 2 * c + half], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        float si = s[i] + __shfl_xor_sync(0xffffffffu, s[i], 1);
        if constexpr (!BF) si *= scale_log2;
        const float dpi = dp[i] + __shfl_xor_sync(0xffffffffu, dp[i], 1);
        const float p = exp2f(si - lses[i]);
        const float ds = p * (dpi - dls[i]);
        s[i] = BF ? rnd(p) : p;
        dp[i] = BF ? rnd(ds) : ds;
      }
#pragma unroll
      for (int i = 0; i < QB; ++i) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          axpy4(s[i], g4[i * (D / 4) + 2 * c + half], dv[c]);
          axpy4(dp[i], r4[i * (D / 4) + 2 * c + half], dk[c]);
        }
      }
    }
  }

  if (kj < seq) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    T* drow = dqkv + ((long)b * seq + kj) * l.row_stride + l.col;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      st4(drow + l.wg, 2 * c + half, k_ok ? scale4(dk[c], scale) : zero);
      st4(drow + 2 * l.wg, 2 * c + half, k_ok ? dv[c] : zero);
    }
  }
}

template <typename T>
int launch_fwd(const void* qkv, void* out, void* lse, int batch, int seq, int heads, int groups,
               int valid_len, float scale_log2, void* stream) {
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fqa_fwd<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<float*>(lse),
      seq, heads, groups, valid_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* qkv, const void* out, const void* dout, const void* lse, void* delta,
               void* dqkv, int batch, int seq, int heads, int groups, int valid_len,
               float scale_log2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_q((seq + QT - 1) / QT, heads, batch);
  fqa_bwd_dq<T><<<grid_q, THREADS, 0, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<T*>(dqkv), seq,
      heads, groups, valid_len, scale_log2, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_k((seq + KB - 1) / KB, heads, batch);
  fqa_bwd_dkdv<T><<<grid_k, THREADS, 0, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqkv), seq, heads, groups, valid_len,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [batch*seq, 3*heads*64] f32, out [batch*seq, heads*64] f32, lse
// [batch, heads, seq] f32 or null; all contiguous and 16-byte aligned.
// scale_log2 = log2(e) / sqrt(64). Returns cudaGetLastError() after launch.
extern "C" int fused_qkv_attention_fwd(const void* qkv, void* out, void* lse, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, void* stream) {
  return launch_fwd<float>(qkv, out, lse, batch, seq, heads, groups, valid_len, scale_log2,
                           stream);
}

// The same with qkv and out in bf16 (lse f32); scale_log2 = c2, the bf16
// value of log2(e) / sqrt(64).
extern "C" int fused_qkv_attention_fwd_bf16(const void* qkv, void* out, void* lse, int batch,
                                            int seq, int heads, int groups, int valid_len,
                                            float scale_log2, void* stream) {
  return launch_fwd<bf16>(qkv, out, lse, batch, seq, heads, groups, valid_len, scale_log2,
                          stream);
}

// The backward: qkv, out and lse as saved by the forward, dout [batch*seq,
// heads*64]; delta [batch, heads, seq] f32 scratch; dqkv [batch*seq,
// 3*heads*64] is written in full. Two launches on one stream: dQ (which
// also writes delta), then dK/dV. Returns cudaGetLastError().
extern "C" int fused_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                       const void* lse, void* delta, void* dqkv, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, float scale, void* stream) {
  return launch_bwd<float>(qkv, out, dout, lse, delta, dqkv, batch, seq, heads, groups,
                           valid_len, scale_log2, scale, stream);
}

// The same in bf16 (qkv, dout, dqkv bf16; lse, delta f32); out is not read
// (delta = rowsum(p * dp)) and may be null.
extern "C" int fused_qkv_attention_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                            const void* lse, void* delta, void* dqkv, int batch,
                                            int seq, int heads, int groups, int valid_len,
                                            float scale_log2, float scale, void* stream) {
  return launch_bwd<bf16>(qkv, out, dout, lse, delta, dqkv, batch, seq, heads, groups,
                          valid_len, scale_log2, scale, stream);
}
