// Fused-qkv attention, forward and backward, f32, for Hopper (sm_90a).
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
// What bounds it on the H100: at the denoiser's shapes (S 520, D 64, f32)
// the forward is 4*S*S*D flops per (sequence, head) and the backward 14*S*S*D
// (QK^T and dO V^T recomputed twice, then dQ, dK, dV), against a few reads
// of the [B*S, 3W] qkv: both are compute-bound, on the f32 FMA pipes (no
// tensor cores in the exact-f32 flavour). One (sequence, head)'s K and V in
// f32 are 2*520*64*4 = 266 KB, above the 227 KB of shared memory a block can
// hold, so every kernel streams tiles of the other side through shared memory
// and keeps its own rows in registers:
//   * forward: one block per (sequence, head, 64-query tile), two threads per
//     query that split the 64 head dims in interleaved float4 chunks (the
//     pair reads 32 contiguous bytes of shared memory per load) and combine
//     partial dot products with one shuffle per key; K/V tiles of 32 keys,
//     online softmax (running max and sum); the 32 keys' scores are
//     accumulated side by side, so the FMAs form 32 independent chains.
//   * backward, dQ: the same layout over query tiles. Each pair computes
//     delta = rowsum(dO * O) from the saved output (the same number as the
//     TPU kernel's rowsum(P * dP), cheaper, and memory allows keeping O),
//     writes it for the dK/dV pass, then streams K/V tiles: p = exp2(s - lse),
//     dp = dO . v, ds = p (dp - delta), dq += ds k.
//   * backward, dK/dV: one block per (sequence, head, 64-key tile), two
//     threads per key, streaming Q/dO tiles of 16 queries (all S queries, pad
//     queries included): dv += p dO, dk += ds q.
// dq, dk and dv are written straight into the grouped [Q_g|K_g|V_g] columns
// of one dqkv [B*S, 3W], every element of it: pad-key rows (>= valid_len) of
// dk and dv are written as exact zeros, and pad-query rows of dq are
// computed (0 when their dO rows are 0, as in the denoiser, whose pad rows
// are sliced off). The next weight gradient dW_qkv = X^T dqkv reads every row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;            // head dim
constexpr int QT = 64;           // queries per block (forward, dQ)
constexpr int KT = 32;           // keys per shared-memory tile (forward, dQ)
constexpr int KB = 64;           // keys per block (dK/dV)
constexpr int QB = 16;           // queries per shared-memory tile (dK/dV)
constexpr int CH = D / 8;        // float4 chunks per thread: half h owns chunks 2c + h
constexpr int THREADS = 128;     // two threads per query (or key)

struct Layout {
  const float* base;  // qkv rows of this sequence
  long row_stride;    // 3W
  int col;            // this head's Q column; K at +wg, V at +2wg
  int wg;
  int w;
};

__device__ __forceinline__ Layout layout(const float* qkv, int b, int h, int seq,
                                         int heads, int groups) {
  Layout l;
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

// Stage keys [k0, k0 + nk) of K and V into shared memory (zeros past nk).
__device__ __forceinline__ void load_kv_tile(const Layout& l, int k0, int nk,
                                             float (*ks)[D], float (*vs)[D]) {
  for (int idx = threadIdx.x; idx < KT * D / 4; idx += THREADS) {
    const int j = idx / (D / 4), c4 = idx % (D / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j < nk) {
      const float* r = l.base + (long)(k0 + j) * l.row_stride + l.col;
      kv = reinterpret_cast<const float4*>(r + l.wg)[c4];
      vv = reinterpret_cast<const float4*>(r + 2 * l.wg)[c4];
    }
    reinterpret_cast<float4*>(&ks[j][0])[c4] = kv;
    reinterpret_cast<float4*>(&vs[j][0])[c4] = vv;
  }
}

__global__ void __launch_bounds__(THREADS)
fqa_fwd(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lse,
        int seq, int heads, int groups, int valid_len, float scale_log2) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * QT + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const float4* qrow = reinterpret_cast<const float4*>(
      l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col);
  float4 q[CH], o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 t = qrow[2 * c + half];
    q[c] = make_float4(t.x * scale_log2, t.y * scale_log2, t.z * scale_log2, t.w * scale_log2);
    o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, lsum = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  for (int k0 = 0; k0 < valid_len; k0 += KT) {
    const int nk = min(KT, valid_len - k0);
    __syncthreads();  // the previous tile is fully consumed
    load_kv_tile(l, k0, nk, ks, vs);
    __syncthreads();

    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) s[j] = dot4(q[c], k4[j * (D / 4) + 2 * c + half], s[j]);
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float sj = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] = j < nk ? sj : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
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

  if (q_ok) {
    const float inv = 1.f / lsum;
    float4* orow = reinterpret_cast<float4*>(out + ((long)b * seq + qi) * l.w + h * D);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      orow[2 * c + half] = make_float4(o[c].x * inv, o[c].y * inv, o[c].z * inv, o[c].w * inv);
    if (lse != nullptr && half == 0) lse[((long)b * heads + h) * seq + qi] = m + log2f(lsum);
  }
}

__global__ void __launch_bounds__(THREADS)
fqa_bwd_dq(const float* __restrict__ qkv, const float* __restrict__ out,
           const float* __restrict__ dout, const float* __restrict__ lse,
           float* __restrict__ delta, float* __restrict__ dqkv, int seq, int heads,
           int groups, int valid_len, float scale_log2, float scale) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * QT + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const long row = (long)b * seq + (q_ok ? qi : 0);
  const float4* qrow = reinterpret_cast<const float4*>(
      l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col);
  const float4* grow = reinterpret_cast<const float4*>(dout + row * l.w + h * D);
  const float4* orow = reinterpret_cast<const float4*>(out + row * l.w + h * D);
  float4 q[CH], g[CH], dq[CH];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 t = qrow[2 * c + half];
    q[c] = make_float4(t.x * scale_log2, t.y * scale_log2, t.z * scale_log2, t.w * scale_log2);
    g[c] = grow[2 * c + half];
    dl = dot4(g[c], orow[2 * c + half], dl);
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  const long stat = ((long)b * heads + h) * seq + qi;
  const float lse_i = q_ok ? lse[stat] : INFINITY;  // rows past seq: p = 0
  if (q_ok && half == 0) delta[stat] = dl;
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  for (int k0 = 0; k0 < valid_len; k0 += KT) {
    const int nk = min(KT, valid_len - k0);
    __syncthreads();
    load_kv_tile(l, k0, nk, ks, vs);
    __syncthreads();

    float s[KT], dp[KT];
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
      const float dpj = dp[j] + __shfl_xor_sync(0xffffffffu, dp[j], 1);
      const float p = j < nk ? exp2f(sj - lse_i) : 0.f;
      s[j] = p * (dpj - dl);  // ds
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) axpy4(s[j], k4[j * (D / 4) + 2 * c + half], dq[c]);
    }
  }

  if (q_ok) {
    float4* drow = reinterpret_cast<float4*>(dqkv + row * l.row_stride + l.col);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      drow[2 * c + half] = make_float4(dq[c].x * scale, dq[c].y * scale, dq[c].z * scale,
                                       dq[c].w * scale);
  }
}

__global__ void __launch_bounds__(THREADS)
fqa_bwd_dkdv(const float* __restrict__ qkv, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dqkv, int seq, int heads, int groups, int valid_len,
             float scale_log2, float scale) {
  __shared__ __align__(16) float qs[QB][D];
  __shared__ __align__(16) float gs[QB][D];
  __shared__ float lses[QB], dls[QB];

  const int half = threadIdx.x & 1;
  const int kj = blockIdx.x * KB + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout l = layout(qkv, b, h, seq, heads, groups);
  const long stat0 = ((long)b * heads + h) * seq;

  const bool k_ok = kj < valid_len;  // a real key; pad keys get dk = dv = 0
  const float* krow = l.base + (long)(k_ok ? kj : 0) * l.row_stride + l.col;
  const float4* k4g = reinterpret_cast<const float4*>(krow + l.wg);
  const float4* v4g = reinterpret_cast<const float4*>(krow + 2 * l.wg);
  float4 k[CH], v[CH], dk[CH], dv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    k[c] = k4g[2 * c + half];
    v[c] = v4g[2 * c + half];
    dk[c] = dv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* q4 = reinterpret_cast<const float4*>(&qs[0][0]);
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
          qv = reinterpret_cast<const float4*>(l.base + (long)(q0 + i) * l.row_stride + l.col)[c4];
          gv = reinterpret_cast<const float4*>(dout + r * l.w + h * D)[c4];
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
        const float si = (s[i] + __shfl_xor_sync(0xffffffffu, s[i], 1)) * scale_log2;
        const float dpi = dp[i] + __shfl_xor_sync(0xffffffffu, dp[i], 1);
        const float p = exp2f(si - lses[i]);
        s[i] = p;
        dp[i] = p * (dpi - dls[i]);  // ds
      }
#pragma unroll
      for (int i = 0; i < QB; ++i) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          axpy4(s[i], g4[i * (D / 4) + 2 * c + half], dv[c]);
          axpy4(dp[i], q4[i * (D / 4) + 2 * c + half], dk[c]);
        }
      }
    }
  }

  if (kj < seq) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float* drow = dqkv + ((long)b * seq + kj) * l.row_stride + l.col;
    float4* dk4 = reinterpret_cast<float4*>(drow + l.wg);
    float4* dv4 = reinterpret_cast<float4*>(drow + 2 * l.wg);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      dk4[2 * c + half] = k_ok ? make_float4(dk[c].x * scale, dk[c].y * scale,
                                             dk[c].z * scale, dk[c].w * scale) : zero;
      dv4[2 * c + half] = k_ok ? dv[c] : zero;
    }
  }
}

}  // namespace

// qkv [batch*seq, 3*heads*64] f32, out [batch*seq, heads*64] f32, lse
// [batch, heads, seq] f32 or null; all contiguous and 16-byte aligned.
// Returns cudaGetLastError() after launch.
extern "C" int fused_qkv_attention_fwd(const void* qkv, void* out, void* lse, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, void* stream) {
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fqa_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(lse),
      seq, heads, groups, valid_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The backward: qkv, out and lse as saved by the forward, dout [batch*seq,
// heads*64]; delta [batch, heads, seq] f32 scratch; dqkv [batch*seq,
// 3*heads*64] is written in full. Two launches on one stream: dQ (which
// also writes delta), then dK/dV. Returns cudaGetLastError().
extern "C" int fused_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                       const void* lse, void* delta, void* dqkv, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_q((seq + QT - 1) / QT, heads, batch);
  fqa_bwd_dq<<<grid_q, THREADS, 0, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dqkv), seq, heads, groups, valid_len,
      scale_log2, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_k((seq + KB - 1) / KB, heads, batch);
  fqa_bwd_dkdv<<<grid_k, THREADS, 0, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dqkv), seq, heads, groups, valid_len, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
