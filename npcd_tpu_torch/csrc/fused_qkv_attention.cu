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
// Two flavours with two designs.
//
// f32 (exact f32 on the CUDA cores, no TF32): at the denoiser's shapes (S
// 520, D 64) the forward is 4*S*S*D flops per (sequence, head) and the
// backward 14*S*S*D, against a few reads of the [B*S, 3W] qkv: both are
// compute-bound on the f32 FMA pipes. One (sequence, head)'s K and V in f32
// are 2*520*64*4 = 266 KB, above the 227 KB of shared memory a block can
// hold, so every kernel streams tiles of the other side through shared
// memory and keeps its own rows in registers:
//   * forward: one block per (sequence, head, 64-query tile), two threads per
//     query that split the 64 head dims in interleaved float4 chunks (the
//     pair reads 32 contiguous bytes of shared memory per load) and combine
//     partial dot products with one shuffle per key; K/V tiles of 32 keys,
//     online softmax (running max and sum) in f32; the 32 keys' scores are
//     accumulated side by side, so the FMAs form 32 independent chains.
//   * backward, dQ: the same layout over query tiles; each pair computes
//     delta = rowsum(dO * O) from the saved output (the same number as the
//     TPU kernel's rowsum(P * dP), cheaper) and writes it for the dK/dV
//     pass, then streams K/V tiles: p = exp2(s - lse), dp = dO . v, ds =
//     p (dp - delta), dq += ds k.
//   * backward, dK/dV: one block per (sequence, head, 64-key tile), two
//     threads per key, streaming Q/dO tiles of 16 queries (all S queries, pad
//     queries included): dv += p dO, dk += ds q.
//
// bf16 (qkv, out, dout, dqkv bf16; lse, delta f32), with the TPU kernel's
// rounding points:
//   * forward: c2 = bf16(scale * log2 e) (passed in), q_s = bf16(q * c2);
//     s = q_s . k in f32; m = the row max over all valid keys; e =
//     bf16(exp2(s - m)); l = the f32 sum of the bf16 e (the TPU's sum-dot
//     at D 64); out = bf16((sum_j e_j v_j) / l); lse = m + log2(l) in f32.
//     The TPU takes m before any exponent, so the forward makes two passes
//     over the keys (the max, then e, l and o) instead of an online softmax,
//     whose running max would round e elsewhere;
//   * backward: p = exp2(s - lse) in f32 from the same q_s; dV sums
//     bf16(p) dO; delta = rowsum(p * dp) over the keys, as the TPU computes
//     it (rowsum(dO * O) would read the bf16-rounded output); ds =
//     bf16(p (dp - delta)); dQ = bf16(scale * sum ds k), dK = bf16(scale *
//     sum ds q) with the unscaled q, dV rounded to bf16.
// Every product is bf16 x bf16 summed in f32, which is what the tensor cores
// compute. The design is FlashAttention 2's on mma.sync: each warp owns 16
// rows (queries forward and in the dQ pass, keys in the dK/dV pass) and runs
// every product as mma.sync.m16n8k16 (bf16 in, f32 accumulate). Its own
// rows' operands stay in registers as A fragments for the whole kernel
// (bf16(q * c2) and dO, or k and v); the other side streams through shared
// memory as bf16 in 64-row tiles, copied by cp.async into a two-stage ring
// (the next tile's copy overlaps the current tile's products; rows past the
// sequence or past valid_len are zero-filled, never read) and read by
// ldmatrix (.trans for the operand whose rows are the summed dimension).
// Rows are padded to 72 bf16 (144 bytes) so that ldmatrix's eight 16-byte
// rows fall in distinct banks. A score tile's f32 C fragment is rounded to
// bf16 in registers and repacked as the A fragment of the next product:
// that repacking is where the TPU kernel casts e, p and ds. Streamed 64-row
// tiles keep shared memory at 36-47 KB a block (several blocks per SM)
// instead of one head's whole 133 KB of K and V. A block is 4 warps, 64 rows;
// the grid is (row tile, head, sequence), 4,608 blocks at batch 32 x 16
// heads x 520 tokens.
//   * forward: the keys twice, 64 a tile, 32 a step in registers: the max
//     pass (K tiles only), then e, l and o (K and V tiles). Each step's e . v
//     goes into a fresh accumulator that is added to o in f32: accumulating
//     all 33 steps inside the mma (whose f32 sums do not round as an FMA
//     chain does) put the bf16 stage-2 step's loss 1.6x further from the
//     CPU's, for 12% less time.
//   * backward, dQ: the keys twice: the first sweep sums p * dp for delta,
//     which it writes for the dK/dV pass, the second accumulates dq.
//   * backward, dK/dV: one block per 64-key tile, streaming every query of
//     the sequence in tiles of 64 (raw q and dO by cp.async, then bf16(q *
//     c2) formed once per tile in shared memory), 16 queries a step:
//     s^T = k q_s^T and dp^T = v dO^T, then dv += bf16(p)^T dO and dk +=
//     ds^T q.
// What bounds it: the work (6*S*S*D flops per (sequence, head) forward,
// 18*S*S*D backward, whose dQ pass sweeps the keys twice) is ~0.1 ms of the
// dense BF16 peak at batch 32 x 16 heads against ~0.04 ms of HBM bytes, but
// mma.sync reads both operands through registers: every warp reloads the
// streamed tile's B fragments for its own 16 rows, one 512-byte ldmatrix.x4
// per two mma.sync, and at the SM's 128 bytes of shared memory per clock
// that traffic takes longer than the products it feeds. Blocks of 8 warps
// (128 rows, half the L2 traffic) ran slower at these shapes, so the limit
// is shared memory and latency, not L2; wgmma, which reads B from shared
// memory once for a 64-row warpgroup, is the next step.
// No sum uses atomics and every sum runs in a fixed order, so both flavours
// are bitwise repeatable from run to run.
//
// dq, dk and dv are written straight into the grouped [Q_g|K_g|V_g] columns
// of one dqkv [B*S, 3W], every element of it: pad-key rows (>= valid_len) of
// dk and dv are written as exact zeros, and pad-query rows of dq are
// computed (0 when their dO rows are 0, as in the denoiser, whose pad rows
// are sliced off). The next weight gradient dW_qkv = X^T dqkv reads every row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;  // head dim

typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int QT = 64;           // queries per block (forward, dQ)
constexpr int KT = 32;           // keys per shared-memory tile (forward, dQ)
constexpr int KB = 64;           // keys per block (dK/dV)
constexpr int QB = 16;           // queries per shared-memory tile (dK/dV)
constexpr int CH = D / 8;        // float4 chunks per thread: half h owns chunks 2c + h
constexpr int THREADS = 128;     // two threads per query (or key)

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Elements [4 c4, 4 c4 + 4) of a row.
__device__ __forceinline__ float4 ld4(const float* row, int c4) {
  return reinterpret_cast<const float4*>(row)[c4];
}

__device__ __forceinline__ void st4(float* row, int c4, float4 v) {
  reinterpret_cast<float4*>(row)[c4] = v;
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
__device__ __forceinline__ void load_kv_tile(const Layout<float>& l, int k0, int nk,
                                             float (*ks)[D], float (*vs)[D]) {
  for (int idx = threadIdx.x; idx < KT * D / 4; idx += THREADS) {
    const int j = idx / (D / 4), c4 = idx % (D / 4);
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
    if (j < nk) {
      const float* r = l.base + (long)(k0 + j) * l.row_stride + l.col;
      kv = ld4(r + l.wg, c4);
      vv = ld4(r + 2 * l.wg, c4);
    }
    reinterpret_cast<float4*>(&ks[j][0])[c4] = kv;
    reinterpret_cast<float4*>(&vs[j][0])[c4] = vv;
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

__global__ void __launch_bounds__(THREADS)
fqa_fwd(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lse,
        int seq, int heads, int groups, int valid_len, float scale_log2) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * QT + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const float* qrow = l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col;
  float4 q[CH], o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    q[c] = scale4(ld4(qrow, 2 * c + half), scale_log2);
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
    tile_scores(q, k4, half, nk, s);
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

  if (q_ok) {
    float* orow = out + ((long)b * seq + qi) * l.w + h * D;
    const float inv = 1.f / lsum;
#pragma unroll
    for (int c = 0; c < CH; ++c) st4(orow, 2 * c + half, scale4(o[c], inv));
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
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);

  const bool q_ok = qi < seq;
  const long row = (long)b * seq + (q_ok ? qi : 0);
  const float* qrow = l.base + (long)(q_ok ? qi : 0) * l.row_stride + l.col;
  const float* grow = dout + row * l.w + h * D;
  float4 q[CH], g[CH], dq[CH];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    q[c] = scale4(ld4(qrow, 2 * c + half), scale_log2);
    g[c] = ld4(grow, 2 * c + half);
    dl = dot4(g[c], ld4(out + row * l.w + h * D, 2 * c + half), dl);
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

    // s = q . k (the pair's halves combined) and dp = dO . v for the tile
    float p[KT], dp[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) p[j] = dp[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        p[j] = dot4(q[c], k4[j * (D / 4) + 2 * c + half], p[j]);
        dp[j] = dot4(g[c], v4[j * (D / 4) + 2 * c + half], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float sj = p[j] + __shfl_xor_sync(0xffffffffu, p[j], 1);
      dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
      p[j] = j < nk ? exp2f(sj - lse_i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) p[j] = p[j] * (dp[j] - dl);  // ds
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) axpy4(p[j], k4[j * (D / 4) + 2 * c + half], dq[c]);
    }
  }

  if (q_ok) {
    float* drow = dqkv + row * l.row_stride + l.col;
#pragma unroll
    for (int c = 0; c < CH; ++c) st4(drow, 2 * c + half, scale4(dq[c], scale));
  }
}

__global__ void __launch_bounds__(THREADS)
fqa_bwd_dkdv(const float* __restrict__ qkv, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dqkv, int seq, int heads, int groups, int valid_len,
             float scale_log2, float scale) {
  __shared__ __align__(16) float qs[QB][D];  // q; the scale multiplies the score
  __shared__ __align__(16) float gs[QB][D];
  __shared__ float lses[QB], dls[QB];

  const int half = threadIdx.x & 1;
  const int kj = blockIdx.x * KB + (threadIdx.x >> 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);
  const long stat0 = ((long)b * heads + h) * seq;

  const bool k_ok = kj < valid_len;  // a real key; pad keys get dk = dv = 0
  const float* krow = l.base + (long)(k_ok ? kj : 0) * l.row_stride + l.col;
  float4 k[CH], v[CH], dk[CH], dv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    k[c] = ld4(krow + l.wg, 2 * c + half);
    v[c] = ld4(krow + 2 * l.wg, 2 * c + half);
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
          qv = ld4(l.base + (long)(q0 + i) * l.row_stride + l.col, c4);
          gv = ld4(dout + r * l.w + h * D, c4);
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
        si *= scale_log2;
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
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      st4(drow + l.wg, 2 * c + half, k_ok ? scale4(dk[c], scale) : zero);
      st4(drow + 2 * l.wg, 2 * c + half, k_ok ? dv[c] : zero);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;   // threads per block
constexpr int ROWS = 16 * WARPS; // the block's own rows: 16 per warp
constexpr int TILE = 64;         // rows of the streamed side per shared-memory tile
constexpr int LD = D + 8;        // padded row (144 bytes): ldmatrix without bank conflicts

typedef bf16 Tile[TILE][LD];

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok (src is
// then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Rows [r0, r0 + TILE) of one head's 64 columns (src: row 0, stride in
// elements) into t; rows at or past `end` are zero-filled.
__device__ __forceinline__ void load_tile(Tile& t, const bf16* src, long stride, int r0,
                                          int end) {
#pragma unroll
  for (int it = 0; it < TILE * D / 8 / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i >> 3, c = (i & 7) * 8;
    const bool ok = r0 + r < end;
    cp16(&t[r][c], src + (ok ? (long)(r0 + r) * stride + c : 0), ok);
  }
}

__device__ __forceinline__ void ldsm(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

// c += a b: a the 16 x 16 A fragment (row-major), b0/b1 the 16 x 8 B fragment.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// bf16(x * c2) of both halves
__device__ __forceinline__ unsigned scale2(unsigned u, float c2) {
  return pack(lo(u) * c2, hi(u) * c2);
}

// Fragment addressing; lane = threadIdx.x & 31. In a C fragment a lane holds
// rows g = lane / 4 and g + 8, columns 2 (lane % 4) and + 1 of an 8-column
// n-tile; an A fragment is two n-tiles' C fragments side by side.
//
// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of t.
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const Tile& t, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm(a, &t[r0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}

// s[j] += a . t[n0 + 8j .. n0 + 8j + 8]^T for the first `ntiles` of the 4
// n-tiles of rows [n0, n0 + 32) of t (the B operand is t's rows: keys or
// queries), over all 64 columns.
__device__ __forceinline__ void rows_product(float (&s)[4][4], const unsigned (&a)[4][4],
                                             const Tile& t, int n0, int ntiles) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < ntiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned b[4];
        ldsm(b, &t[n0 + 8 * j + (lane & 7)][32 * h + (lane >> 3) * 8]);
        mma(s[j], a[2 * h], b[0], b[1]);
        mma(s[j], a[2 * h + 1], b[2], b[3]);
      }
    }
  }
}

// acc[n] += a . t[k0 .. k0 + 16][8n .. 8n + 8] for the 8 n-tiles of the 64
// columns (the B operand is t's columns, summed over its rows).
__device__ __forceinline__ void cols_product(float (&acc)[8][4], const unsigned (&a)[4],
                                             const Tile& t, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    unsigned b[4];
    ldsm_t(b, &t[k0 + (lane & 15)][16 * n + (lane >> 4) * 8]);
    mma(acc[2 * n], a, b[0], b[1]);
    mma(acc[2 * n + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store rows g and g + 8 of a [16, 64] accumulator, each times mul[r],
// rounded to bf16, at dst + row * stride for the rows that `keep`; rows
// that keep but not `nonzero` are written as 0.
__device__ __forceinline__ void store_rows(bf16* dst, long stride, const float (&acc)[8][4],
                                           const float (&mul)[2], const bool (&keep)[2],
                                           const bool (&nonzero)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!keep[r]) continue;
    unsigned* row = reinterpret_cast<unsigned*>(dst + (long)(g + 8 * r) * stride + c);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      row[4 * n] = nonzero[r] ? pack(acc[n][2 * r] * mul[r], acc[n][2 * r + 1] * mul[r]) : 0u;
  }
}

// The A fragments [16 rows, 64 columns] of the warp's rows of the block's
// own rows, staged in t.
__device__ __forceinline__ void own_rows(unsigned (&a)[4][4], const Tile& t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) frag_a(a[kk], t, 16 * (threadIdx.x >> 5), 16 * kk);
}

__global__ void __launch_bounds__(NT)
fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, float* __restrict__ lse, int seq,
    int heads, int groups, int valid_len, float c2) {
  __shared__ __align__(128) Tile ring[4];  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<bf16> l = layout(qkv, b, h, seq, heads, groups);
  const bf16* qsrc = l.base + l.col;
  const bf16* ksrc = qsrc + l.wg;
  const bf16* vsrc = qsrc + 2 * l.wg;
  const int wq = q0 + 16 * warp;  // the warp's first query
  const bool active = wq < seq;   // uniform over the warp
  const int nkt = (valid_len + TILE - 1) / TILE, steps = 2 * nkt;

  // the block's queries (staged in ring[3]) and the first K tile
  load_tile(ring[3], qsrc, l.row_stride, q0, seq);
  load_tile(ring[0], ksrc, l.row_stride, 0, valid_len);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qa[4][4];  // bf16(q * c2), the A operand of s
  own_rows(qa, ring[3]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale2(qa[kk][i], c2);
  __syncthreads();

  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
  // steps [0, nkt): the max over K tiles; [nkt, 2 nkt): e, l, o over K and V
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      const int k1 = ((t + 1) % nkt) * TILE, buf = (t + 1) & 1;
      load_tile(ring[buf], ksrc, l.row_stride, k1, valid_len);
      if (t + 1 >= nkt) load_tile(ring[2 + buf], vsrc, l.row_stride, k1, valid_len);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bool second = t >= nkt;
    if (t == nkt) m[0] = quad_max(m[0]), m[1] = quad_max(m[1]);
    if (active) {
      const Tile& kt = ring[t & 1];
      const Tile& vt = ring[2 + (t & 1)];
      const int k0 = (t % nkt) * TILE;
#pragma unroll
      for (int sub = 0; sub < TILE / 32; ++sub) {
        const int kc = k0 + 32 * sub;
        if (kc >= valid_len) break;
        float s[4][4] = {};
        rows_product(s, qa, kt, 32 * sub, min(4, (valid_len - kc + 7) / 8));
        if (kc + 32 > valid_len) {  // the last tile: keys past valid_len at -inf
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (kc + 8 * j + c + (e & 1) >= valid_len) s[j][e] = -INFINITY;
        }
        if (!second) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
            m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
          }
        } else {
          unsigned ea[2][4];  // e = bf16(exp2(s - m)), the A operand of o
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const unsigned e = pack(exp2f(s[j][2 * r] - m[r]), exp2f(s[j][2 * r + 1] - m[r]));
              lsum[r] += lo(e);
              lsum[r] += hi(e);
              ea[j >> 1][2 * (j & 1) + r] = e;
            }
          }
          // this step's e . v in a fresh accumulator, added to o in f32: a
          // chain of 33 mma accumulations into o drifts from the f32 sum
          float ov[8][4] = {};
          cols_product(ov, ea[0], vt, 32 * sub);
          cols_product(ov, ea[1], vt, 32 * sub + 16);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] += ov[n][e];
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  // out = bf16(o / l): divided, not multiplied by 1 / l, then rounded once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g + 8 * r;
    lsum[r] = quad_sum(lsum[r]);
    if (row >= seq) continue;
    unsigned* dst = reinterpret_cast<unsigned*>(out + ((long)b * seq + row) * l.w + h * D + c);
#pragma unroll
    for (int n = 0; n < 8; ++n) dst[4 * n] = pack(o[n][2 * r] / lsum[r], o[n][2 * r + 1] / lsum[r]);
    if (lse != nullptr && c == 0) lse[((long)b * heads + h) * seq + row] = m[r] + log2f(lsum[r]);
  }
}

__global__ void __launch_bounds__(NT)
bwd_dq(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dqkv,
       int seq, int heads, int groups, int valid_len, float c2, float scale) {
  __shared__ __align__(128) Tile ring[4];  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<bf16> l = layout(qkv, b, h, seq, heads, groups);
  const bf16* qsrc = l.base + l.col;
  const bf16* ksrc = qsrc + l.wg;
  const bf16* vsrc = qsrc + 2 * l.wg;
  const bf16* gsrc = dout + (long)b * seq * l.w + h * D;
  const int wq = q0 + 16 * warp;
  const bool active = wq < seq;
  const int nkt = (valid_len + TILE - 1) / TILE, steps = 2 * nkt;
  const long stat0 = ((long)b * heads + h) * seq;

  // the block's queries and cotangents (staged in ring[1], ring[3]) and the
  // first K/V tile
  load_tile(ring[1], qsrc, l.row_stride, q0, seq);
  load_tile(ring[3], gsrc, l.w, q0, seq);
  load_tile(ring[0], ksrc, l.row_stride, 0, valid_len);
  load_tile(ring[2], vsrc, l.row_stride, 0, valid_len);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qa[4][4], ga[4][4];  // bf16(q * c2) and dO, the A operands of s and dp
  own_rows(qa, ring[1]);
  own_rows(ga, ring[3]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale2(qa[kk][i], c2);
  __syncthreads();

  const int rows[2] = {wq + g, wq + g + 8};
  float lr[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) lr[r] = rows[r] < seq ? lse[stat0 + rows[r]] : INFINITY;
  float dq[8][4] = {};

  // steps [0, nkt): delta = rowsum(p * dp); [nkt, 2 nkt): dq += ds k
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      const int k1 = ((t + 1) % nkt) * TILE, buf = (t + 1) & 1;
      load_tile(ring[buf], ksrc, l.row_stride, k1, valid_len);
      load_tile(ring[2 + buf], vsrc, l.row_stride, k1, valid_len);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bool second = t >= nkt;
    if (t == nkt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl[r] = quad_sum(dl[r]);
        if (active && c == 0 && rows[r] < seq) delta[stat0 + rows[r]] = dl[r];
      }
    }
    if (active) {
      const Tile& kt = ring[t & 1];
      const Tile& vt = ring[2 + (t & 1)];
      const int k0 = (t % nkt) * TILE;
#pragma unroll
      for (int sub = 0; sub < TILE / 32; ++sub) {
        const int kc = k0 + 32 * sub;
        if (kc >= valid_len) break;
        const int ntiles = min(4, (valid_len - kc + 7) / 8);
        float p[4][4] = {}, dp[4][4] = {};
        rows_product(p, qa, kt, 32 * sub, ntiles);
        rows_product(dp, ga, vt, 32 * sub, ntiles);
        const bool edge = kc + 32 > valid_len;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = exp2f(p[j][e] - lr[e >> 1]);
            p[j][e] = edge && kc + 8 * j + c + (e & 1) >= valid_len ? 0.f : pe;
          }
        if (!second) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dl[e >> 1] = fmaf(p[j][e], dp[j][e], dl[e >> 1]);
        } else {
          unsigned da[2][4];  // ds = bf16(p (dp - delta)), the A operand of dq
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              da[j >> 1][2 * (j & 1) + r] =
                  pack(p[j][2 * r] * (dp[j][2 * r] - dl[r]),
                       p[j][2 * r + 1] * (dp[j][2 * r + 1] - dl[r]));
          cols_product(dq, da[0], kt, 32 * sub);
          cols_product(dq, da[1], kt, 32 * sub + 16);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const float mul[2] = {scale, scale};
  const bool keep[2] = {rows[0] < seq, rows[1] < seq}, nonzero[2] = {true, true};
  store_rows(dqkv + ((long)b * seq + wq) * l.row_stride + l.col, l.row_stride, dq, mul, keep,
             nonzero);
}

__global__ void __launch_bounds__(NT)
bwd_dkdv(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         bf16* __restrict__ dqkv, int seq, int heads, int groups, int valid_len, float c2,
         float scale) {
  __shared__ __align__(128) Tile qr[2], gs[2], qs;  // q, dO (ring); bf16(q * c2)
  __shared__ __align__(16) float ls[2][TILE], ds[2][TILE];  // lse, delta of the tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<bf16> l = layout(qkv, b, h, seq, heads, groups);
  const bf16* qsrc = l.base + l.col;
  const bf16* gsrc = dout + (long)b * seq * l.w + h * D;
  bf16* dk_dst = dqkv + ((long)b * seq) * l.row_stride + l.col + l.wg;
  const long stat0 = ((long)b * heads + h) * seq;

  if (k0 >= valid_len) {  // pad keys only: dk = dv = 0 (uniform over the block)
    for (int i = threadIdx.x; i < ROWS * 16; i += NT) {
      const int r = i >> 4, col = (i & 15) * 8;  // dk then dv: 128 columns
      if (k0 + r < seq)
        *reinterpret_cast<uint4*>(dk_dst + (long)(k0 + r) * l.row_stride + (col & 63) +
                                  (col >> 6) * l.wg) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int wk = k0 + 16 * warp;    // the warp's first key
  const bool active = wk < valid_len;
  const int nqt = (seq + TILE - 1) / TILE;

  // the block's keys and values (staged in qr[1], gs[1]), then the first
  // query tile and its statistics
  load_tile(qr[1], qsrc + l.wg, l.row_stride, k0, valid_len);
  load_tile(gs[1], qsrc + 2 * l.wg, l.row_stride, k0, valid_len);
  load_tile(qr[0], qsrc, l.row_stride, 0, seq);
  load_tile(gs[0], gsrc, l.w, 0, seq);
  cp_commit();
  if (threadIdx.x < TILE) {  // queries past seq: lse +inf, so p = 0
    const int i = threadIdx.x;
    ls[0][i] = i < seq ? lse[stat0 + i] : INFINITY;
    ds[0][i] = i < seq ? delta[stat0 + i] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  unsigned ka[4][4], va[4][4];  // k and v, the A operands of s^T and dp^T
  own_rows(ka, qr[1]);
  own_rows(va, gs[1]);
  __syncthreads();

  float dk[8][4] = {}, dv[8][4] = {};
  for (int t = 0; t < nqt; ++t) {
    const int nbuf = (t + 1) & 1;
    float nl = INFINITY, nd = 0.f;  // the next tile's statistics
    if (t + 1 < nqt) {
      const int q1 = (t + 1) * TILE;
      load_tile(qr[nbuf], qsrc, l.row_stride, q1, seq);
      load_tile(gs[nbuf], gsrc, l.w, q1, seq);
      if (threadIdx.x < TILE && q1 + threadIdx.x < seq) {
        nl = lse[stat0 + q1 + threadIdx.x];
        nd = delta[stat0 + q1 + threadIdx.x];
      }
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int buf = t & 1;
    // bf16(q * c2) of the tile, once for all warps
    for (int i = threadIdx.x; i < TILE * D / 8; i += NT) {
      const int r = i >> 3, col = (i & 7) * 8;
      uint4 u = *reinterpret_cast<const uint4*>(&qr[buf][r][col]);
      u.x = scale2(u.x, c2);
      u.y = scale2(u.y, c2);
      u.z = scale2(u.z, c2);
      u.w = scale2(u.w, c2);
      *reinterpret_cast<uint4*>(&qs[r][col]) = u;
    }
    __syncthreads();
    if (active) {
      const int q0 = t * TILE;
#pragma unroll
      for (int sub = 0; sub < TILE / 16; ++sub) {
        if (q0 + 16 * sub >= seq) break;
        const int qi = 16 * sub;  // the step's first query in the tile
        float s[4][4] = {}, dp[4][4] = {};  // n-tiles 0 and 1 used
        rows_product(s, ka, qs, qi, 2);
        rows_product(dp, va, gs[buf], qi, 2);
        unsigned pa[4], da[4];  // bf16(p)^T and ds^T, the A operands of dv and dk
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(&ls[buf][qi + 8 * j + c]);
          const float2 dj = *reinterpret_cast<const float2*>(&ds[buf][qi + 8 * j + c]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = exp2f(s[j][2 * r] - lj.x), p1 = exp2f(s[j][2 * r + 1] - lj.y);
            pa[2 * j + r] = pack(p0, p1);
            da[2 * j + r] = pack(p0 * (dp[j][2 * r] - dj.x), p1 * (dp[j][2 * r + 1] - dj.y));
          }
        }
        cols_product(dv, pa, gs[buf], qi);
        cols_product(dk, da, qr[buf], qi);
      }
    }
    if (threadIdx.x < TILE && t + 1 < nqt) {
      ls[nbuf][threadIdx.x] = nl;
      ds[nbuf][threadIdx.x] = nd;
    }
    __syncthreads();
  }

  const int rows[2] = {wk + g, wk + g + 8};
  const bool keep[2] = {rows[0] < seq, rows[1] < seq};
  const bool real[2] = {rows[0] < valid_len, rows[1] < valid_len};
  const float mk[2] = {scale, scale}, mv[2] = {1.f, 1.f};
  bf16* base = dk_dst + (long)wk * l.row_stride;
  store_rows(base, l.row_stride, dk, mk, keep, real);
  store_rows(base + l.wg, l.row_stride, dv, mv, keep, real);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int launch_fwd(const float* qkv, float* out, float* lse, int batch, int seq, int heads,
               int groups, int valid_len, float scale_log2, cudaStream_t s) {
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fqa_fwd<<<grid, THREADS, 0, s>>>(qkv, out, lse, seq, heads, groups, valid_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const float* qkv, const float* out, const float* dout, const float* lse,
               float* delta, float* dqkv, int batch, int seq, int heads, int groups,
               int valid_len, float scale_log2, float scale, cudaStream_t s) {
  dim3 grid_q((seq + QT - 1) / QT, heads, batch);
  fqa_bwd_dq<<<grid_q, THREADS, 0, s>>>(qkv, out, dout, lse, delta, dqkv, seq, heads, groups,
                                        valid_len, scale_log2, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_k((seq + KB - 1) / KB, heads, batch);
  fqa_bwd_dkdv<<<grid_k, THREADS, 0, s>>>(qkv, dout, lse, delta, dqkv, seq, heads, groups,
                                          valid_len, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd(const bf16* qkv, bf16* out, float* lse, int batch, int seq, int heads,
               int groups, int valid_len, float c2, cudaStream_t s) {
  dim3 grid((seq + tc::ROWS - 1) / tc::ROWS, heads, batch);
  tc::fwd<<<grid, tc::NT, 0, s>>>(qkv, out, lse, seq, heads, groups, valid_len, c2);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const bf16* qkv, const bf16* dout, const float* lse, float* delta, bf16* dqkv,
               int batch, int seq, int heads, int groups, int valid_len, float c2, float scale,
               cudaStream_t s) {
  dim3 grid((seq + tc::ROWS - 1) / tc::ROWS, heads, batch);
  tc::bwd_dq<<<grid, tc::NT, 0, s>>>(qkv, dout, lse, delta, dqkv, seq, heads, groups,
                                     valid_len, c2, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  tc::bwd_dkdv<<<grid, tc::NT, 0, s>>>(qkv, dout, lse, delta, dqkv, seq, heads, groups,
                                       valid_len, c2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [batch*seq, 3*heads*64] f32, out [batch*seq, heads*64] f32, lse
// [batch, heads, seq] f32 or null; all contiguous and 16-byte aligned.
// scale_log2 = log2(e) / sqrt(64). Returns cudaGetLastError() after launch.
extern "C" int fused_qkv_attention_fwd(const void* qkv, void* out, void* lse, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, void* stream) {
  return launch_fwd(static_cast<const float*>(qkv), static_cast<float*>(out),
                    static_cast<float*>(lse), batch, seq, heads, groups, valid_len, scale_log2,
                    static_cast<cudaStream_t>(stream));
}

// The same with qkv and out in bf16 (lse f32); scale_log2 = c2, the bf16
// value of log2(e) / sqrt(64).
extern "C" int fused_qkv_attention_fwd_bf16(const void* qkv, void* out, void* lse, int batch,
                                            int seq, int heads, int groups, int valid_len,
                                            float scale_log2, void* stream) {
  return launch_fwd(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                    static_cast<float*>(lse), batch, seq, heads, groups, valid_len, scale_log2,
                    static_cast<cudaStream_t>(stream));
}

// The backward: qkv, out and lse as saved by the forward, dout [batch*seq,
// heads*64]; delta [batch, heads, seq] f32 scratch; dqkv [batch*seq,
// 3*heads*64] is written in full. Two launches on one stream: dQ (which
// also writes delta), then dK/dV. Returns cudaGetLastError().
extern "C" int fused_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                       const void* lse, void* delta, void* dqkv, int batch,
                                       int seq, int heads, int groups, int valid_len,
                                       float scale_log2, float scale, void* stream) {
  return launch_bwd(static_cast<const float*>(qkv), static_cast<const float*>(out),
                    static_cast<const float*>(dout), static_cast<const float*>(lse),
                    static_cast<float*>(delta), static_cast<float*>(dqkv), batch, seq, heads,
                    groups, valid_len, scale_log2, scale, static_cast<cudaStream_t>(stream));
}

// The same in bf16 (qkv, dout, dqkv bf16; lse, delta f32); out is not read
// (delta = rowsum(p * dp)) and may be null.
extern "C" int fused_qkv_attention_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                            const void* lse, void* delta, void* dqkv, int batch,
                                            int seq, int heads, int groups, int valid_len,
                                            float scale_log2, float scale, void* stream) {
  (void)out;
  return launch_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                    static_cast<const float*>(lse), static_cast<float*>(delta),
                    static_cast<bf16*>(dqkv), batch, seq, heads, groups, valid_len, scale_log2,
                    scale, static_cast<cudaStream_t>(stream));
}
