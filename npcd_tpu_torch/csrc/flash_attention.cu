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
// partial query tile is masked at S. Both flavours keep the base-e
// log-sum-exp [B, H, S] of the forward for the backward (the TPU recomputes
// the max and the sum instead) and sum delta in the dQ pass's first sweep
// over the keys. D 64 and D 128 are instantiated; another head dim is
// refused. No sum uses atomics and every sum runs in a fixed order, so both
// flavours are bitwise repeatable from run to run.
//
// f32 (exact f32 on the CUDA cores, no TF32). At the denoiser's shapes (S
// 513, D 64) the forward is 4*S*S*D flops per (batch, head) and the backward
// 16*S*S*D (Q K^T and dO V^T twice in the dQ pass, whose first sweep sums
// delta, then again in the dK/dV pass, and dQ, dK, dV), against one read of
// q, k, v (and dO) and one write of each output: compute-bound, on the f32
// FMA pipes. One (batch, head)'s K and V at S 513, D 64 in f32 are 263 KB,
// above the 227 KB of shared memory a block can hold, so each kernel keeps
// its own rows in registers and streams tiles of the other side through
// shared memory, with an online softmax in the forward:
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
//
// bf16 (q, k, v, dO, out, dq, dk, dv bf16; lse, delta f32): the same
// contract, f32 math on the upcast inputs with the outputs rounded once, on
// the tensor cores. Q K^T and dO V^T are bf16 x bf16 products, which
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) computes exactly and sums in
// f32; scale = 1/sqrt(D) multiplies the f32 dot product, as the TPU kernel's
// sm_scale does. P and dS are f32, and one bf16 of each (what SDPA feeds its
// tensor cores) agrees bitwise with the f32 contract on ~57% of the outputs
// after their bf16 rounding. So each C fragment of p or ds becomes two bf16
// A fragments, hi = bf16(x) and lo = bf16(x - hi), whose two mma.sync go
// into one f32 accumulator: x to within 2**-17 of itself, ~99.8% bitwise
// (tests/test_torch_flash_attention.py transcribes this arithmetic on the
// CPU). That split applies to P V in the forward, dS K in the dQ pass and
// P^T dO and dS^T Q in the dK/dV pass. The design is FlashAttention 2's on
// mma.sync, as the bf16 K1 (csrc/fused_qkv_attention.cu, namespace tc): a
// block is 4 warps, each owning 16 rows (queries forward and in the dQ
// pass, keys in the dK/dV pass), 64 a block; the grid is (row tile, head,
// batch), 4,608 blocks at [32, 513, 16, 64]. The warp's own rows are A
// fragments (q; q and dO; k and v); the other side streams through shared
// memory as bf16 in 64-row tiles, copied by cp.async into a two-stage ring
// (the next tile's copy overlaps the current tile's products; rows at or
// past S are zero-filled, never read) and read by ldmatrix (.trans for the
// operand whose rows are the summed dimension). Rows are padded to D + 8
// bf16 so that ldmatrix's eight 16-byte rows fall in distinct banks. Rows
// are [B, S, H, D], so a head's rows lie H*D elements apart. Each step's
// hi + lo products of one 8-column n-tile go into a fresh f32 fragment that
// is added to the running sum in f32 (the MMA's own sums do not round as f32
// adds do, which moved the bf16 K1's results in a chain of 33 steps).
//   * forward: the keys once, 32 a step: s = q k^T * scale, an online
//     softmax (running max m and sum l; o and l times exp(m_old - m_new)
//     when the max moves, which differs from the TPU's max-then-exp only at
//     f32 level), p = exp(s - m), o += (p_hi + p_lo) v; out = bf16(o / l),
//     lse = m + ln l. Keys past S get s = -inf in the last step only.
//   * backward, dQ: the keys twice, 32 a step: the first sweep sums delta =
//     rowsum(p * dp) in f32 with p = exp(s - lse) (not rowsum(dO * O), which
//     would read the bf16-rounded output) and writes it for the dK/dV pass;
//     the second forms ds = p (dp - delta) scale and dq += (ds_hi + ds_lo) k.
//   * backward, dK/dV: one block per 64-key tile, streaming every query in
//     tiles of 64 with their lse and delta, 16 queries a step: s^T = k q^T,
//     dp^T = v dO^T, then dv += (p_hi + p_lo)^T dO and dk += (ds_hi +
//     ds_lo)^T q. Queries past S have lse +inf, so p = ds = 0.
// Registers: at D 128 the dK/dV pass's dk and dv are 128 f32 a thread, and
// k and v as A fragments would add 64, so at D 128 it reads them from
// shared memory (a copy of the block's own rows beside the ring) at each
// step, and keeps them in registers at D 64. ptxas -v (CUDA 12.8): fwd 137
// / 168 registers at D 64 / 128, bwd_dq 168 / 255, bwd_dkdv 168 / 255 with
// 8 bytes spilled at D 128; nothing else spills. Shared memory: 4 tiles
// (37 / 70 KB) forward and dQ, 6 tiles and the statistics (56 / 105 KB)
// dK/dV, all dynamic.
// What bounds it: the work is 3 product units forward (Q K^T, then P V
// twice: hi and lo) and 12 backward (2 + 4 in the dQ pass's two sweeps, 6 in
// the dK/dV pass), a unit being 2*S*S*D flops per (batch, head); the
// function itself needs 2 and 5. At [32, 513, 16, 64] a unit is 17.25
// GFLOP: the forward's 3 take 0.052 ms at the dense BF16 peak and the
// backward's 12 0.209 ms, against ~0.04 ms of HBM bytes each way. But
// mma.sync reads both operands through registers: every warp reloads the
// streamed tile's B fragments for its own 16 rows (one ldmatrix.x4 per two
// mma.sync in s and dp, per four in the split products, whose hi and lo
// share it), and the exponentials (one per score forward and in the dK/dV
// pass, two in the dQ pass) run on the MUFU pipe, so the limit is
// shared-memory traffic, latency and MUFU, not the tensor cores.
// Next: wgmma, which reads B from shared memory once for a 64-row
// warpgroup.

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
template <int D>
__device__ __forceinline__ const float* row_of(const float* x, int b, int r, int h, int seq,
                                               int heads) {
  return x + (((long)b * seq + r) * heads + h) * D;
}

// Stage rows [r0, r0 + n) of head h of a and b ([B, S, H, D]) into shared
// memory as f32 (zeros past n); rows of `ROWS`.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const float* a, const float* b_, int b, int h, int seq,
                                          int heads, int r0, int n, float (*as)[D],
                                          float (*bs)[D]) {
  for (int idx = threadIdx.x; idx < ROWS * D / 4; idx += THREADS) {
    const int j = idx / (D / 4), c4 = idx % (D / 4);
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (j < n) {
      av = ld4(row_of<D>(a, b, r0 + j, h, seq, heads), c4);
      if (bs != nullptr) bv = ld4(row_of<D>(b_, b, r0 + j, h, seq, heads), c4);
    }
    reinterpret_cast<float4*>(&as[j][0])[c4] = av;
    if (bs != nullptr) reinterpret_cast<float4*>(&bs[j][0])[c4] = bv;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ out, float* __restrict__ lse, int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, QT = THREADS / TPQ;
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];
  const int part = threadIdx.x % TPQ;
  const int qi = blockIdx.x * QT + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_ok = qi < seq;
  const float* qrow = row_of<D>(q, b, q_ok ? qi : 0, h, seq, heads);
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
    load_tile<D, KT>(k, v, b, h, seq, heads, k0, nk, ks, vs);
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
    float* orow = out + (((long)b * seq + qi) * heads + h) * D;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
          float* __restrict__ dq_out, int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, QT = THREADS / TPQ;
  __shared__ __align__(16) float ks[KQ][D];
  __shared__ __align__(16) float vs[KQ][D];
  const int part = threadIdx.x % TPQ;
  const int qi = blockIdx.x * QT + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool q_ok = qi < seq;
  const float* qrow = row_of<D>(q, b, q_ok ? qi : 0, h, seq, heads);
  const float* grow = row_of<D>(dout, b, q_ok ? qi : 0, h, seq, heads);
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
    load_tile<D, KQ>(k, v, b, h, seq, heads, k0, nk, ks, vs);
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
    load_tile<D, KQ>(k, v, b, h, seq, heads, k0, nk, ks, vs);
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
    float* drow = dq_out + (((long)b * seq + qi) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < CH; ++c) st4(drow, c * TPQ + part, dq[c]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk_out, float* __restrict__ dv_out,
            int seq, int heads, float scale) {
  constexpr int TPQ = D / 32, KBLK = THREADS / TPQ;
  __shared__ __align__(16) float qs[QB][D];
  __shared__ __align__(16) float gs[QB][D];
  __shared__ float lses[QB], dls[QB];
  const int part = threadIdx.x % TPQ;
  const int kj = blockIdx.x * KBLK + threadIdx.x / TPQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool k_ok = kj < seq;
  const float* krow = row_of<D>(k, b, k_ok ? kj : 0, h, seq, heads);
  const float* vrow = row_of<D>(v, b, k_ok ? kj : 0, h, seq, heads);
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
    load_tile<D, QB>(q, dout, b, h, seq, heads, q0, nq, qs, gs);
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;    // threads per block
constexpr int ROWS = 16 * WARPS;  // the block's own rows: 16 per warp
constexpr int TILE = 64;          // rows of the streamed side per shared-memory tile

// One tile of TILE rows of one head, each row padded by 16 bytes so that
// ldmatrix's eight 16-byte rows fall in distinct banks.
template <int D>
struct Tile {
  bf16 r[TILE][D + 8];
};

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

// Rows [r0, r0 + TILE) of one head (src: its row 0; rows `stride` elements
// apart) into t; rows at or past `end` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(Tile<D>& t, const bf16* src, long stride, int r0,
                                          int end) {
#pragma unroll
  for (int it = 0; it < TILE * D / 8 / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r0 + r < end;
    cp16(&t.r[r][c], src + (ok ? (long)(r0 + r) * stride + c : 0), ok);
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
__device__ __forceinline__ unsigned pack(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<unsigned*>(&v);
}

// Two f32 as bf16 pairs hi = bf16(x), lo = bf16(x - hi): hi + lo carries x
// to within 2**-17 of itself (x - hi is exact in f32), and the tensor
// cores multiply each half exactly.
__device__ __forceinline__ void split(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack(x0, x1);
  lo = pack(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// Fragment addressing; lane = threadIdx.x & 31. In a C fragment a lane holds
// rows g = lane / 4 and g + 8, columns 2 (lane % 4) and + 1 of an 8-column
// n-tile; an A fragment is two n-tiles' C fragments side by side.
//
// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of t.
template <int D>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const Tile<D>& t, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm(a, &t.r[r0 + (lane & 15)][c0 + (lane >> 4) * 8]);
}

// The warp's own 16 rows of a tile as the A operand over the D columns:
// kept in registers (KEPT), or read from shared memory at each use where
// registers are short.
template <int D, bool KEPT>
struct Own {
  unsigned a[KEPT ? D / 16 : 1][4];
  const Tile<D>* t;

  __device__ __forceinline__ void init(const Tile<D>& tile) {
    t = &tile;
    if constexpr (KEPT) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) frag_a(a[kk], tile, 16 * (threadIdx.x >> 5), 16 * kk);
    }
  }

  // the A fragment of columns [16 kk, 16 kk + 16)
  __device__ __forceinline__ void get(unsigned (&f)[4], int kk) const {
    if constexpr (KEPT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = a[kk][i];
    } else {
      frag_a(f, *t, 16 * (threadIdx.x >> 5), 16 * kk);
    }
  }
};

// s[j] += a . t[n0 + 8j, n0 + 8j + 8)^T over the D columns, for the first
// `ntiles` of the NJ n-tiles (the B operand is t's rows: keys or queries).
template <int D, bool KEPT, int NJ>
__device__ __forceinline__ void rows_product(float (&s)[NJ][4], const Own<D, KEPT>& a,
                                             const Tile<D>& t, int n0, int ntiles) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < D / 32; ++h) {
    unsigned a0[4], a1[4];
    a.get(a0, 2 * h);
    a.get(a1, 2 * h + 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < ntiles) {
        unsigned b[4];
        ldsm(b, &t.r[n0 + 8 * j + (lane & 7)][32 * h + (lane >> 3) * 8]);
        mma(s[j], a0, b[0], b[1]);
        mma(s[j], a1, b[2], b[3]);
      }
    }
  }
}

// acc[n] = acc[n] * mul + (hi + lo) . t[k0, k0 + 16 NK)[8n, 8n + 8) for the
// D / 8 n-tiles of the columns (the B operand is t's columns, summed over
// its rows; mul per row: g, then g + 8). The A operand is an f32 matrix
// split into bf16 hi and lo fragments; both products of each n-tile go into
// one fresh f32 fragment, which is then added to acc in f32 (a chain of
// every step's products inside the mma would not round as f32 adds do).
template <int D, int NK>
__device__ __forceinline__ void split_product(float (&acc)[D / 8][4], const unsigned (&hi)[NK][4],
                                              const unsigned (&lo)[NK][4], const Tile<D>& t,
                                              int k0, const float (&mul)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float f0[4] = {}, f1[4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      unsigned b[4];
      ldsm_t(b, &t.r[k0 + 16 * kk + (lane & 15)][16 * n + (lane >> 4) * 8]);
      mma(f0, hi[kk], b[0], b[1]);
      mma(f0, lo[kk], b[0], b[1]);
      mma(f1, hi[kk], b[2], b[3]);
      mma(f1, lo[kk], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * n][e] = fmaf(acc[2 * n][e], mul[e >> 1], f0[e]);
      acc[2 * n + 1][e] = fmaf(acc[2 * n + 1][e], mul[e >> 1], f1[e]);
    }
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

// Rows g and g + 8 of a warp's [16, D] accumulator, rounded to bf16, at dst
// + row * stride for the rows below `end` (row0: the warp's first row).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long stride, const float (&acc)[D / 8][4],
                                           int row0, int end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + g + 8 * r >= end) continue;
    unsigned* row = reinterpret_cast<unsigned*>(dst + (long)(row0 + g + 8 * r) * stride + c);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      row[4 * n] = pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// 1 / sqrt(D) rounded once to f32, as the TPU kernel's Python float
// sm_scale is when it multiplies an f32 array
inline float scale_of(int d) { return static_cast<float>(1.0 / sqrt(static_cast<double>(d))); }

template <int D>
constexpr int fwd_smem() {
  return 4 * sizeof(Tile<D>);
}

template <int D>
__global__ void __launch_bounds__(NT)
fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int seq, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char shm[];
  Tile<D>* ring = reinterpret_cast<Tile<D>*>(shm);  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long stride = (long)heads * D;
  const long head0 = (long)b * seq * stride + (long)h * D;  // row 0 of the head
  const int wq = q0 + 16 * warp;  // the warp's first query
  const bool active = wq < seq;   // uniform over the warp
  const int nkt = (seq + TILE - 1) / TILE;

  // the block's queries (staged in ring[3]) and the first K/V tile
  load_tile(ring[3], q + head0, stride, q0, seq);
  load_tile(ring[0], k + head0, stride, 0, seq);
  load_tile(ring[2], v + head0, stride, 0, seq);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  Own<D, true> qa;  // q, the A operand of s
  qa.init(ring[3]);
  __syncthreads();

  // online softmax over 32-key steps: running max m, sum l and o, rescaled
  // by exp(m_old - m_new) when the max moves
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < nkt; ++t) {
    if (t + 1 < nkt) {
      const int buf = (t + 1) & 1;
      load_tile(ring[buf], k + head0, stride, (t + 1) * TILE, seq);
      load_tile(ring[2 + buf], v + head0, stride, (t + 1) * TILE, seq);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (active) {
      const Tile<D>& kt = ring[t & 1];
      const Tile<D>& vt = ring[2 + (t & 1)];
#pragma unroll
      for (int sub = 0; sub < TILE / 32; ++sub) {
        const int kc = t * TILE + 32 * sub;
        if (kc >= seq) break;
        float s[4][4] = {};
        rows_product(s, qa, kt, 32 * sub, min(4, (seq - kc + 7) / 8));
        const bool edge = kc + 32 > seq;  // the last step: keys past S at -inf
        float mt[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = edge && kc + 8 * j + c + (e & 1) >= seq ? -INFINITY : s[j][e] * scale;
            mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = quad_max(mt[r]);
          alpha[r] = expf(m[r] - mt[r]);  // 0 on the first step
          l[r] *= alpha[r];
          m[r] = mt[r];
        }
        unsigned ph[2][4], pl[2][4];  // p = exp(s - m) as bf16 hi + lo, the A operand of o
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = expf(s[j][2 * r] - m[r]), p1 = expf(s[j][2 * r + 1] - m[r]);
            l[r] += p0;
            l[r] += p1;
            split(p0, p1, ph[j >> 1][2 * (j & 1) + r], pl[j >> 1][2 * (j & 1) + r]);
          }
        split_product(o, ph, pl, vt, 32 * sub, alpha);
      }
    }
    __syncthreads();
  }

  if (!active) return;
  // out = bf16(o / l): divided, then rounded once; lse = m + ln(l) in f32
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq + g + 8 * r;
    l[r] = quad_sum(l[r]);
    if (row >= seq) continue;
    unsigned* dst = reinterpret_cast<unsigned*>(out + head0 + row * stride + c);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dst[4 * n] = pack(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    if (c == 0) lse[((long)b * heads + h) * seq + row] = m[r] + logf(l[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
       bf16* __restrict__ dq_out, int seq, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char shm[];
  Tile<D>* ring = reinterpret_cast<Tile<D>*>(shm);  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long stride = (long)heads * D;
  const long head0 = (long)b * seq * stride + (long)h * D;
  const int wq = q0 + 16 * warp;
  const bool active = wq < seq;
  const int nkt = (seq + TILE - 1) / TILE, steps = 2 * nkt;
  const long stat0 = ((long)b * heads + h) * seq;

  // the block's queries and cotangents (staged in ring[1], ring[3]) and the
  // first K/V tile
  load_tile(ring[1], q + head0, stride, q0, seq);
  load_tile(ring[3], dout + head0, stride, q0, seq);
  load_tile(ring[0], k + head0, stride, 0, seq);
  load_tile(ring[2], v + head0, stride, 0, seq);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  Own<D, true> qa, ga;  // q and dO, the A operands of s and dp
  qa.init(ring[1]);
  ga.init(ring[3]);
  __syncthreads();

  const int rows[2] = {wq + g, wq + g + 8};
  float lr[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) lr[r] = rows[r] < seq ? lse[stat0 + rows[r]] : INFINITY;
  float dq[D / 8][4] = {};
  const float one[2] = {1.f, 1.f};

  // steps [0, nkt): delta = rowsum(p * dp); [nkt, 2 nkt): dq += ds k
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      const int k1 = ((t + 1) % nkt) * TILE, buf = (t + 1) & 1;
      load_tile(ring[buf], k + head0, stride, k1, seq);
      load_tile(ring[2 + buf], v + head0, stride, k1, seq);
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
      const Tile<D>& kt = ring[t & 1];
      const Tile<D>& vt = ring[2 + (t & 1)];
      const int k0 = (t % nkt) * TILE;
#pragma unroll
      for (int sub = 0; sub < TILE / 32; ++sub) {
        const int kc = k0 + 32 * sub;
        if (kc >= seq) break;
        const int ntiles = min(4, (seq - kc + 7) / 8);
        float p[4][4] = {}, dp[4][4] = {};
        rows_product(p, qa, kt, 32 * sub, ntiles);
        rows_product(dp, ga, vt, 32 * sub, ntiles);
        const bool edge = kc + 32 > seq;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = expf(p[j][e] * scale - lr[e >> 1]);
            p[j][e] = edge && kc + 8 * j + c + (e & 1) >= seq ? 0.f : pe;
          }
        if (!second) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dl[e >> 1] = fmaf(p[j][e], dp[j][e], dl[e >> 1]);
        } else {
          unsigned dh[2][4], dlo[2][4];  // ds = p (dp - delta) scale as bf16 hi + lo
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              split(p[j][2 * r] * (dp[j][2 * r] - dl[r]) * scale,
                    p[j][2 * r + 1] * (dp[j][2 * r + 1] - dl[r]) * scale,
                    dh[j >> 1][2 * (j & 1) + r], dlo[j >> 1][2 * (j & 1) + r]);
          split_product(dq, dh, dlo, kt, 32 * sub, one);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  store_rows<D>(dq_out + head0, stride, dq, wq, seq);
}

template <int D>
constexpr int dkdv_smem() {
  return 6 * sizeof(Tile<D>) + 4 * TILE * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dout, const float* __restrict__ lse,
         const float* __restrict__ delta, bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
         int seq, int heads, float scale) {
  // D 64: the warp's k and v rows stay in registers; D 128: dk and dv alone
  // take 128 registers a thread, so k and v are read from shared memory
  constexpr bool KEPT = D <= 64;
  extern __shared__ __align__(128) unsigned char shm[];
  Tile<D>* qt = reinterpret_cast<Tile<D>*>(shm);  // q tiles (ring of 2)
  Tile<D>* gt = qt + 2;                           // dO tiles (ring of 2)
  Tile<D>* own = qt + 4;                          // the block's keys and values
  float(*ls)[TILE] = reinterpret_cast<float(*)[TILE]>(qt + 6);  // lse of the tile (ring)
  float(*ds)[TILE] = ls + 2;                                    // delta of the tile (ring)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 2 * (lane & 3);
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const long stride = (long)heads * D;
  const long head0 = (long)b * seq * stride + (long)h * D;
  const long stat0 = ((long)b * heads + h) * seq;
  const int wk = k0 + 16 * warp;  // the warp's first key
  const bool active = wk < seq;
  const int nqt = (seq + TILE - 1) / TILE;

  // the block's keys and values, then the first query tile and its
  // statistics
  load_tile(own[0], k + head0, stride, k0, seq);
  load_tile(own[1], v + head0, stride, k0, seq);
  load_tile(qt[0], q + head0, stride, 0, seq);
  load_tile(gt[0], dout + head0, stride, 0, seq);
  cp_commit();
  if (threadIdx.x < TILE) {  // queries past S: lse +inf, so p = 0
    const int i = threadIdx.x;
    ls[0][i] = i < seq ? lse[stat0 + i] : INFINITY;
    ds[0][i] = i < seq ? delta[stat0 + i] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  Own<D, KEPT> ka, va;  // k and v, the A operands of s^T and dp^T
  ka.init(own[0]);
  va.init(own[1]);

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const float one[2] = {1.f, 1.f};
  for (int t = 0; t < nqt; ++t) {
    const int nbuf = (t + 1) & 1;
    float nl = INFINITY, nd = 0.f;  // the next tile's statistics
    if (t + 1 < nqt) {
      const int q1 = (t + 1) * TILE;
      load_tile(qt[nbuf], q + head0, stride, q1, seq);
      load_tile(gt[nbuf], dout + head0, stride, q1, seq);
      if (threadIdx.x < TILE && q1 + threadIdx.x < seq) {
        nl = lse[stat0 + q1 + threadIdx.x];
        nd = delta[stat0 + q1 + threadIdx.x];
      }
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int buf = t & 1;
    if (active) {
#pragma unroll
      for (int sub = 0; sub < TILE / 16; ++sub) {
        const int qi = 16 * sub;  // the step's first query in the tile
        if (t * TILE + qi >= seq) break;
        float s[2][4] = {}, dp[2][4] = {};
        rows_product(s, ka, qt[buf], qi, 2);
        rows_product(dp, va, gt[buf], qi, 2);
        // p^T and ds^T as bf16 hi + lo, the A operands of dv and dk
        unsigned ph[1][4], pl[1][4], dh[1][4], dlo[1][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(&ls[buf][qi + 8 * j + c]);
          const float2 dj = *reinterpret_cast<const float2*>(&ds[buf][qi + 8 * j + c]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = expf(s[j][2 * r] * scale - lj.x);
            const float p1 = expf(s[j][2 * r + 1] * scale - lj.y);
            split(p0, p1, ph[0][2 * j + r], pl[0][2 * j + r]);
            split(p0 * (dp[j][2 * r] - dj.x) * scale, p1 * (dp[j][2 * r + 1] - dj.y) * scale,
                  dh[0][2 * j + r], dlo[0][2 * j + r]);
          }
        }
        split_product(dv, ph, pl, gt[buf], qi, one);
        split_product(dk, dh, dlo, qt[buf], qi, one);
      }
    }
    if (threadIdx.x < TILE && t + 1 < nqt) {
      ls[nbuf][threadIdx.x] = nl;
      ds[nbuf][threadIdx.x] = nd;
    }
    __syncthreads();
  }

  if (!active) return;
  store_rows<D>(dk_out + head0, stride, dk, wk, seq);
  store_rows<D>(dv_out + head0, stride, dv, wk, seq);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
               int batch, int seq, int heads, cudaStream_t s) {
  constexpr int QT = THREADS / (D / 32);
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fa_fwd<D><<<grid, THREADS, 0, s>>>(q, k, v, out, lse, seq, heads, 1.f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, float* delta, float* dq, float* dk, float* dv, int batch,
               int seq, int heads, cudaStream_t s) {
  constexpr int QT = THREADS / (D / 32);
  const float scale = 1.f / sqrtf((float)D);
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fa_bwd_dq<D><<<grid, THREADS, 0, s>>>(q, k, v, dout, lse, delta, dq, seq, heads, scale);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dkdv<D><<<grid, THREADS, 0, s>>>(q, k, v, dout, lse, delta, dk, dv, seq, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's dynamic shared memory above the default 48 KB needs the
// function's attribute raised first.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int batch,
               int seq, int heads, cudaStream_t s) {
  constexpr int smem = tc::fwd_smem<D>();
  if (int err = allow_smem(tc::fwd<D>, smem)) return err;
  dim3 grid((seq + tc::ROWS - 1) / tc::ROWS, heads, batch);
  tc::fwd<D><<<grid, tc::NT, smem, s>>>(q, k, v, out, lse, seq, heads, tc::scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
               float* delta, bf16* dq, bf16* dk, bf16* dv, int batch, int seq, int heads,
               cudaStream_t s) {
  constexpr int smem_dq = tc::fwd_smem<D>(), smem_dkdv = tc::dkdv_smem<D>();
  const float scale = tc::scale_of(D);
  dim3 grid((seq + tc::ROWS - 1) / tc::ROWS, heads, batch);
  if (int err = allow_smem(tc::bwd_dq<D>, smem_dq)) return err;
  tc::bwd_dq<D><<<grid, tc::NT, smem_dq, s>>>(q, k, v, dout, lse, delta, dq, seq, heads, scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = allow_smem(tc::bwd_dkdv<D>, smem_dkdv)) return err;
  tc::bwd_dkdv<D><<<grid, tc::NT, smem_dkdv, s>>>(q, k, v, dout, lse, delta, dk, dv, seq, heads,
                                                  scale);
  return static_cast<int>(cudaGetLastError());
}

// Both flavours at head dim d (64 or 128; cudaErrorInvalidValue otherwise).
template <typename T>
int launch_fwd_d(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                 int seq, int heads, int d, void* stream) {
  auto* qt = static_cast<const T*>(q);
  auto* kt = static_cast<const T*>(k);
  auto* vt = static_cast<const T*>(v);
  auto* ot = static_cast<T*>(out);
  auto* lt = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(qt, kt, vt, ot, lt, batch, seq, heads, s);
  if (d == 128) return launch_fwd<128>(qt, kt, vt, ot, lt, batch, seq, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_bwd_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 void* delta, void* dq, void* dk, void* dv, int batch, int seq, int heads, int d,
                 void* stream) {
  auto* qt = static_cast<const T*>(q);
  auto* kt = static_cast<const T*>(k);
  auto* vt = static_cast<const T*>(v);
  auto* gt = static_cast<const T*>(dout);
  auto* lt = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto *dqt = static_cast<T*>(dq), *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd<64>(qt, kt, vt, gt, lt, dl, dqt, dkt, dvt, batch, seq, heads, s);
  if (d == 128)
    return launch_bwd<128>(qt, kt, vt, gt, lt, dl, dqt, dkt, dvt, batch, seq, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, out [batch, seq, heads, d] of one type (bf16 != 0: bfloat16, else
// float32), lse [batch, heads, seq] f32; all contiguous, 16-byte aligned.
// d is 64 or 128 (cudaErrorInvalidValue otherwise). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int batch, int seq, int heads, int d, int bf16_io,
                                   void* stream) {
  return bf16_io ? launch_fwd_d<bf16>(q, k, v, out, lse, batch, seq, heads, d, stream)
                 : launch_fwd_d<float>(q, k, v, out, lse, batch, seq, heads, d, stream);
}

// The backward from q, k, v, the output's cotangent dout and the forward's
// lse; delta [batch, heads, seq] f32 scratch; dq, dk, dv in the IO type.
// Two launches on one stream: dQ (which writes delta), then dK/dV.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int batch, int seq, int heads, int d, int bf16_io,
                                   void* stream) {
  return bf16_io ? launch_bwd_d<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, heads,
                                      d, stream)
                 : launch_bwd_d<float>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, heads,
                                       d, stream);
}
