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
// f32: at the denoiser's shapes (S 520, D 64) the forward is 4*S*S*D flops
// per (sequence, head) and the backward 14*S*S*D (7 product units of
// 2*S*S*D: s, dp and dq in the dQ pass, s^T, dp^T, dv and dk in the dK/dV
// pass), against a few reads of the [B*S, 3W] qkv: both are compute-bound.
// One (sequence, head)'s K and V in f32 are 2*520*64*4 = 266 KB, above the
// 227 KB of shared memory a block can hold, so every kernel streams tiles of
// the other side through shared memory.
// Both run on the tensor cores in 3xTF32: every f32 operand split into tf32
// hi + lo and each product a_lo b_hi + a_hi b_lo + a_hi b_hi on
// mma.sync.m16n8k8, ~2**-21 of the f32 product at 495 / 3 TFLOP/s
// (tf32_mma.cuh holds the building blocks and the design, which the f32
// flash attention shares: warps of 16 own rows, raw in shared memory and
// split per 8-column slab; the other side through a two-stage cp.async ring
// of 16-row tiles split once by the block; a fresh f32 fragment per step;
// tests/test_torch_attention_tf32.py transcribes the arithmetic on the CPU
// against the Pallas kernel). Scores stay base 2: c2 = scale * log2(e) is
// folded into an operand of s before the split.
//   * forward (tf::fwd): the flash-attention forward tf::fwd of
//     csrc/flash_attention.cu on the grouped qkv columns: own rows q (times
//     c2), the keys [0, valid_len) and their values streamed once (the last
//     tile's rows past valid_len zero-filled, its scores -inf; no padding of
//     S), an online softmax in f32 with exp2 (running max m, sum l, o
//     rescaled by exp2(m_old - m_new)), p split in registers as the A
//     operand of p v; out = o / l, lse = m + log2(l). Bound: 4*S*valid*D
//     flops a (sequence, head), 2.19 GFLOP at the sampler's batch 2 and
//     34.96 at the f32 stage-2 step's batch 32 (S 520, valid 513, 16 heads):
//     0.0326 and 0.522 ms at the 67 TFLOP/s of exact f32 on the CUDA cores
//     (the design this replaced), 0.0133 and 0.212 ms at 495 / 3.
//     4 warps a block, 64 own rows (288 blocks at batch 2, under one wave):
//     0.0823 ms at batch 2 and 0.8790 at batch 32, where a 2-warp block (32
//     rows, 544 blocks, each splitting every K/V tile for half the rows)
//     ran 0.0934 and 1.0249 (H100 at 700 W, chip_smoke.py phases 3 and 4).
//   * backward (tf::bwd_dq, tf::bwd_dkdv): p = exp2(s - lse) with the
//     forward's base-2 lse. Shared memory 70 KB a block (three an SM); the
//     grid is (row tile, head, sequence), 4,608 blocks at batch 32 x 16
//     heads x 520 tokens.
//     - dQ: own rows q (times c2) and dO, the keys [0, valid_len) streamed
//       once with their values: delta = rowsum(dO * O) from the saved output
//       (the same number as the TPU kernel's rowsum(P * dP), without a
//       second sweep), written for the dK/dV pass; s = (q c2) k^T, dp = dO
//       v^T, p = exp2(s - lse) (0 at keys >= valid_len), ds = p (dp -
//       delta), dq += ds k, times scale once at the end.
//     - dK/dV: own rows k (times c2: q's split tile also feeds dk
//       unscaled) and v, every query of the sequence streamed with dO, lse
//       and delta (pad queries included; queries past S lse +inf): s^T =
//       (k c2) q^T, dp^T = v dO^T, dv += p^T dO, dk += ds^T q, dk times
//       scale at the end. Blocks of pad keys only write zeros.
//     What bounds it: not the tensor cores (its 7 units x 3 products take
//     0.74 ms of the TF32 peak at batch 32 x 16 heads, the function's 5
//     units 0.53 ms) but issuing and feeding mma.sync, as in the f32 flash
//     attention backward (csrc/flash_attention.cu).
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

#include "tf32_mma.cuh"

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
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;   // threads per block
constexpr int ROWS = 16 * WARPS; // the block's own rows: 16 per warp
constexpr int TILE = 64;         // rows of the streamed side per shared-memory tile
constexpr int LD = D + 8;        // padded row (144 bytes): ldmatrix without bank conflicts

typedef bf16 Tile[TILE][LD];

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
// f32: tensor cores, 3xTF32 (mma.sync m16n8k8 tf32, cp.async; the building
// blocks in tf32_mma.cuh)
// ---------------------------------------------------------------------------

namespace tf {

constexpr int TILE = tile_rows<D>(), TILE_N = TILE / 8;

// shared memory of the forward: the block's queries and a ring of 2 x 2
// split K/V tiles
constexpr int fwd_smem = sizeof(Own<D>) + 4 * sizeof(Split<D>);

__global__ void __launch_bounds__(NT, min_blocks<D>())
fwd(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lse, int seq,
    int heads, int groups, int valid_len, float c2) {
  extern __shared__ __align__(128) unsigned char shm[];
  Own<D>* own = reinterpret_cast<Own<D>*>(shm);           // the block's q (times c2)
  Split<D>* ring = reinterpret_cast<Split<D>*>(own + 1);  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);
  const float* qsrc = l.base + l.col;
  const int wq = 16 * warp;  // the warp's first row in own
  const bool active = q0 + wq < seq;
  const int nkt = (valid_len + TILE - 1) / TILE;

  load_rows<D, ROWS>(own, qsrc, l.row_stride, q0, seq);
  load_rows<D, TILE>(ring[0].hi, qsrc + l.wg, l.row_stride, 0, valid_len);
  load_rows<D, TILE>(ring[2].hi, qsrc + 2 * l.wg, l.row_stride, 0, valid_len);
  cp_commit();

  // online softmax in base 2 over one tile of keys a step: running max m,
  // sum l and o, rescaled by exp2(m_old - m_new) when the max moves
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f};
  for (int t = 0; t < nkt; ++t) {
    if (t + 1 < nkt) {
      const int k1 = (t + 1) * TILE, buf = (t + 1) & 1;
      load_rows<D, TILE>(ring[buf].hi, qsrc + l.wg, l.row_stride, k1, valid_len);
      load_rows<D, TILE>(ring[2 + buf].hi, qsrc + 2 * l.wg, l.row_stride, k1, valid_len);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (t == 0) scale_rows(*own, c2);
    Split<D>& kt = ring[t & 1];
    Split<D>& vt = ring[2 + (t & 1)];
    split_tile(kt);
    split_tile(vt);
    __syncthreads();
    if (active) {
      const int kc = t * TILE;
      float s[TILE_N][4];
      rows_product(s, *own, wq, kt, 0);
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < TILE_N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // keys at or past valid_len: -inf, so p = 0
          s[j][e] = kc + 8 * j + c + (e & 1) < valid_len ? s[j][e] : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);  // finite: key 0 is valid
        alpha[r] = exp2f(m[r] - mt[r]);  // 0 on the first step
        ls[r] *= alpha[r];
        m[r] = mt[r];
      }
#pragma unroll
      for (int j = 0; j < TILE_N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // p = exp2(s - m), the A operand of o
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          ls[e >> 1] += s[j][e];
        }
      split_product(o, s, vt, 0, alpha[0], alpha[1]);
    }
    __syncthreads();
  }

  if (!active) return;
  // out = o / l (divided, not multiplied by 1 / l); lse = m + log2(l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] = quad_sum(ls[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][2 * r] /= ls[r];
      o[n][2 * r + 1] /= ls[r];
    }
    const int row = q0 + wq + g + 8 * r;
    if (lse != nullptr && c == 0 && row < seq)
      lse[((long)b * heads + h) * seq + row] = m[r] + log2f(ls[r]);
  }
  store_rows<D>(out + (long)b * seq * l.w + h * D, l.w, o, q0 + wq, seq);
}

// shared memory: the block's own two row sets and a ring of 2 x 2 split
// tiles (and, in the dK/dV pass, the tiles' lse and delta)
constexpr int dq_smem = 2 * sizeof(Own<D>) + 4 * sizeof(Split<D>);
constexpr int dkdv_smem = dq_smem + 4 * TILE * sizeof(float);

__global__ void __launch_bounds__(NT, min_blocks<D>())
bwd_dq(const float* __restrict__ qkv, const float* __restrict__ out,
       const float* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
       float* __restrict__ dqkv, int seq, int heads, int groups, int valid_len, float c2,
       float scale) {
  extern __shared__ __align__(128) unsigned char shm[];
  Own<D>* own = reinterpret_cast<Own<D>*>(shm);           // the block's q (times c2) and dO
  Split<D>* ring = reinterpret_cast<Split<D>*>(own + 2);  // K tiles in 0-1, V tiles in 2-3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, u = lane & 3, c = 2 * u;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);
  const float* qsrc = l.base + l.col;
  const long grow0 = (long)b * seq * l.w + h * D;  // the head's row 0 in out and dout
  const int wq = 16 * warp;  // the warp's first row in own
  const bool active = q0 + wq < seq;
  const int nkt = (valid_len + TILE - 1) / TILE;
  const long stat0 = ((long)b * heads + h) * seq;

  load_rows<D, ROWS>(&own[0], qsrc, l.row_stride, q0, seq);
  load_rows<D, ROWS>(&own[1], dout + grow0, l.w, q0, seq);
  load_rows<D, TILE>(ring[0].hi, qsrc + l.wg, l.row_stride, 0, valid_len);
  load_rows<D, TILE>(ring[2].hi, qsrc + 2 * l.wg, l.row_stride, 0, valid_len);
  cp_commit();

  // delta = rowsum(dO * O) in f32 while the copies land: each row's four
  // lanes take 16 columns each (float4 chunks u, u + 4, ...), then sum
  const int rows[2] = {q0 + wq + g, q0 + wq + g + 8};
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float acc = 0.f;
    if (rows[r] < seq) {
      const float4* go = reinterpret_cast<const float4*>(dout + grow0 + (long)rows[r] * l.w);
      const float4* oo = reinterpret_cast<const float4*>(out + grow0 + (long)rows[r] * l.w);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const float4 a = go[u + 4 * i], o = oo[u + 4 * i];
        acc = fmaf(a.x, o.x, acc);
        acc = fmaf(a.y, o.y, acc);
        acc = fmaf(a.z, o.z, acc);
        acc = fmaf(a.w, o.w, acc);
      }
    }
    dl[r] = quad_sum(acc);
    lr[r] = rows[r] < seq ? lse[stat0 + rows[r]] : INFINITY;  // rows past S: p = 0
    if (u == 0 && rows[r] < seq) delta[stat0 + rows[r]] = dl[r];
  }

  // one tile of keys a step: s = (q c2) k^T (base 2), dp = dO v^T, p =
  // exp2(s - lse), ds = p (dp - delta), dq += ds k
  float dq[D / 8][4] = {};
  for (int t = 0; t < nkt; ++t) {
    if (t + 1 < nkt) {
      const int k1 = (t + 1) * TILE, buf = (t + 1) & 1;
      load_rows<D, TILE>(ring[buf].hi, qsrc + l.wg, l.row_stride, k1, valid_len);
      load_rows<D, TILE>(ring[2 + buf].hi, qsrc + 2 * l.wg, l.row_stride, k1, valid_len);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (t == 0) scale_rows(own[0], c2);
    Split<D>& kt = ring[t & 1];
    Split<D>& vt = ring[2 + (t & 1)];
    split_tile(kt);
    split_tile(vt);
    __syncthreads();
    if (active) {
      const int kc = t * TILE;
      float p[TILE_N][4], dp[TILE_N][4];
      rows_product(p, own[0], wq, kt, 0);
      rows_product(dp, own[1], wq, vt, 0);
#pragma unroll
      for (int j = 0; j < TILE_N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // keys at or past valid_len: p = 0
          const float pe = exp2f(p[j][e] - lr[e >> 1]);
          p[j][e] = (kc + 8 * j + c + (e & 1) < valid_len ? pe : 0.f) * (dp[j][e] - dl[e >> 1]);
        }
      split_product(dq, p, kt, 0);
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] *= scale;
  store_rows<D>(dqkv + (long)b * seq * l.row_stride + l.col, l.row_stride, dq, q0 + wq, seq);
}

__global__ void __launch_bounds__(NT, min_blocks<D>())
bwd_dkdv(const float* __restrict__ qkv, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dqkv, int seq, int heads, int groups, int valid_len, float c2,
         float scale) {
  extern __shared__ __align__(128) unsigned char shm[];
  Own<D>* own = reinterpret_cast<Own<D>*>(shm);         // the block's k (times c2) and v
  Split<D>* qt = reinterpret_cast<Split<D>*>(own + 2);  // q tiles (ring of 2)
  Split<D>* gt = qt + 2;                                // dO tiles (ring of 2)
  float(*ls)[TILE] = reinterpret_cast<float(*)[TILE]>(qt + 4);  // lse of the tile (ring)
  float(*ds)[TILE] = ls + 2;                                    // delta of the tile (ring)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const Layout<float> l = layout(qkv, b, h, seq, heads, groups);
  const float* qsrc = l.base + l.col;
  const float* gsrc = dout + (long)b * seq * l.w + h * D;
  float* dk_dst = dqkv + (long)b * seq * l.row_stride + l.col + l.wg;  // dv at + wg
  const long stat0 = ((long)b * heads + h) * seq;

  if (k0 >= valid_len) {  // pad keys only: dk = dv = 0 (uniform over the block)
    for (int i = threadIdx.x; i < ROWS * D / 2; i += NT) {
      const int r = i / (D / 2), c4 = i % (D / 2);  // dk then dv: 2 D columns a row
      if (k0 + r < seq)
        *reinterpret_cast<float4*>(dk_dst + (long)(k0 + r) * l.row_stride + (c4 % (D / 4)) * 4 +
                                   (c4 / (D / 4)) * l.wg) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int wk = 16 * warp;  // the warp's first row in own
  const bool active = k0 + wk < valid_len;
  const int nqt = (seq + TILE - 1) / TILE;

  load_rows<D, ROWS>(&own[0], qsrc + l.wg, l.row_stride, k0, valid_len);
  load_rows<D, ROWS>(&own[1], qsrc + 2 * l.wg, l.row_stride, k0, valid_len);
  load_rows<D, TILE>(qt[0].hi, qsrc, l.row_stride, 0, seq);
  load_rows<D, TILE>(gt[0].hi, gsrc, l.w, 0, seq);
  cp_commit();
  if (threadIdx.x < TILE) {  // queries past S: lse +inf, so p = ds = 0
    const int i = threadIdx.x;
    ls[0][i] = i < seq ? lse[stat0 + i] : INFINITY;
    ds[0][i] = i < seq ? delta[stat0 + i] : 0.f;
  }

  // one tile of queries a step, every query of the sequence (pad queries
  // included): s^T = (k c2) q^T (base 2; q's split tile also feeds dk, so
  // the scale goes into k), dp^T = v dO^T, then dv += p^T dO and dk +=
  // ds^T q
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int t = 0; t < nqt; ++t) {
    const int nbuf = (t + 1) & 1;
    float nl = INFINITY, nd = 0.f;  // the next tile's statistics
    if (t + 1 < nqt) {
      const int q1 = (t + 1) * TILE;
      load_rows<D, TILE>(qt[nbuf].hi, qsrc, l.row_stride, q1, seq);
      load_rows<D, TILE>(gt[nbuf].hi, gsrc, l.w, q1, seq);
      if (threadIdx.x < TILE && q1 + threadIdx.x < seq) {
        nl = lse[stat0 + q1 + threadIdx.x];
        nd = delta[stat0 + q1 + threadIdx.x];
      }
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (t == 0) scale_rows(own[0], c2);
    const int buf = t & 1;
    split_tile(qt[buf]);
    split_tile(gt[buf]);
    __syncthreads();
    if (active) {
      float s[TILE_N][4], dp[TILE_N][4];
      rows_product(s, own[0], wk, qt[buf], 0);
      rows_product(dp, own[1], wk, gt[buf], 0);
      // p^T and ds^T, the A operands of dv and dk
#pragma unroll
      for (int j = 0; j < TILE_N; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(&ls[buf][8 * j + c]);
        const float2 dj = *reinterpret_cast<const float2*>(&ds[buf][8 * j + c]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2f(s[j][2 * r] - lj.x), p1 = exp2f(s[j][2 * r + 1] - lj.y);
          dp[j][2 * r] = p0 * (dp[j][2 * r] - dj.x);
          dp[j][2 * r + 1] = p1 * (dp[j][2 * r + 1] - dj.y);
          s[j][2 * r] = p0;
          s[j][2 * r + 1] = p1;
        }
      }
      split_product(dv, s, gt[buf], 0);
      split_product(dk, dp, qt[buf], 0);
    }
    if (threadIdx.x < TILE && t + 1 < nqt) {
      ls[nbuf][threadIdx.x] = nl;
      ds[nbuf][threadIdx.x] = nd;
    }
    __syncthreads();
  }

  // dk = scale ds^T q; the rows of pad keys (at or past valid_len, also in
  // warps that computed nothing) exactly 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool real = k0 + wk + g + 8 * r < valid_len;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        dk[n][e] = real ? dk[n][e] * scale : 0.f;
        dv[n][e] = real ? dv[n][e] : 0.f;
      }
  }
  store_rows<D>(dk_dst, l.row_stride, dk, k0 + wk, seq);
  store_rows<D>(dk_dst + l.wg, l.row_stride, dv, k0 + wk, seq);
}

}  // namespace tf

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int launch_fwd(const float* qkv, float* out, float* lse, int batch, int seq, int heads,
               int groups, int valid_len, float scale_log2, cudaStream_t s) {
  dim3 grid((seq + tf::ROWS - 1) / tf::ROWS, heads, batch);
  if (int err = allow_smem(tf::fwd, tf::fwd_smem)) return err;
  tf::fwd<<<grid, tf::NT, tf::fwd_smem, s>>>(qkv, out, lse, seq, heads, groups, valid_len,
                                             scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const float* qkv, const float* out, const float* dout, const float* lse,
               float* delta, float* dqkv, int batch, int seq, int heads, int groups,
               int valid_len, float scale_log2, float scale, cudaStream_t s) {
  dim3 grid((seq + tf::ROWS - 1) / tf::ROWS, heads, batch);
  if (int err = allow_smem(tf::bwd_dq, tf::dq_smem)) return err;
  tf::bwd_dq<<<grid, tf::NT, tf::dq_smem, s>>>(qkv, out, dout, lse, delta, dqkv, seq, heads,
                                               groups, valid_len, scale_log2, scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = allow_smem(tf::bwd_dkdv, tf::dkdv_smem)) return err;
  tf::bwd_dkdv<<<grid, tf::NT, tf::dkdv_smem, s>>>(qkv, dout, lse, delta, dqkv, seq, heads,
                                                   groups, valid_len, scale_log2, scale);
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
