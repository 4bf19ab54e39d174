// Posenc-fused aggregation MLP with the k-neighbour weighted sum, forward
// (K6f) and backward (K6b, below), for Hopper (sm_90a), in two flavours: f32,
// and bf16 features and weights (T = __nv_bfloat16) with npcd_tpu's bf16
// rounding points. Every kernel runs its products on the tensor cores: the
// f32 forward and backward in 3xTF32 (tf::mlp_posenc_wsum and
// tf::mlp_posenc_wsum_bwd, below; the backward's recompute of the hidden
// layers in exact f32), the bf16 ones in bf16 on mma.sync.m16n8k16
// (tc::mlp_posenc_wsum and tc::mlp_posenc_wsum_bwd, below, built from the
// layer routines of csrc/bf16_mlp.cuh, which K7f and K7b share). Each
// backward recomputes its own forward from the inputs; the bf16 forward's
// hidden layers are the bf16 backward's recompute (tc::layer_bf16), so the
// two give bitwise the same activations.
//
// Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp_posenc_wsum
// (_posenc_impl_fwd -> _fwd_posenc_kernel with reduce_k). Per
// (shading point, neighbour) pair m of instance i it builds the layer-1 input
//   [feat_t[i, :, m] | x | sin_0(x_0)..sin_{n-1}(x_0) cos_0(x_0)..cos_{n-1}(x_0) | ...x_1 | ...x_2]
// with x = pos_t[i, 0:3, m] (the dim-major order of
// models/pointnerf/nn_core.positional_encoding, so W1 is used as the params
// store it, with no row permutation), runs the MLP stack
//   d1 -> 256 -> ... -> 256, leaky_relu(0.01) after every layer but the last,
// and writes out[i, n, :] = sum_j w[n*k + j] * mlp(pair n*k + j) with the
// pair weight w = pos_t[i, 3, m]. The encoding takes each of
// nn_core.positional_encoding's methods through `anchor`: octave j is
// evaluated directly, sin/cos(fl(2^j c0 x)), where j is a multiple of
// anchor, and by the double-angle recurrence s' = 2sc, c' = 2c^2 - 1 in
// between: 'anchored' is anchor 5, 'recurrence' anchor n_freqs (octave 0
// alone direct) and 'direct' anchor 1 (every octave; c0 = fl(fm pi) with
// fm and pi rounded to f32 first, the plain version's fl(fl(fm 2^j) pi) /
// 2^j, so each argument rounds as its fl(x fl(fl(fm 2^j) pi)) does). sinf
// and cosf, not the fast intrinsics, since the argument reaches ~2^9 pi.
//
// bf16 (npcd_tpu's _build_h0t, _layer and _wsum_reduce with bf16 feat_t and
// weights): x and the octaves are computed in f32 and rounded to bf16 as
// layer 1's input; each layer is z = bf16(bf16(f32 sum of exact bf16
// products) + b), the activation max(z, bf16(z * bf16(0.01))); the last
// layer's z is rounded per pair, so it cannot be folded after the w-sum as
// the f32 forward folds it; the w-sum over a point's k pairs runs in f32
// (products, then sums, in j order) and the output is bf16.
//
// What bounds the bf16 forward on the H100: 2 (95 * 256 + 3 * 256 * 256 +
// 256 * 256 + 256) = 573,440 operations a pair at the configs' 95 -> 256 x 4
// -> 256 (the last layer per pair, the w-sum), 3.288 TFLOP at the fast
// stage-1 step's 400 x 14,336 pairs: 3.325 ms at 989 TFLOP/s dense bf16,
// against ~0.83 GB read and written (0.25 ms), so the tensor cores' rate
// bounds it. tc::mlp_posenc_wsum (below) runs every layer product on them,
// 128 pairs a block, the activations in shared memory as bf16 and the
// weights streamed from L2 by cp.async (one slab of 64 rows a barrier).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "bf16_mlp.cuh"
#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int HID = 256;   // width of every layer; one thread per column
constexpr float LEAKY_BF16 = 0.010009765625f;  // bf16(0.01)

typedef __nv_bfloat16 bf16;

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ float leaky(float z) { return fmaxf(z, 0.01f * z); }

// A layer-1 input value: rounded to bf16 in the bf16 flavour.
template <typename T>
__device__ __forceinline__ float as_input(float v) { return is_bf16<T>() ? rnd(v) : v; }

// Builds the block's layer-1 input h0 [P][ld1] (feature rows, x, the
// encoding, zero columns d1 .. pad - 1; x and the encoding rounded to bf16
// in the bf16 flavour) and the pair weights wpair [P] for pairs r0 ..
// r0 + P - 1 of one instance, by a block of NT >= P threads; h0 is f32, or
// bf16 (O) for the tensor cores. Lanes past the last pair are zeroed before
// sin/cos.
template <typename T, int P, int NT = HID, typename O = float>
__device__ __forceinline__ void build_input(const T* __restrict__ feat,
                                            const float* __restrict__ pos,
                                            O* h0, float* wpair, int r0,
                                            int m, int f_dim, int n_freqs,
                                            int anchor, float freq_c0, int d1, int ld1,
                                            int pad, int t) {
  for (int idx = t; idx < f_dim * P; idx += NT) {
    const int f = idx / P, r = idx % P;
    st(h0 + r * ld1 + f, r0 + r < m ? ld(feat + (long)f * m + r0 + r) : 0.f);
  }
  for (int idx = t; idx < 3 * P; idx += NT) {
    const int d = idx / P, r = idx % P;
    const float x = r0 + r < m ? pos[(long)d * m + r0 + r] : 0.f;
    O* row = h0 + r * ld1;
    st(row + f_dim + d, as_input<T>(x));
    O* enc = row + f_dim + 3 + d * 2 * n_freqs;
    float s = 0.f, c = 1.f;
    for (int j = 0; j < n_freqs; ++j) {
      if (j % anchor == 0) {
        const float arg = __fmul_rn(freq_c0 * (float)(1 << j), x);
        s = sinf(arg);
        c = cosf(arg);
      } else {
        const float s2 = __fmul_rn(__fmul_rn(2.f, s), c);
        c = __fsub_rn(__fmul_rn(__fmul_rn(2.f, c), c), 1.f);
        s = s2;
      }
      st(enc + j, as_input<T>(s));
      st(enc + n_freqs + j, as_input<T>(c));
    }
  }
  for (int idx = t; idx < P * (pad - d1); idx += NT) {
    const int r = idx / (pad - d1), c = idx % (pad - d1);
    st(h0 + r * ld1 + d1 + c, 0.f);
  }
  if (t < P) wpair[t] = r0 + t < m ? pos[3L * m + r0 + t] : 0.f;
}

// ---------------------------------------------------------------------------
// Forward, f32 (K6f), on the tensor cores: tf::mlp_posenc_wsum. What
// npcd_tpu's f32 kernel computes, with each layer product in 3xTF32
// (csrc/tf32_mma.cuh): mma.sync.m16n8k8 with tf32 operands and f32
// accumulation, every operand split into hi = tf32(x) and lo = tf32(x - hi)
// and each product a_lo b_hi + a_hi b_lo + a_hi b_hi, ~2**-21 of the f32
// product, as npcd_tpu's _kdot splits f32 into bf16 hi + lo for the MXU. The
// three products of one 8-deep k-step go into a fresh f32 fragment that is
// added to the layer's running sum in f32 (the MMA's own sums do not round
// as f32 adds do).
//
// Bound: ~459 kflop per pair at the configs' 95 -> 256 x 4 -> 256 (the last
// layer once per point, below), so the tensor cores at 495 / 3 TFLOP/s: 0.91
// ms at the render's 327,680 pairs. A block of 8 warps takes 64 pairs (8
// points x k = 8) and tiles each hidden layer's [64, 256] output 2-D over
// its warps, 2 x 4: each warp 32 rows x 64 columns, 2 x 8 m16n8 tiles, 64
// f32 accumulators a thread, so that every A fragment (split once, in
// registers) feeds 8 n-tiles and every B fragment 2 m-tiles; two blocks an
// SM with a 2-stage ring. (A 128-pair tiling, 64 x 64 a warp with a 4-stage
// ring and one block an SM, spilled and ran slower on the H100: PERF.md.)
// The activations stay raw f32 in shared memory, [64][260] (a row stride of
// 4 mod 32 banks puts the A fragment reads in 32 distinct banks), and a
// layer's output overwrites its input after a barrier: it waits in the
// accumulators until every warp has read its last A fragment. Bias and
// leaky_relu are applied in f32 at the store. Layer 1's input [feat | x |
// posenc] is build_input's, zero-padded to a multiple of 8 columns.
//
// The weights (~0.9 MB, L2-resident) do not fit in shared memory. A small
// kernel (split_weights) splits the whole stack into tf32 hi and lo once a
// call, in the order the k-steps read it: one 16 KB slab per k-step (8 rows
// x 256 columns), within it one 16-byte {b0 hi, b1 hi, b0 lo, b1 lo} per
// n-tile and lane, so a warp reads a B fragment's hi and lo with one
// conflict-free ld.shared.v4. The slabs of every layer follow each other,
// so one cp.async ring streams them across layer boundaries, one barrier a
// k-step.
//
// The last layer is linear and its output is w-summed over a point's k
// pairs, so it is folded after the sum: sum_j w_j (h_j W + b) = (sum_j w_j
// h_j) W + b sum_j w_j. Each thread sums its column of act_{L-2} over the k
// pairs of each point in f32, in j order (in place: point q's sum goes to
// row q, which belongs to a point summed already), then one [64 / k, 256] x
// [256, 256] product runs over the m16 tiles that hold the block's points
// (one at k = 8, four at k = 1; 8 warps x 4 n-tiles), a fifth of the
// pair-wise operations saved at k = 8. A point whose weights are all 0
// gives exactly 0. Lanes past the last pair are built as in build_input
// (zeroed before sin/cos, weight 0) and never written back.
//
// The backward (tf::mlp_posenc_wsum_bwd, below) recomputes its own forward
// from the inputs in exact f32, and takes this kernel's layer loop for its
// dX products.

// The stack's weights split into tf32 hi and lo in the forward's reading
// order: slab s is the k-step of 8 rows 8 kk .. 8 kk + 7 of one layer's W
// (layer 0's d1 rows zero-padded to a multiple of 8; slabs of the layers in
// order), and holds at [n-tile j][lane (g, u)] the B fragment {hi(W[8 kk +
// u][8 j + g]), hi(W[8 kk + u + 4][8 j + g]), lo(...), lo(...)}.
constexpr int SLAB = 32 * 32;  // uint4 per slab: 32 n-tiles x 32 lanes (16 KB)

__global__ void split_weights(const float* __restrict__ params, uint4* __restrict__ wsplit,
                              int d1, int n_slabs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)n_slabs * SLAB) return;
  const int s = (int)(i / SLAB), j = (int)(i / 32 % 32), lane = (int)(i % 32);
  const int s0 = (d1 + 7) / 8;  // layer 0's slabs
  int kin = d1, kk = s;
  const float* W = params;
  if (s >= s0) {
    kin = HID;
    kk = (s - s0) % (HID / 8);
    W += (long)d1 * HID + HID + (long)((s - s0) / (HID / 8)) * (HID * HID + HID);
  }
  const int r = 8 * kk + (lane & 3), n = 8 * j + (lane >> 2);
  uint4 v;
  tf::split(r < kin ? W[(long)r * HID + n] : 0.f, v.x, v.z);
  tf::split(r + 4 < kin ? W[(long)(r + 4) * HID + n] : 0.f, v.y, v.w);
  wsplit[i] = v;
}

// The transposed weights of the backward's dX products, split as
// split_weights splits W: slab s < 32 (n_layers - 1) is the k-step kk = s %
// 32 of W_l^T, l = n_layers - 1 - s / 32 (the backward's order), and holds at
// [n-tile j][lane (g, u)] {hi(W_l[8 j + g][8 kk + u]), hi(W_l[8 j + g][8 kk
// + u + 4]), lo(...), lo(...)}; after them W_0[:F]^T for dfeat, compact:
// [kk < 32][n-tile j < (F + 7) / 8][lane], columns from F on zero.
__global__ void split_weights_t(const float* __restrict__ params, uint4* __restrict__ wsplit_t,
                                int d1, int f_dim, int n_layers) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nt_f = (f_dim + 7) / 8;
  const long n_main = (long)(n_layers - 1) * (HID / 8) * SLAB;
  if (i >= n_main + (HID / 8) * nt_f * 32) return;
  const int lane = (int)(i % 32);
  int kk, j, cols = HID;
  const float* W = params;  // W_0, then W_l
  if (i < n_main) {
    const int s = (int)(i / SLAB), l = n_layers - 1 - s / (HID / 8);
    kk = s % (HID / 8);
    j = (int)(i / 32 % 32);
    W += (long)d1 * HID + HID + (long)(l - 1) * (HID * HID + HID);
  } else {
    kk = (int)((i - n_main) / (32 * nt_f));
    j = (int)((i - n_main) / 32 % nt_f);
    cols = f_dim;
  }
  const int n = 8 * j + (lane >> 2), r = 8 * kk + (lane & 3);
  uint4 v;
  tf::split(n < cols ? W[(long)n * HID + r] : 0.f, v.x, v.z);
  tf::split(n < cols ? W[(long)n * HID + r + 4] : 0.f, v.y, v.w);
  wsplit_t[i] = v;
}

namespace tf {

constexpr int BLOCK_PAIRS = 64;  // pairs a block
constexpr int STAGES = 2;        // the weight ring's stages
constexpr int WARPS_M = 2, WARPS_N = 4;  // the hidden layers' warp grid
constexpr int M_TILES = BLOCK_PAIRS / WARPS_M / 16, N_TILES = 32 / WARPS_N;  // a warp's
constexpr int LAST_M_TILES = BLOCK_PAIRS / 16;  // the folded last layer's rows at k = 1
constexpr int LDA = HID + 4;  // act row stride (4 mod 32 banks)

// Slab t of the stack into ring stage t % STAGES by cp.async, by the whole
// block; one copy group a call (empty past the last slab).
__device__ __forceinline__ void load_slab(uint4* ring, const uint4* __restrict__ wsplit, int t,
                                          int n_slabs) {
  if (t < n_slabs) {
#pragma unroll
    for (int i = threadIdx.x; i < SLAB; i += HID)
      cp16(ring + (t % STAGES) * SLAB + i, wsplit + (long)t * SLAB + i, true);
  }
  cp_commit();
}

// Waits for slab t and starts the load of the slab STAGES - 1 ahead into
// the stage that the barrier frees -> slab t.
__device__ __forceinline__ const uint4* next_slab(uint4* ring, const uint4* __restrict__ wsplit,
                                                  int t, int n_slabs) {
  cp_wait<STAGES - 2>();
  __syncthreads();  // slab t landed for every thread; stage (t - 1) % STAGES is free
  load_slab(ring, wsplit, t + STAGES - 1, n_slabs);
  return ring + (t % STAGES) * SLAB;
}

// The A fragment of act's rows r0 .. r0 + 15 at k-step kk, split into tf32
// hi and lo.
__device__ __forceinline__ void a_frag(const float* act, int r0, int kk, unsigned (&ah)[4],
                                       unsigned (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
  const float* a = act + (r0 + g) * LDA + 8 * kk + u;
  split(a[0], ah[0], al[0]);
  split(a[8 * LDA], ah[1], al[1]);
  split(a[4], ah[2], al[2]);
  split(a[8 * LDA + 4], ah[3], al[3]);
}

// A hidden layer: acc = act[r0, r0 + 16 M_TILES) . W[:, 8 nt0, 8 (nt0 +
// N_TILES)) over `steps` k-steps of 8, slabs t, t + 1, ... of the ring (t
// advances past them); each A fragment is split once for its N_TILES
// n-tiles.
__device__ __forceinline__ void layer_product(float (&acc)[M_TILES][N_TILES][4],
                                              const float* act, int r0, int nt0, uint4* ring,
                                              const uint4* __restrict__ wsplit, int& t,
                                              int steps, int n_slabs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < M_TILES; ++i)
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kk = 0; kk < steps; ++kk, ++t) {
    const uint4* slab = next_slab(ring, wsplit, t, n_slabs);
    unsigned ah[M_TILES][4], al[M_TILES][4];
#pragma unroll
    for (int i = 0; i < M_TILES; ++i) a_frag(act, r0 + 16 * i, kk, ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < N_TILES; ++j) {
      const uint4 b = slab[(nt0 + j) * 32 + lane];
#pragma unroll
      for (int i = 0; i < M_TILES; ++i) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(f, ah[i], al[i], b.x, b.y, b.z, b.w);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += f[e];
      }
    }
  }
}

// The folded last layer: acc[i] = act[16 i, 16 i + 16) . W[:, 8 nt0, 8 (nt0
// + 4)) for the first `mts` m-tiles (those that hold the block's points),
// one m-tile at a time, so that one A fragment is live; as layer_product
// for the ring.
__device__ __forceinline__ void last_product(float (&acc)[LAST_M_TILES][4][4], const float* act,
                                             int mts, int nt0, uint4* ring,
                                             const uint4* __restrict__ wsplit, int& t, int steps,
                                             int n_slabs) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < LAST_M_TILES; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kk = 0; kk < steps; ++kk, ++t) {
    const uint4* slab = next_slab(ring, wsplit, t, n_slabs);
#pragma unroll
    for (int i = 0; i < LAST_M_TILES; ++i) {
      if (i >= mts) break;
      unsigned ah[4], al[4];
      a_frag(act, 16 * i, kk, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 b = slab[(nt0 + j) * 32 + lane];
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(f, ah, al, b.x, b.y, b.z, b.w);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += f[e];
      }
    }
  }
}

// Shared memory: the ring [STAGES][SLAB] uint4, act [BLOCK_PAIRS][LDA],
// wpair [BLOCK_PAIRS] and the points' weight sums [BLOCK_PAIRS].
__global__ void __launch_bounds__(HID, 2)
mlp_posenc_wsum(const float* __restrict__ feat_t, const float* __restrict__ pos_t,
                const float* __restrict__ params, const uint4* __restrict__ wsplit,
                float* __restrict__ out, int m, int f_dim, int pos_rows, int n_layers,
                int n_freqs, int anchor, float freq_c0, int k) {
  constexpr int P = BLOCK_PAIRS;
  extern __shared__ __align__(16) float sbuf[];
  uint4* ring = reinterpret_cast<uint4*>(sbuf);
  float* act = sbuf + 4 * STAGES * SLAB;
  float* wpair = act + P * LDA;
  float* wsum = wpair + P;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, u = lane & 3;
  const int inst = blockIdx.y, r0 = blockIdx.x * P;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs), d1_pad = (d1 + 7) & ~7;
  const int n_slabs = d1_pad / 8 + (n_layers - 1) * (HID / 8);

  int t = 0;  // the next slab to consume; the first ones land while the input is built
  for (int s = 0; s < STAGES - 1; ++s) load_slab(ring, wsplit, s, n_slabs);
  build_input<float, P>(feat_t + (long)inst * f_dim * m, pos_t + (long)inst * pos_rows * m, act,
                        wpair, r0, m, f_dim, n_freqs, anchor, freq_c0, d1, LDA, LDA, tid);

  // ---- hidden layers 0 .. L-2, in place in act ----------------------------
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const float* p = params;  // W_l, then b_l
  for (int l = 0; l < n_layers - 1; ++l) {
    const int kin = l == 0 ? d1 : HID;
    float acc[M_TILES][N_TILES][4];
    layer_product(acc, act, wm * (P / WARPS_M), wn * N_TILES, ring, wsplit, t,
                  (l == 0 ? d1_pad : HID) / 8, n_slabs);
    const float* bias = p + (long)kin * HID;
    p = bias + HID;
    __syncthreads();  // every warp has read its last A fragment
#pragma unroll
    for (int i = 0; i < M_TILES; ++i)
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {
        const int row = wm * (P / WARPS_M) + 16 * i + g, col = 8 * (wn * N_TILES + j) + 2 * u;
        const float b0 = bias[col], b1 = bias[col + 1];
        *reinterpret_cast<float2*>(act + row * LDA + col) =
            make_float2(leaky(acc[i][j][0] + b0), leaky(acc[i][j][1] + b1));
        *reinterpret_cast<float2*>(act + (row + 8) * LDA + col) =
            make_float2(leaky(acc[i][j][2] + b0), leaky(acc[i][j][3] + b1));
      }
  }

  // ---- the k-weighted sum of act_{L-2} per point, in place --------------
  const int kin = n_layers == 1 ? d1_pad : HID;  // the last layer's input width
  const int pts = P / k, mts = (pts + 15) / 16;
  __syncthreads();
  for (int c = tid; c < kin; c += HID) {
    for (int q = 0; q < pts; ++q) {
      float s = 0.f;
      for (int j = 0; j < k; ++j) s = fmaf(wpair[q * k + j], act[(q * k + j) * LDA + c], s);
      act[q * LDA + c] = s;
    }
  }
  if (tid < pts) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += wpair[tid * k + j];
    wsum[tid] = s;
  }

  // ---- the last layer once per point: rows 0 .. pts - 1, 4 n-tiles a warp --
  float acc[LAST_M_TILES][4][4];
  last_product(acc, act, mts, 4 * warp, ring, wsplit, t, kin / 8, n_slabs);
  const float* bias = p + (long)(n_layers == 1 ? d1 : HID) * HID;
  const int n_pts = m / k, pt0 = r0 / k;
#pragma unroll
  for (int i = 0; i < LAST_M_TILES; ++i) {
    if (i >= mts) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * (4 * warp + j) + 2 * u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 16 * i + g + 8 * h;
        if (q < pts && pt0 + q < n_pts) {
          *reinterpret_cast<float2*>(out + ((long)inst * n_pts + pt0 + q) * HID + col) =
              make_float2(acc[i][j][2 * h] + bias[col] * wsum[q],
                          acc[i][j][2 * h + 1] + bias[col + 1] * wsum[q]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, f32 (K6b), on the tensor cores: tf::mlp_posenc_wsum_bwd.
// Replaces npcd_tpu/ops/pallas/fused_mlp.py:_posenc_impl_bwd
// (_bwd_posenc_kernel) with reduce_k, need_dw=False and need_dp=False, the
// aggregator's contract: the pair weights w and x_rel get no gradient, so the
// outputs are dfeat_t (the feature rows of dh0 only) and dW/db of every
// layer. The dX, dW and dfeat products are 3xTF32 as in the forward above
// (a fresh f32 fragment per 8-deep k-step, added in f32).
//
// Per tile of 64 pairs a block (1) rebuilds h0 and recomputes layers 0 ..
// L-2 in exact f32 on the CUDA cores (f32_product: each thread 8 rows x 8
// columns, the weights streamed through the ring; the sums in the order of
// the CUDA-core kernel this one replaced, so that leaky_relu's slopes fall
// as they did: a 3xTF32 recompute (~2**-21) put 4.1e-3 of the parameters of
// chip_smoke.py's GPU-vs-CPU stage-1 step past its limit of 1e-3, against
// 8.7e-4 in f32, all in the aggregation MLP's lower layers: PERF.md),
// keeping act_0 .. act_{L-3} in a per-block global scratch (L2-resident) and
// act_{L-2} in shared memory;
// (2) runs the last layer once per point (npcd_tpu's fast_last): it is
// linear and its per-pair cotangent is w_r g_out[n], so hw_n = sum_j w_j
// act_{L-2}[n k + j] (f32, j order, as the forward's w-sum), dW_L += hw^T
// g_out over the points, db_L += sum_n (sum_j w_j) g_out[n], and
// dh_{L-2}[r] = w_r (g_out[n] W_L^T), one [64 / k, 256] x [256, 256] product
// over the m16 tiles that hold the block's points, times leaky'(z) = 1 if
// act(z) > 0 else 0.01 (act(z) > 0 exactly when z > 0); (3) walks layers
// L-2 .. 1 back: db_l += sum g (per column, f32, pair order), dW_l +=
// act_{l-1}^T g, dh = g W_l^T, g = dh leaky'(act_{l-1}); (4) layer 0: dW_0 +=
// h0^T g_0 and dfeat_t = g_0 W_0[:F]^T.
//
// dX products are the forward's layer_product with g as the A operand and
// W^T as the slabs (split_weights_t: the stack's W^T split as split_weights
// splits W, in the order the backward reads it, streamed by the ring after
// the recompute). dW products contract over the tile's 64
// pairs (8 k-steps), both operands read transposed from shared memory in
// split_product's permuted k order (A's column u is pair 2u, u + 4 is pair
// 2u + 1: with the 4-mod-32 row stride both reads fall in 32 distinct banks,
// 8u + g), each fragment split once for the warp's n- or m-tiles; [256, 256]
// in four chunks of 64 rows over the 2 x 4 warp grid, 64 accumulators a
// thread.
//
// The dW reduction runs over every pair into ~288K weights. Blocks run in no
// order, so the TPU kernel's accumulation in scratch across a sequential
// grid does not carry over, and f32 atomics would make the result differ
// from run to run. The grid is persistent: a fixed number of blocks (one per
// SM, as the wrapper chooses) takes tiles blk, blk + grid, ...; each block
// adds each tile's dW/db into its own partial in global memory, and
// reduce_partials_tf32 sums the partials in block order, so the result
// depends only on the inputs and the grid size. The partials (1.2 MB a
// block) do not fit in L2, and their read-modify-write, 2.4 MB a tile, set
// the kernel's pace at first (PERF.md), so: a partial holds dW in
// the order of the threads' accumulators (part_off), each warp reading and
// writing 512 contiguous bytes at a time; each chunk's old values land in
// shared memory by cp.async while its product runs; and the last layer,
// whose tile holds only 64 / k points (8 at k 8), appends hw and g_out to a
// per-block batch in the scratch and forms dW_L over 64 points at a time
// (the block's 8 tiles at k 8, in tile order) at the start of the next tile
// and after the last one.
//
// Bound: ~1.33 Mflop per pair at the configs' 95 -> 256 x 4 -> 256 (the
// last layer once per point), the tensor cores at 495 / 3 TFLOP/s; the f32
// recompute's third of it also bounds it at 67 TFLOP/s FP32. Shared
// memory: the ring, act and g [64][260] each, the pair weights and the
// points' weight sums, a chunk's old dW values (~226 KB): one block an SM.

// Rows r0 .. r0 + 15 of W [kin][HID] into a ring stage [16][HID] by cp.async
// (rows from kin on zero), one copy group.
__device__ __forceinline__ void load_w_rows(float* stage, const float* __restrict__ W, int r0,
                                            int kin) {
#pragma unroll
  for (int i = threadIdx.x; i < 16 * HID / 4; i += HID) {
    const int r = i / (HID / 4), c = i % (HID / 4) * 4;
    const bool ok = r0 + r < kin;
    cp16(stage + r * HID + c, W + (ok ? (long)(r0 + r) * HID + c : 0), ok);
  }
  cp_commit();
}

// A hidden layer of the backward's recompute in exact f32 on the CUDA cores:
// acc[i][j] = sum_c act[8 warp + i][c] W[c][col_j] (fmaf, c in order, the
// sums of the CUDA-core kernel this one replaced, bit for bit), col_j = 4
// lane + j for j < 4 and 128 + 4 lane + j - 4 after, for c up to kin rounded
// up to 4 (act is zero past kin); W streams through the ring (2 stages of 16
// rows).
__device__ __forceinline__ void f32_product(float (&acc)[8][8], const float* act,
                                            const float* __restrict__ W, int kin, float* ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n = (kin + 15) / 16;
  load_w_rows(ring, W, 0, kin);
  for (int q = 0; q < n; ++q) {
    cp_wait<0>();
    __syncthreads();  // chunk q landed for every thread; the other stage is free
    if (q + 1 < n) load_w_rows(ring + ((q + 1) % 2) * 16 * HID, W, 16 * (q + 1), kin);
    const float* w = ring + (q % 2) * 16 * HID;
    const int steps = min(16, (kin - 16 * q + 3) & ~3);
    for (int cc = 0; cc < steps; cc += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(act + (8 * warp + i) * LDA + 16 * q + cc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 w0 = *reinterpret_cast<const float4*>(w + (cc + s) * HID + 4 * lane);
        const float4 w1 = *reinterpret_cast<const float4*>(w + (cc + s) * HID + 128 + 4 * lane);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = s == 0 ? a[i].x : s == 1 ? a[i].y : s == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
  }
}

// The block's partial dW/db: per layer, its dW in chunks of 64 rows
// (ceil(k_in / 64) of them), each chunk [16][HID] float4 in dw_product's
// accumulator order (float4 q of thread t holds acc[q / 8][q % 8][0..3] at
// [q][t], so that a warp's load or store is 512 contiguous bytes), then its
// db [HID]; reduce_partials_tf32 maps it back to params' layout.
constexpr int CHUNK_ROWS = 64, CHUNK = CHUNK_ROWS * HID;
__host__ __device__ __forceinline__ int part_chunks(int l, int d1) {
  return l ? HID / CHUNK_ROWS : (d1 + CHUNK_ROWS - 1) / CHUNK_ROWS;
}
// where layer l's part starts (l = n_layers: the length of a partial)
__host__ __device__ __forceinline__ long part_off(int l, int d1) {
  return l ? (long)part_chunks(0, d1) * CHUNK + HID +
                 (long)(l - 1) * (part_chunks(1, d1) * CHUNK + HID)
           : 0L;
}

// dW += A^T G, dW[c][t] += sum_p A[p][c] G[p][t] over the pairs p < 8 steps
// for the rows c < rows (A and G [64][LDA] in shared memory), into the
// layer's part of the block's partial, by the whole block: chunks of 64
// rows, each warp 32 rows x 64 columns. Each thread's old values of a chunk
// land in `old` [16][HID] float4 (the chunk's own layout) by cp.async while
// the product runs.
__device__ __forceinline__ void dw_product(float* __restrict__ part, const float* A,
                                           const float* G, int steps, int rows, float4* old) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
  const int n0 = 8 * (warp % WARPS_N) * N_TILES;  // the warp's first column
  for (int c = 0;; ++c) {
    const int c0 = CHUNK_ROWS * c + (warp / WARPS_N) * (CHUNK_ROWS / WARPS_M);
    if (c0 >= rows) break;
    float4* chunk = reinterpret_cast<float4*>(part + (long)c * CHUNK) + threadIdx.x;
#pragma unroll
    for (int q = 0; q < M_TILES * N_TILES; ++q)
      cp16(old + q * HID + threadIdx.x, chunk + q * HID, true);
    cp_commit();
    float acc[M_TILES][N_TILES][4];
#pragma unroll
    for (int i = 0; i < M_TILES; ++i)
#pragma unroll
      for (int j = 0; j < N_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int kk = 0; kk < steps; ++kk) {
      const float* a = A + (8 * kk + 2 * u) * LDA + c0 + g;  // pair 2u, then 2u + 1 at + LDA
      const float* b = G + (8 * kk + 2 * u) * LDA + n0 + g;
      unsigned ah[M_TILES][4], al[M_TILES][4];
#pragma unroll
      for (int i = 0; i < M_TILES; ++i) {
        split(a[16 * i], ah[i][0], al[i][0]);
        split(a[16 * i + 8], ah[i][1], al[i][1]);
        split(a[LDA + 16 * i], ah[i][2], al[i][2]);
        split(a[LDA + 16 * i + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {
        unsigned bh0, bl0, bh1, bl1;
        split(b[8 * j], bh0, bl0);
        split(b[LDA + 8 * j], bh1, bl1);
#pragma unroll
        for (int i = 0; i < M_TILES; ++i) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(f, ah[i], al[i], bh0, bh1, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[e];
        }
      }
    }
    cp_wait<0>();
#pragma unroll
    for (int i = 0; i < M_TILES; ++i)
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) {
        const float4 o = old[(i * N_TILES + j) * HID + threadIdx.x];
        chunk[(i * N_TILES + j) * HID] = make_float4(o.x + acc[i][j][0], o.y + acc[i][j][1],
                                                     o.z + acc[i][j][2], o.w + acc[i][j][3]);
      }
  }
}

// db[t] += sum_{p < n} G[p][t] for the thread's column t, in pair order.
__device__ __forceinline__ void db_sum(float* __restrict__ db, const float* G, int n) {
  float s = 0.f;
  for (int p = 0; p < n; ++p) s += G[p * LDA + threadIdx.x];
  db[threadIdx.x] += s;
}

// Shared memory: the ring [STAGES][SLAB] uint4, act and g [BLOCK_PAIRS][LDA],
// wpair and the points' weight sums [BLOCK_PAIRS], and dw_product's old
// values [16][HID] float4.
__global__ void __launch_bounds__(HID, 1)
mlp_posenc_wsum_bwd(const float* __restrict__ feat_t, const float* __restrict__ pos_t,
                    const float* __restrict__ params, const uint4* __restrict__ wsplit,
                    const float* __restrict__ g_out, float* __restrict__ dfeat_t,
                    float* __restrict__ partial, float* __restrict__ scratch, int inst, int m,
                    int f_dim, int pos_rows, int n_layers, int n_freqs, int anchor,
                    float freq_c0, int k,
                    long n_partial) {
  constexpr int P = BLOCK_PAIRS;
  extern __shared__ __align__(16) float sbuf[];
  uint4* ring = reinterpret_cast<uint4*>(sbuf);
  float* act = sbuf + 4 * STAGES * SLAB;
  float* gs = act + P * LDA;
  float* wpair = gs + P * LDA;
  float* wsum = wpair + P;
  float4* old = reinterpret_cast<float4*>(wsum + P);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, u = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int n_slabs = (n_layers - 1) * (HID / 8);  // W_l^T for l = L-1 .. 1
  const uint4* w0t = wsplit + (long)n_slabs * SLAB;  // W_0[:F]^T, compact
  const int nt_f = (f_dim + 7) / 8;
  const int n_pts = m / k, pts = P / k, pts8 = (pts + 7) & ~7, mts = (pts + 15) / 16;
  const int tiles_per_inst = (m + P - 1) / P;
  const long n_tiles = (long)inst * tiles_per_inst;
  // act_0 .. act_{L-3}, then the batch of points for the last layer's dW: hw
  // [P][HID] and g_out [P][HID]
  float* my_scratch = scratch + (long)blockIdx.x * n_layers * P * HID;
  float* batch_hw = my_scratch + (long)(n_layers - 2) * P * HID;
  float* batch_g = batch_hw + P * HID;
  int batched = 0;  // rows in the batch
  // W_l and b_l in params; dW_l and db_l in the block's partial (part_off)
  auto w_off = [&](int l) {
    return l ? (long)d1 * HID + HID + (long)(l - 1) * (HID * HID + HID) : 0L;
  };
  auto b_off = [&](int l) { return w_off(l) + (long)(l ? HID : d1) * HID; };
  auto dw_part = [&](int l) { return partial + blockIdx.x * n_partial + part_off(l, d1); };
  auto db_part = [&](int l) { return dw_part(l) + (long)part_chunks(l, d1) * CHUNK; };
  // dW_L += hw^T g_out over the batch's points, through act and g
  auto flush_batch = [&]() {
    for (int idx = tid; idx < batched * HID / 4; idx += HID) {
      const int r = idx / (HID / 4), c = idx % (HID / 4) * 4;
      *reinterpret_cast<float4*>(act + r * LDA + c) = reinterpret_cast<const float4*>(batch_hw)[idx];
      *reinterpret_cast<float4*>(gs + r * LDA + c) = reinterpret_cast<const float4*>(batch_g)[idx];
    }
    __syncthreads();
    dw_product(dw_part(n_layers - 1), act, gs, batched / 8, HID, old);
    batched = 0;
  };

  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = (int)(tile / tiles_per_inst), r0 = (int)(tile % tiles_per_inst) * P;
    const float* feat = feat_t + (long)i * f_dim * m;
    const float* pos = pos_t + (long)i * pos_rows * m;
    // act <- act_l from the scratch (l >= 0), or layer 1's input h0 (l < 0)
    auto load_act = [&](int l) {
      if (l < 0) {
        build_input<float, P>(feat, pos, act, wpair, r0, m, f_dim, n_freqs, anchor, freq_c0, d1,
                              LDA, LDA,
                              tid);
        return;
      }
      const float4* src = reinterpret_cast<const float4*>(my_scratch + (long)l * P * HID);
      for (int idx = tid; idx < P * HID / 4; idx += HID)
        *reinterpret_cast<float4*>(act + idx / (HID / 4) * LDA + idx % (HID / 4) * 4) = src[idx];
    };

    __syncthreads();  // the last tile is done with the ring, act and g
    if (batched == P) {
      flush_batch();
      __syncthreads();
    }
    load_act(-1);

    // ---- recompute layers 0 .. L-2 in place in act, in exact f32 ------------
    for (int l = 0; l < n_layers - 1; ++l) {
      float acc[8][8];
      f32_product(acc, act, params + w_off(l), l ? HID : d1, reinterpret_cast<float*>(ring));
      const float* bias = params + b_off(l);
      float* keep = l < n_layers - 2 ? my_scratch + (long)l * P * HID : nullptr;
      __syncthreads();  // every thread has read its input rows
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 8 * warp + i, col = 128 * h + 4 * lane;
          const float4 b = *reinterpret_cast<const float4*>(bias + col);
          const float4 v = make_float4(leaky(acc[i][4 * h] + b.x), leaky(acc[i][4 * h + 1] + b.y),
                                       leaky(acc[i][4 * h + 2] + b.z), leaky(acc[i][4 * h + 3] + b.w));
          *reinterpret_cast<float4*>(act + row * LDA + col) = v;
          if (keep) *reinterpret_cast<float4*>(keep + row * HID + col) = v;
        }
    }
    int t = 0;  // the next W^T slab to consume
    __syncthreads();  // act holds act_{L-2}; the ring is free
    load_slab(ring, wsplit, 0, n_slabs);

    // ---- the last layer, once per point -----------------------------------
    // the points' g_out in g's rows 0 .. pts8 - 1 (0 past the last point), and
    // hw and g_out appended to the batch (rows pts .. pts8 - 1 zero)
    const long g_row = (long)i * n_pts + r0 / k;
    for (int q = 0; q < pts8; ++q) {
      float s = 0.f;
      if (q < pts)
        for (int j = 0; j < k; ++j) s = fmaf(wpair[q * k + j], act[(q * k + j) * LDA + tid], s);
      const float go = q < pts && r0 / k + q < n_pts ? g_out[(g_row + q) * HID + tid] : 0.f;
      gs[q * LDA + tid] = go;
      batch_hw[(batched + q) * HID + tid] = s;
      batch_g[(batched + q) * HID + tid] = go;
    }
    batched += pts8;
    if (tid < pts) {
      float s = 0.f;
      for (int j = 0; j < k; ++j) s += wpair[tid * k + j];
      wsum[tid] = s;
    }
    __syncthreads();
    {
      const int l = n_layers - 1;
      float s = 0.f;
      for (int q = 0; q < pts; ++q) s = fmaf(wsum[q], gs[q * LDA + tid], s);
      db_part(l)[tid] += s;
    }
    // dh_{L-2} per point, g_out W_L^T: rows 0 .. pts - 1, 4 n-tiles a warp
    float pacc[LAST_M_TILES][4][4];
    last_product(pacc, gs, mts, 4 * warp, ring, wsplit, t, HID / 8, n_slabs);
    __syncthreads();  // every warp has read its last g_out fragment
    // g_{L-2}[r] = w_r dh[r / k] leaky'(act_{L-2}[r]), every pair
#pragma unroll
    for (int i = 0; i < LAST_M_TILES; ++i) {
      if (i >= mts) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * (4 * warp + j) + 2 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * i + g + 8 * h;
          if (q >= pts) continue;
          for (int jj = 0; jj < k; ++jj) {
            const int r = q * k + jj;
            const float w = wpair[r];
            const float2 a = *reinterpret_cast<const float2*>(act + r * LDA + col);
            *reinterpret_cast<float2*>(gs + r * LDA + col) =
                make_float2(w * pacc[i][j][2 * h] * (a.x > 0.f ? 1.f : 0.01f),
                            w * pacc[i][j][2 * h + 1] * (a.y > 0.f ? 1.f : 0.01f));
          }
        }
      }
    }
    __syncthreads();  // act and wpair are read (load_act(-1) rewrites wpair)
    load_act(n_layers - 3);
    __syncthreads();

    // ---- layers L-2 .. 1: act holds act_{l-1}, g holds g_l -----------------
    for (int l = n_layers - 2; l >= 1; --l) {
      db_sum(db_part(l), gs, P);
      dw_product(dw_part(l), act, gs, P / 8, HID, old);
      float acc[M_TILES][N_TILES][4];
      layer_product(acc, gs, wm * (P / WARPS_M), wn * N_TILES, ring, wsplit, t, HID / 8,
                    n_slabs);
      __syncthreads();  // every warp has read its last g_l fragment
#pragma unroll
      for (int i = 0; i < M_TILES; ++i)
#pragma unroll
        for (int j = 0; j < N_TILES; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * (P / WARPS_M) + 16 * i + g + 8 * h,
                      col = 8 * (wn * N_TILES + j) + 2 * u;
            const float2 a = *reinterpret_cast<const float2*>(act + row * LDA + col);
            *reinterpret_cast<float2*>(gs + row * LDA + col) =
                make_float2(acc[i][j][2 * h] * (a.x > 0.f ? 1.f : 0.01f),
                            acc[i][j][2 * h + 1] * (a.y > 0.f ? 1.f : 0.01f));
          }
      __syncthreads();  // every thread has read act_{l-1}
      load_act(l - 2);
      __syncthreads();
    }

    // ---- layer 0: act holds h0; dfeat = g_0 W_0[:F]^T -----------------------
    db_sum(db_part(0), gs, P);
    dw_product(dw_part(0), act, gs, P / 8, d1, old);
    {
      // m-tile warp % 4, n-tiles warp / 4, + 2, ... of the (F + 7) / 8; W_0[:F]^T
      // from global memory (64 KB at F 32, L2-resident)
      const int mt = warp % LAST_M_TILES, j0 = warp / LAST_M_TILES;
      constexpr int NJ = 16;  // two warps an m-tile: F up to 256
      float acc[NJ][4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HID / 8; ++kk) {
        unsigned ah[4], al[4];
        a_frag(gs, 16 * mt, kk, ah, al);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int j = j0 + 2 * jj;
          if (j >= nt_f) break;
          const uint4 b = w0t[((long)kk * nt_f + j) * 32 + lane];
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(f, ah, al, b.x, b.y, b.z, b.w);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e] += f[e];
        }
      }
      float* df = dfeat_t + (long)i * f_dim * m + r0;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = j0 + 2 * jj;
        if (j >= nt_f) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 8 * j + 2 * u + (e & 1), r = 16 * mt + g + 8 * (e >> 1);
          if (f < f_dim && r0 + r < m) df[(long)f * m + r] = acc[jj][e];
        }
      }
    }
  }
  if (batched) {
    __syncthreads();
    flush_batch();
  }
}

}  // namespace tf

// Where float j of a backward's partial (part_off's layout) goes in params'
// layout (W_l row-major, then b_l), or -1 for the rows of a chunk past k_in;
// acc(y, row, col) maps float y of a chunk to its row (< CHUNK_ROWS) and
// column, the order of the kernel's accumulators.
template <typename Acc>
__device__ __forceinline__ long part_dst(long j, int d1, int n_layers, Acc acc) {
  using namespace tf;
  int l = 0;
  while (l + 1 < n_layers && j >= part_off(l + 1, d1)) ++l;
  const int rows = l ? HID : d1;
  const long x = j - part_off(l, d1), n_dw = (long)part_chunks(l, d1) * CHUNK;
  const long dst = l ? (long)d1 * HID + HID + (long)(l - 1) * (HID * HID + HID) : 0L;  // W_l
  if (x >= n_dw) return dst + (long)rows * HID + (x - n_dw);                          // b_l
  int row, col;
  acc((int)(x % CHUNK), row, col);
  row += CHUNK_ROWS * (int)(x / CHUNK);
  return row < rows ? dst + (long)row * HID + col : -1L;
}

// tf::dw_product's order: float4 q of thread t holds acc[q / 8][q % 8][0..3].
struct TfAcc {
  __device__ void operator()(int y, int& row, int& col) const {
    using namespace tf;
    const int q = y / (4 * HID), t = y / 4 % HID, e = y % 4;
    const int warp = t >> 5, g = (t & 31) >> 2, u = t & 3;
    row = (warp / WARPS_N) * (CHUNK_ROWS / WARPS_M) + 16 * (q / N_TILES) + g + 8 * (e >> 1);
    col = 8 * ((warp % WARPS_N) * N_TILES + q % N_TILES) + 2 * u + (e & 1);
  }
};

// ---------------------------------------------------------------------------
// Backward, bf16 (the fast stage-1 path's K6b), on the tensor cores:
// tc::mlp_posenc_wsum_bwd. npcd_tpu's low-precision backward (_BF16_BWD,
// fused_mlp.py:509-560) of the same contract as tf::mlp_posenc_wsum_bwd:
// every product is a bf16 x bf16 product with f32 sums, npcd_tpu's _kdot on
// bf16 operands with preferred_element_type f32, on mma.sync.m16n8k16
// (csrc/bf16_mma.cuh). The rounding points are npcd_tpu's: h0 rounded to
// bf16; each recomputed layer z = bf16(bf16(acc) + b), act = max(z, bf16(z
// bf16(0.01))), kept as bf16; the per-pair cotangent g = w_r g_out[n] in f32,
// leaky'(z) = 1 where act > 0 (exactly where z > 0), else 0.01 (f32); db_l the
// f32 sum of the unrounded g, gd = bf16(g) into the dW and dX products; the
// last layer's dW over points, hw = bf16(sum_j w_j act[n k + j]) (f32, j
// order) and dW_L += hw^T g_out (fast_last), its dX per pair (gd differs per
// pair); dfeat = bf16(gd_0 W_0[:F]^T); dW/db rounded to bf16 once, after the
// blocks' partials are summed in block order (reduce_partials_bf16).
//
// Bound: ~1.44 Mflop a pair at the configs' 95 -> 256 x 4 -> 256, k 8 (the
// recompute, dX of every layer per pair, dW of the hidden layers per pair and
// the last one's per point, dfeat), 8.27 TFLOP at the fast step's 5.73M
// pairs: 8.36 ms at 989 TFLOP/s. The CUDA-core kernel this one replaced ran
// at 1.6% of it.
//
// A block of 16 warps takes a tile of 256 pairs as two sub-tiles of 128: a
// layer product [128, 256] x [256, 256] tiles its output 4 x 4 over the
// warps (32 rows x 64 columns a warp, 2 x 8 m16n8 tiles, 64 f32 accumulators
// a thread), so each A fragment feeds 8 n-tiles and each B fragment 2
// m-tiles. The tile's [256][264] bf16 buffer (132 KB) holds one activation
// or cotangent of all 256 pairs: h0, then act_0 .. act_{L-2} of each
// sub-tile in place (a layer's output waits in the accumulators until every
// warp has read its input), then gd_{L-1} .. gd_0 in place. Weights stream
// through a 2-stage cp.async ring straight from params, 64 k a slab: W's rows
// for the recompute (read by ldmatrix.trans), its columns for the dX
// products (ldmatrix), so no transposed copy is made.
//
// The dW products contract over the tile's 256 pairs (npcd_tpu sums over
// every pair into VMEM scratch across its sequential grid; blocks here run
// in no order). The grid is persistent, one block an SM: block b takes tiles
// b, b + grid, ... and adds each tile's dW/db into its own f32 partial,
// which reduce_partials_bf16 sums in block order, so the result depends only
// on the inputs and the grid size (bitwise repeatable). A partial is 1.15 MB
// and 132 of them do not fit in L2, so its read-modify-write is paid in HBM
// bytes: 2.3 MB an update, 62 ms at the fast step if a block updated it
// every 64 pairs; every 256 pairs, a quarter of that. The dW products take
// their activations (h0 and act_0 .. act_{L-3}, stored to a per-block bf16
// scratch at the recompute) 64 columns at a time, double-buffered in shared
// memory, and the cotangent gd_l from the tile buffer (both by
// ldmatrix.trans), 64 rows of dW a chunk, 2 x 8 warps of 32 x 32, each
// thread's old partial values loaded to registers before the chunk's
// product and stored back after it, in the accumulators' order (512
// contiguous bytes a warp). The last layer's hw and g_out go to a per-block
// batch of 256 points (the block's tiles in order; 32 points a tile at k 8),
// whose dW product (its g_out staged in the tile buffer) runs when the next
// tile's points do not fit, and after the last tile. The leaky' slopes are
// bits: the recompute's epilogue stores each thread's z > 0 (64 bits a layer
// and sub-tile) in the scratch, and the dX epilogue of the same thread reads
// them back (the two products tile their outputs alike).

namespace tc {

constexpr int BATCH = 256;     // points of the last layer's dW batch

// Shared memory: the tile buffer [TILE][LDA] bf16, the ring [RING] bf16,
// the pair weights [TILE] and the column sums red [4][HID] f32 (~209 KB):
// one block an SM.
__global__ void __launch_bounds__(NT, 1)
mlp_posenc_wsum_bwd(const bf16* __restrict__ feat_t, const float* __restrict__ pos_t,
                    const bf16* __restrict__ params, const bf16* __restrict__ g_out,
                    bf16* __restrict__ dfeat_t, float* __restrict__ partial,
                    bf16* __restrict__ scratch, int inst, int m, int f_dim, int pos_rows,
                    int n_layers, int n_freqs, int anchor, float freq_c0, int k, long n_partial) {
  extern __shared__ __align__(16) float sbuf[];
  bf16* tile = reinterpret_cast<bf16*>(sbuf);
  bf16* ring = tile + TILE * LDA;
  float* wpair = reinterpret_cast<float*>(ring + RING);
  float* red = wpair + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, u = lane & 3;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs), d1p = (d1 + 15) & ~15;
  const int n_pts = m / k, pts = TILE / k;
  const int tiles_per_inst = (m + TILE - 1) / TILE;
  const long n_tiles = (long)inst * tiles_per_inst;
  // the block's scratch, slots of [TILE][HID] bf16: h0 (row stride d1p), act_0
  // .. act_{L-3}, the batch's hw and g_out, the mask words [L-1][2][2][NT]
  constexpr long SLOT = (long)TILE * HID;
  bf16* h0s = scratch + (long)blockIdx.x * (n_layers + 2) * SLOT;
  bf16* batch_hw = h0s + (long)(n_layers - 1) * SLOT;
  bf16* batch_g = batch_hw + SLOT;
  unsigned* masks = reinterpret_cast<unsigned*>(batch_g + SLOT);
  auto acts = [&](int l) { return h0s + (long)(l + 1) * SLOT; };
  auto mask_at = [&](int l, int s, int w) { return masks + ((l * 2 + s) * 2 + w) * NT + tid; };
  int batched = 0;  // points in the batch
  // W_l and b_l in params; dW_l and db_l in the block's partial (part_off)
  auto w_off = [&](int l) {
    return l ? (long)d1 * HID + HID + (long)(l - 1) * (HID * HID + HID) : 0L;
  };
  auto b_off = [&](int l) { return w_off(l) + (long)(l ? HID : d1) * HID; };
  auto dw_part = [&](int l) { return partial + blockIdx.x * n_partial + tf::part_off(l, d1); };
  auto db_part = [&](int l) { return dw_part(l) + (long)tf::part_chunks(l, d1) * tf::CHUNK; };
  // dW_{L-1} += hw^T g_out over the batch, its g_out staged in the tile buffer
  auto flush = [&]() {
    __syncthreads();  // the batch's rows are written; the tile buffer is free
    for (int idx = tid; idx < TILE * HID / 8; idx += NT) {
      const int r = idx / (HID / 8), c = idx % (HID / 8) * 8;
      cp16(tile + r * LDA + c, batch_g + (r < batched ? (long)r * HID + c : 0), r < batched);
    }
    cp_commit();
    dw_product(dw_part(n_layers - 1), batch_hw, HID, HID, batched, tile, ring);
    batched = 0;
  };

  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int i = (int)(t / tiles_per_inst), r0 = (int)(t % tiles_per_inst) * TILE;
    if (batched + pts > BATCH) flush();
    __syncthreads();  // the last tile is done with the tile buffer, wpair and red
    build_input<bf16, TILE, NT>(feat_t + (long)i * f_dim * m, pos_t + (long)i * pos_rows * m,
                                tile, wpair, r0, m, f_dim, n_freqs, anchor, freq_c0, d1, LDA,
                                d1p, tid);
    __syncthreads();
    for (int idx = tid; idx < TILE * d1p / 8; idx += NT) {
      const int r = idx / (d1p / 8), c = idx % (d1p / 8) * 8;
      *reinterpret_cast<uint4*>(h0s + (long)r * d1p + c) =
          *reinterpret_cast<const uint4*>(tile + r * LDA + c);
    }

    // ---- recompute layers 0 .. L-2 of each sub-tile, in place ---------------
    for (int s = 0; s < 2; ++s) {
      bf16* act = tile + s * SUB * LDA;
      for (int l = 0; l < n_layers - 1; ++l) {
        unsigned mk[2];
        layer_bf16(act, params + w_off(l), params + b_off(l), l ? HID : d1,
                   (l ? HID : d1p) / 16, ring, mk);
        *mask_at(l, s, 0) = mk[0];
        *mask_at(l, s, 1) = mk[1];
        if (l < n_layers - 2) {  // act_l to the scratch, for dW_{l+1}
          __syncthreads();
          bf16* dst = acts(l) + (long)s * SUB * HID;
          for (int idx = tid; idx < SUB * HID / 8; idx += NT) {
            const int r = idx / (HID / 8), c = idx % (HID / 8) * 8;
            *reinterpret_cast<uint4*>(dst + (long)r * HID + c) =
                *reinterpret_cast<const uint4*>(act + r * LDA + c);
          }
        }
      }
    }
    __syncthreads();  // the tile buffer holds act_{L-2} of both sub-tiles

    // ---- the last layer: hw and g_out to the batch, gd_{L-1} in place -------
    // thread (c, half) owns column c of the half's pairs: per point, hw =
    // bf16(sum_j w_j act_{L-2}) in j order, then gd = bf16(w_r g_out) and db
    // over its pairs in order (f32)
    {
      const int c = tid % HID, half = tid / HID;
      const long g_row = (long)i * n_pts + r0 / k;
      float db = 0.f;
#pragma unroll 4
      for (int q = half * pts / 2; q < (half + 1) * pts / 2; ++q) {
        const bf16 gb = r0 / k + q < n_pts ? g_out[(g_row + q) * HID + c]
                                           : __float2bfloat16_rn(0.f);
        const float go = __bfloat162float(gb);
        float s = 0.f;
        for (int j = 0; j < k; ++j) {
          bf16* x = tile + (q * k + j) * LDA + c;
          const float w = wpair[q * k + j], gv = __fmul_rn(w, go);
          s = __fadd_rn(s, __fmul_rn(__bfloat162float(*x), w));
          db += gv;
          *x = __float2bfloat16_rn(gv);
        }
        batch_hw[(long)(batched + q) * HID + c] = __float2bfloat16_rn(s);
        batch_g[(long)(batched + q) * HID + c] = gb;
      }
      red[half * HID + c] = db;
      __syncthreads();
      if (tid < HID) db_part(n_layers - 1)[tid] += red[tid] + red[HID + tid];
    }
    batched += pts;

    // ---- layers L-1 .. 1: the tile buffer holds gd_l --------------------------
    for (int l = n_layers - 1; l >= 1; --l) {
      if (l < n_layers - 1)  // dW_l += act_{l-1}^T gd_l over the tile's pairs
        dw_product(dw_part(l), acts(l - 1), HID, HID, TILE, tile, ring);
      for (int s = 0; s < 2; ++s) {  // g_{l-1} = (gd_l W_l^T) leaky'(act_{l-1})
        const unsigned mk[2] = {*mask_at(l - 1, s, 0), *mask_at(l - 1, s, 1)};
        float acc[2][8][4];
        layer_product<true>(acc, tile + s * SUB * LDA, params + w_off(l), HID, HID / 16, ring);
        dx_epilogue(acc, mk, tile + s * SUB * LDA, red);
        if (tid < HID)
          db_part(l - 1)[tid] +=
              ((red[tid] + red[HID + tid]) + red[2 * HID + tid]) + red[3 * HID + tid];
      }
    }

    // ---- layer 0: dW_0 += h0^T gd_0; dfeat = bf16(gd_0 W_0[:F]^T) ------------
    dw_product(dw_part(0), h0s, d1p, d1, TILE, tile, ring);
    {
      __syncthreads();  // every warp is done with the ring
      const int f16 = (f_dim + 15) & ~15, nt_f = (f_dim + 7) / 8;
      for (int idx = tid; idx < f16 * HID / 8; idx += NT) {  // W_0[:F] as [f16][LDA]
        const int r = idx / (HID / 8), c = idx % (HID / 8) * 8;
        const bool ok = r < f_dim;
        cp16(ring + r * LDA + c, params + (ok ? (long)r * HID + c : 0), ok);
      }
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      // warp w: m-tile w % 8, n-tiles w / 8, + 2, + 4, + 6 of the nt_f (F <= 64)
      const int mt = warp & 7;
      for (int s = 0; s < 2; ++s) {
        float acc[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < HID / 16; ++kk) {
          unsigned a[4];
          frag_a(a, tile + s * SUB * LDA, LDA, 16 * mt, 16 * kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = (warp >> 3) + 2 * jj;
            if (j < nt_f) {
              unsigned b[2];
              ldsm2(b, ring + (8 * j + (lane & 7)) * LDA + 16 * kk + ((lane >> 3) & 1) * 8);
              mma(acc[jj], a, b[0], b[1]);
            }
          }
        }
        bf16* df = dfeat_t + (long)i * f_dim * m + r0 + s * SUB;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = (warp >> 3) + 2 * jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = 8 * j + 2 * u + (e & 1), r = 16 * mt + g + 8 * (e >> 1);
            if (j < nt_f && f < f_dim && r0 + s * SUB + r < m)
              df[(long)f * m + r] = __float2bfloat16_rn(acc[jj][e]);
          }
        }
      }
    }
  }
  if (batched) flush();
}

// ---------------------------------------------------------------------------
// Forward, bf16 (the fast stage-1 path's K6f), on the tensor cores:
// tc::mlp_posenc_wsum. npcd_tpu's _fwd_posenc_kernel with bf16 weights and
// reduce_k, on the blocks of the bf16 backward above. A block of 16 warps
// takes a tile of 128 pairs (one sub-tile: 16 points at k 8): build_input
// writes h0 as bf16 straight into the [128][264] tile buffer (columns d1 ..
// d1p zero), layers 0 .. L-2 run in place through layer_bf16, the backward's
// recompute unchanged in its arithmetic (the same k-step order over W's rows,
// streamed through the cp.async ring 64 rows a slab, the same bf16x2
// epilogue; its slope bits are dropped), so a hidden activation here is
// bitwise the one the backward recomputes: an mma's sum for one output
// element depends only on its sequence of 16-deep k-steps, not on how the
// rows are tiled or how deep the ring is. The ring has three stages here
// (two slabs ahead; the backward's two leave no room): on the H100 that read
// 2-3% faster than two stages, and four no faster than three, so the weight
// stream's latency is not what bounds the kernel (PERF.md). The last
// layer is layer_product<false> with the epilogue last_bf16, z =
// bf16(bf16(acc) + b) and no activation, written back to the buffer after a
// barrier. Then one
// thread per (point, two columns) reads the point's k rows in j order and
// writes bf16 of the f32 sum of __fmul_rn(z, w) (__fadd_rn, from 0). Lanes
// past the last pair are built as zeros with weight 0 and never written. No
// state crosses blocks, so the grid is (tiles, instances). Shared memory: the
// tile buffer, the ring [3 STAGE] and the pair weights (~174 KB): one block
// an SM.
__global__ void __launch_bounds__(NT, 1)
mlp_posenc_wsum(const bf16* __restrict__ feat_t, const float* __restrict__ pos_t,
                const bf16* __restrict__ params, bf16* __restrict__ out, int m, int f_dim,
                int pos_rows, int n_layers, int n_freqs, int anchor, float freq_c0, int k) {
  extern __shared__ __align__(16) float sbuf[];
  bf16* act = reinterpret_cast<bf16*>(sbuf);
  bf16* ring = act + SUB * LDA;
  float* wpair = reinterpret_cast<float*>(ring + FWD_STAGES * STAGE);

  const int tid = threadIdx.x;
  const int inst = blockIdx.y, r0 = blockIdx.x * SUB;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs), d1p = (d1 + 15) & ~15;
  // h0; the first layer product's barrier makes it visible
  build_input<bf16, SUB, NT>(feat_t + (long)inst * f_dim * m, pos_t + (long)inst * pos_rows * m,
                             act, wpair, r0, m, f_dim, n_freqs, anchor, freq_c0, d1, LDA, d1p, tid);

  // ---- layers 0 .. L-2 in place, as the backward recomputes them ----------
  const bf16* p = params;  // W_l, then b_l
  for (int l = 0; l < n_layers - 1; ++l) {
    const int kin = l ? HID : d1;
    unsigned mk[2];
    layer_bf16<FWD_STAGES>(act, p, p + (long)kin * HID, kin, (l ? HID : d1p) / 16, ring, mk);
    p += (long)kin * HID + HID;
  }

  // ---- the last layer per pair in place: z = bf16(bf16(acc) + b) ---------
  {
    const int kin = n_layers > 1 ? HID : d1;
    float acc[2][8][4];
    layer_product<false, FWD_STAGES>(acc, act, p, kin, (n_layers > 1 ? HID : d1p) / 16, ring);
    last_bf16(acc, p + (long)kin * HID, act);
  }
  __syncthreads();

  // ---- the k-weighted sum: thread (point q, columns c, c + 1), j order -----
  const int n_pts = m / k, pt0 = r0 / k;
  for (int idx = tid; idx < SUB / k * (HID / 2); idx += NT) {
    const int q = idx / (HID / 2), c = idx % (HID / 2) * 2;
    if (pt0 + q >= n_pts) break;
    float s0 = 0.f, s1 = 0.f;
    for (int j = 0; j < k; ++j) {
      const unsigned z = *reinterpret_cast<const unsigned*>(act + (q * k + j) * LDA + c);
      const float w = wpair[q * k + j];
      s0 = __fadd_rn(s0, __fmul_rn(lo(z), w));
      s1 = __fadd_rn(s1, __fmul_rn(hi(z), w));
    }
    *reinterpret_cast<unsigned*>(out + ((long)inst * n_pts + pt0 + q) * HID + c) = pack(s0, s1);
  }
}

}  // namespace tc

// The backwards' partials summed over the blocks in order, partial[b][j]
// (part_off's layout, n floats a block), into out in params' layout: bf16
// (tc::dw_product's order, rounded once), f32 (tf::dw_product's).
__global__ void reduce_partials_bf16(const float* __restrict__ partial, int n_blocks, long n,
                                     int d1, int n_layers, bf16* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long dst = part_dst(j, d1, n_layers, tc::Acc());
  if (dst < 0) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n + j];
  out[dst] = __float2bfloat16_rn(s);
}

__global__ void reduce_partials_tf32(const float* __restrict__ partial, int n_blocks, long n,
                                     int d1, int n_layers, float* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const long dst = part_dst(j, d1, n_layers, TfAcc());
  if (dst < 0) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n + j];
  out[dst] = s;
}

// The f32 forward: split_weights, then tf::mlp_posenc_wsum.
int launch_tf32(const float* feat_t, const float* pos_t, const float* params, uint4* wsplit,
                float* out, int inst, int m, int f_dim, int pos_rows, int n_layers, int n_freqs,
                int anchor, float freq_c0, int k, cudaStream_t stream) {
  constexpr int P = tf::BLOCK_PAIRS;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int n_slabs = (d1 + 7) / 8 + (n_layers - 1) * (HID / 8);
  const int threads = 256;
  split_weights<<<(n_slabs * SLAB + threads - 1) / threads, threads, 0, stream>>>(
      params, wsplit, d1, n_slabs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem =
      16 * tf::STAGES * SLAB + static_cast<int>(sizeof(float)) * (P * tf::LDA + 2 * P);
  const int e = allow_smem(tf::mlp_posenc_wsum, smem);
  if (e) return e;
  tf::mlp_posenc_wsum<<<dim3((m + P - 1) / P, inst), HID, smem, stream>>>(
      feat_t, pos_t, params, wsplit, out, m, f_dim, pos_rows, n_layers, n_freqs, anchor, freq_c0,
      k);
  return static_cast<int>(cudaGetLastError());
}

// The f32 backward: split_weights_t (W^T of layers L-1 .. 1, then W_0[:F]^T),
// tf::mlp_posenc_wsum_bwd (its recompute reads the raw f32 params), then
// reduce_partials_tf32.
int launch_bwd_tf32(const float* feat_t, const float* pos_t, const float* params,
                    uint4* wsplit, const float* g_out, float* dfeat_t, float* dparams,
                    float* partial, float* scratch, int inst, int m, int f_dim, int pos_rows,
                    int n_layers, int n_freqs, int anchor, float freq_c0, int k, int n_blocks,
                    long n_partial, cudaStream_t stream) {
  constexpr int P = tf::BLOCK_PAIRS;
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  if (n_layers < 2 || n_layers > 8 || n_partial != tf::part_off(n_layers, d1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_t = (long)(n_layers - 1) * (HID / 8) * SLAB + (HID / 8) * ((f_dim + 7) / 8) * 32;
  const int threads = 256;
  split_weights_t<<<(int)((n_t + threads - 1) / threads), threads, 0, stream>>>(
      params, wsplit, d1, f_dim, n_layers);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 16 * tf::STAGES * SLAB +
                   static_cast<int>(sizeof(float)) * (2 * P * tf::LDA + 2 * P + 2 * 32 * HID);
  const int e = allow_smem(tf::mlp_posenc_wsum_bwd, smem);
  if (e) return e;
  tf::mlp_posenc_wsum_bwd<<<n_blocks, HID, smem, stream>>>(
      feat_t, pos_t, params, wsplit, g_out, dfeat_t, partial, scratch, inst, m, f_dim, pos_rows,
      n_layers, n_freqs, anchor, freq_c0, k, n_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_tf32<<<(int)((n_partial + threads - 1) / threads), threads, 0, stream>>>(
      partial, n_blocks, n_partial, d1, n_layers, dparams);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward: tc::mlp_posenc_wsum_bwd, then reduce_partials_bf16.
int launch_bwd_bf16(const bf16* feat_t, const float* pos_t, const bf16* params,
                    const bf16* g_out, bf16* dfeat_t, bf16* dparams, float* partial,
                    bf16* scratch, int inst, int m, int f_dim, int pos_rows, int n_layers,
                    int n_freqs, int anchor, float freq_c0, int k, int n_blocks, long n_partial,
                    cudaStream_t stream) {
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  if (n_layers < 2 || n_layers > 8 || d1 > HID || f_dim > 64 || tc::TILE % k ||
      n_partial != tf::part_off(n_layers, d1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(bf16)) * (tc::TILE * tc::LDA + tc::RING) +
                   static_cast<int>(sizeof(float)) * (tc::TILE + 4 * HID);
  const int e = allow_smem(tc::mlp_posenc_wsum_bwd, smem);
  if (e) return e;
  tc::mlp_posenc_wsum_bwd<<<n_blocks, tc::NT, smem, stream>>>(
      feat_t, pos_t, params, g_out, dfeat_t, partial, scratch, inst, m, f_dim, pos_rows,
      n_layers, n_freqs, anchor, freq_c0, k, n_partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  reduce_partials_bf16<<<(int)((n_partial + threads - 1) / threads), threads, 0, stream>>>(
      partial, n_blocks, n_partial, d1, n_layers, dparams);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feat_t [inst, f_dim, m], pos_t [inst, pos_rows >= 4, m] (f32), out
// [inst, m / k, 256], all contiguous; feat_t, params and out are f32
// (fused_mlp_posenc_wsum_fwd) or bf16 (..._fwd_bf16). params packs the
// layers in order as W [k_in, 256] (row-major, k_in = f_dim + 3*(1 +
// 2*n_freqs) for the first layer, 256 after) followed by b [256]. Octave j
// of the positional encoding is evaluated directly where anchor divides j
// (anchor >= 1; build_input). Returns cudaGetLastError() after launch.
//
// f32 (3xTF32, 64 pairs a block): wsplit is scratch for the split
// weights, 16 KB for each k-step of 8 rows ((k_in0 + 7) / 8 + (n_layers -
// 1) * 32 of them), 16-byte aligned; k must divide 64, and k_in0 <= 256.
extern "C" int fused_mlp_posenc_wsum_fwd(const void* feat_t, const void* pos_t,
                                         const void* params, void* wsplit, void* out, int inst,
                                         int m, int f_dim, int pos_rows, int n_layers,
                                         int n_freqs, int anchor, float freq_c0, int k,
                                         void* stream) {
  return launch_tf32(static_cast<const float*>(feat_t), static_cast<const float*>(pos_t),
                     static_cast<const float*>(params), static_cast<uint4*>(wsplit),
                     static_cast<float*>(out), inst, m, f_dim, pos_rows, n_layers, n_freqs,
                     anchor, freq_c0, k, static_cast<cudaStream_t>(stream));
}

// bf16 (tc::mlp_posenc_wsum, 128 pairs a block): k must divide 128, and
// k_in0 <= 256.
extern "C" int fused_mlp_posenc_wsum_fwd_bf16(const void* feat_t, const void* pos_t,
                                              const void* params, void* out, int inst,
                                              int m, int f_dim, int pos_rows,
                                              int n_layers, int n_freqs,
                                              int anchor, float freq_c0, int k,
                                              void* stream) {
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  if (n_layers < 1 || d1 > HID || k < 1 || tc::SUB % k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      static_cast<int>(sizeof(bf16)) * (tc::SUB * tc::LDA + tc::FWD_STAGES * tc::STAGE) +
      static_cast<int>(sizeof(float)) * tc::SUB;
  const int e = allow_smem(tc::mlp_posenc_wsum, smem);
  if (e) return e;
  tc::mlp_posenc_wsum<<<dim3((m + tc::SUB - 1) / tc::SUB, inst), tc::NT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(feat_t), static_cast<const float*>(pos_t),
      static_cast<const bf16*>(params), static_cast<bf16*>(out), m, f_dim, pos_rows, n_layers,
      n_freqs, anchor, freq_c0, k);
  return static_cast<int>(cudaGetLastError());
}

// Backward of fused_mlp_posenc_wsum_fwd{,_bf16} for the same feat_t, pos_t
// and params, with g_out [inst, m / k, 256] the output cotangent (the type of
// feat_t). Writes dfeat_t [inst, f_dim, m] and dparams (dW/db packed as
// params, the type of feat_t) through partial [n_blocks, n_params] f32
// (zeroed by the caller; n_params = fused_mlp_posenc_partial_len(k_in0,
// n_layers)) and a scratch. 2 <= n_layers <= 8, k_in0 <= 256, and k must
// divide 64. Returns the first CUDA error, or cudaSuccess.
//
// f32 (tf::mlp_posenc_wsum_bwd, 3xTF32): scratch [n_blocks, n_layers, 64,
// 256] f32; wsplit is scratch for W^T split by split_weights_t, 16-byte
// aligned: (n_layers - 1) * 32 + (f_dim + 7) / 8 slabs of 16 KB.
extern "C" int fused_mlp_posenc_wsum_bwd(
    const void* feat_t, const void* pos_t, const void* params, void* wsplit,
    const void* g_out, void* dfeat_t, void* dparams, void* partial, void* scratch,
    int inst, int m, int f_dim, int pos_rows, int n_layers, int n_freqs, int anchor,
    float freq_c0, int k, int n_blocks, long n_params, void* stream) {
  return launch_bwd_tf32(static_cast<const float*>(feat_t), static_cast<const float*>(pos_t),
                         static_cast<const float*>(params), static_cast<uint4*>(wsplit),
                         static_cast<const float*>(g_out), static_cast<float*>(dfeat_t),
                         static_cast<float*>(dparams), static_cast<float*>(partial),
                         static_cast<float*>(scratch), inst, m, f_dim, pos_rows, n_layers,
                         n_freqs, anchor, freq_c0, k, n_blocks, n_params,
                         static_cast<cudaStream_t>(stream));
}

// The length of a block's f32 partial (tf::part_off's layout, both
// backwards) for a layer-1 input of k_in0 columns.
extern "C" long fused_mlp_posenc_partial_len(int k_in0, int n_layers) {
  return tf::part_off(n_layers, k_in0);
}

// bf16 (tc::mlp_posenc_wsum_bwd, mma.sync bf16): scratch [n_blocks,
// n_layers + 2, 256, 256] bf16; k_in0 <= 256, f_dim <= 64.
extern "C" int fused_mlp_posenc_wsum_bwd_bf16(
    const void* feat_t, const void* pos_t, const void* params, const void* g_out,
    void* dfeat_t, void* dparams, void* partial, void* scratch, int inst, int m, int f_dim,
    int pos_rows, int n_layers, int n_freqs, int anchor, float freq_c0, int k, int n_blocks,
    long n_partial, void* stream) {
  return launch_bwd_bf16(static_cast<const bf16*>(feat_t), static_cast<const float*>(pos_t),
                         static_cast<const bf16*>(params), static_cast<const bf16*>(g_out),
                         static_cast<bf16*>(dfeat_t), static_cast<bf16*>(dparams),
                         static_cast<float*>(partial), static_cast<bf16*>(scratch), inst, m,
                         f_dim, pos_rows, n_layers, n_freqs, anchor, freq_c0, k, n_blocks,
                         n_partial,
                         static_cast<cudaStream_t>(stream));
}
