// The bf16 tensor-core layer routines of the MLP kernels of
// csrc/fused_mlp_posenc.cu (the bf16 K6f and K6b) and csrc/fused_mlp.cu (K7f
// and K7b), in namespace tc, on csrc/bf16_mma.cuh's mma.sync.m16n8k16: a
// block of 16 warps runs a layer product [128, 256] x [256, 256] over a
// sub-tile of 128 rows, its output tiled 4 x 4 over the warps (32 rows x 64
// columns a warp, 2 x 8 m16n8 tiles, 64 f32 accumulators a thread), the
// weights streamed from global memory through a cp.async ring, 64 k a slab:
// W's rows for a forward product (ldmatrix.trans), its columns for a dX
// product (ldmatrix), so no transposed copy is made. layer_bf16 is one
// hidden layer with npcd_tpu's bf16 rounding points (z = bf16(bf16(acc) +
// b), act = max(z, bf16(z bf16(0.01)))) and the bits z > 0, last_bf16 a
// last layer's z = bf16(bf16(acc) + b); dx_epilogue the
// backward's g leaky' (f32 0.01), its column sums for db and gd = bf16(g);
// dw_product a dW product X^T Y over a tile of up to 256 rows added into a
// block's f32 partial in the accumulators' order (Acc). An mma's sum for one
// output element depends only on its sequence of 16-deep k-steps, so every
// kernel built on layer_bf16 gives bitwise the same activations, however it
// tiles its rows or however deep its ring is.

#pragma once

#include <cuda_bf16.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {
namespace tc {

constexpr int HID = 256;  // width of every hidden layer
constexpr float LEAKY_BF16 = 0.010009765625f;  // bf16(0.01)

constexpr int NT = 512;        // threads: 16 warps
constexpr int SUB = 128;       // rows of a sub-tile: one layer product's rows
constexpr int TILE = 2 * SUB;  // rows a tile; the dW products contract over them
constexpr int LDA = HID + 8;   // row stride of the tile buffer (528 bytes)
constexpr int KS = 4;          // 16-deep k-steps a slab of the ring
constexpr int LDC = 16 * KS + 8;  // row stride of a W column slab (144 bytes)
constexpr int LDX = 72;        // of a dW product's activation chunk (144 bytes)
// elements of a stage of the two-stage weight ring: a W row slab [16 KS][LDA]
// or column slab [HID][LDC]
constexpr int STAGE = HID * LDC;
// the ring's memory, which also holds dw_product's two activation chunks
// [TILE][LDX] (and K6b's dfeat product's W_0[:F] [64][LDA])
constexpr int RING = 2 * TILE * LDX;
static_assert(2 * STAGE <= RING && 16 * KS * LDA <= STAGE, "ring");
constexpr int FWD_STAGES = 3;  // the forward's ring: two slabs ahead
// a block's partial dW holds each layer's dW in chunks of CHUNK_ROWS rows
constexpr int CHUNK_ROWS = 64, CHUNK = CHUNK_ROWS * HID;

__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// A layer product over one sub-tile, acc = a . W (recompute; WT false:
// `steps` k-steps of 16 over W's rows, those from kin on zero) or acc = a .
// W^T (dX; WT true: 16 k-steps over W's 256 columns, W's rows from kin on,
// the output's columns, zero); a [SUB][LDA] in shared memory, W [..][HID]
// row-major in global memory, streamed KS k-steps a slab through the S
// stages of the ring ([S][STAGE]) by cp.async, S - 1 slabs ahead. Warp w
// computes rows 32 (w / 4) .. + 32, columns 64 (w % 4) .. + 64. FRESH false
// adds the product to acc (a product over a chunk of a wider input: an
// output element's sum is then its k-steps over both chunks, in order).
template <bool WT, int S = 2, bool FRESH = true>
__device__ __forceinline__ void layer_product(float (&acc)[2][8][4], const bf16* a,
                                              const bf16* __restrict__ W, int kin, int steps,
                                              bf16* ring) {
  const int tid = threadIdx.x, warp = tid >> 5, r0 = (warp >> 2) * 32, n0 = (warp & 3) * 64;
  const int slabs = (steps + KS - 1) / KS;
  auto load = [&](int t) {  // slab t into stage t % S, one copy group (empty past the last)
    bf16* st = ring + t % S * STAGE;
    for (int idx = tid; t < slabs && idx < 16 * KS * HID / 8; idx += NT) {
      if (WT) {  // W's columns 16 KS t .. + 16 KS of its 256 rows, [HID][LDC]
        const int r = idx / (2 * KS), c = idx % (2 * KS) * 8;
        const bool ok = r < kin;
        cp16(st + r * LDC + c, W + (ok ? (long)r * HID + 16 * KS * t + c : 0), ok);
      } else {  // W's rows 16 KS t .. + 16 KS, [16 KS][LDA]
        const int r = idx / (HID / 8), c = idx % (HID / 8) * 8;
        const bool ok = 16 * KS * t + r < kin;
        cp16(st + r * LDA + c, W + (ok ? (long)(16 * KS * t + r) * HID + c : 0), ok);
      }
    }
    cp_commit();
  };
  if (FRESH) zero(acc);
  __syncthreads();  // the last user of the ring is done with it
  for (int t = 0; t < S - 1; ++t) load(t);
  for (int t = 0; t < slabs; ++t) {
    cp_wait<S - 2>();
    __syncthreads();  // slab t landed for every thread; stage (t - 1) % S is free
    load(t + S - 1);
    const bf16* st = ring + t % S * STAGE;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (KS * t + kk < steps) {
        const int k0 = 16 * (KS * t + kk);
        unsigned a0[4], a1[4];
        frag_a(a0, a, LDA, r0, k0);
        frag_a(a1, a, LDA, r0 + 16, k0);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          unsigned b[4];
          if (WT) {
            frag_bt(b, st, LDC, 16 * kk, n0 + 16 * jp);
          } else {
            frag_b(b, st, LDA, 16 * kk, n0 + 16 * jp);
          }
          mma(acc[0][2 * jp], a0, b[0], b[1]);
          mma(acc[1][2 * jp], a1, b[0], b[1]);
          mma(acc[0][2 * jp + 1], a0, b[2], b[3]);
          mma(acc[1][2 * jp + 1], a1, b[2], b[3]);
        }
      }
    }
  }
}

// The epilogue of a hidden bf16 layer over a sub-tile, in place, after a
// barrier (every warp has read its last A fragment of act): act <-
// leaky(bf16(bf16(acc) + b)) with npcd_tpu's rounding points (z =
// bf16(bf16(acc) + b), max(z, bf16(z bf16(0.01)))); mask receives the
// thread's bits z > 0, bit 4 j + e of word i for acc[i][j][e].
__device__ __forceinline__ void hidden_bf16(const float (&acc)[2][8][4],
                                            const bf16* __restrict__ bias, bf16* act,
                                            unsigned (&mask)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, u = lane & 3;
  const int r0 = (warp >> 2) * 32, n0 = (warp & 3) * 64;
  __syncthreads();  // every warp has read its last A fragment
  mask[0] = mask[1] = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * u;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // two columns at a time, as bf16x2
        const unsigned y = pack(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        const unsigned z = pack(lo(y) + b0, hi(y) + b1);
        const unsigned zl = pack(lo(z) * LEAKY_BF16, hi(z) * LEAKY_BF16);
        mask[i] |= (lo(z) > 0.f ? 1u : 0u) << (4 * j + 2 * h);
        mask[i] |= (hi(z) > 0.f ? 1u : 0u) << (4 * j + 2 * h + 1);
        const __nv_bfloat162 v = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&z),
                                         *reinterpret_cast<const __nv_bfloat162*>(&zl));
        *reinterpret_cast<__nv_bfloat162*>(act + (r0 + 16 * i + g + 8 * h) * LDA + col) = v;
      }
  }
}

// One hidden bf16 layer of the stack over a sub-tile, in place: the product
// act . W (W [kin][HID] and b in global memory, `steps` k-steps of 16; act
// is zero in columns kin .. 16 steps), then hidden_bf16. The bf16 forward's
// hidden layers are the same product and epilogue (on a ring of S stages:
// the same sums).
template <int S = 2>
__device__ __forceinline__ void layer_bf16(bf16* act, const bf16* __restrict__ W,
                                           const bf16* __restrict__ bias, int kin, int steps,
                                           bf16* ring, unsigned (&mask)[2]) {
  float acc[2][8][4];
  layer_product<false, S>(acc, act, W, kin, steps, ring);
  hidden_bf16(acc, bias, act, mask);
}

// The epilogue of a last (linear) 256-wide layer over a sub-tile, in place:
// act <- z = bf16(bf16(acc) + b), after a barrier (every warp has read its
// last A fragment of act).
__device__ __forceinline__ void last_bf16(const float (&acc)[2][8][4],
                                          const bf16* __restrict__ bias, bf16* act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, u = lane & 3;
  const int r0 = (warp >> 2) * 32, n0 = (warp & 3) * 64;
  __syncthreads();  // every warp has read its last A fragment
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * u;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned y = pack(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        *reinterpret_cast<unsigned*>(act + (r0 + 16 * i + g + 8 * h) * LDA + col) =
            pack(lo(y) + b0, hi(y) + b1);
      }
  }
}

// The dX epilogue over a sub-tile: g = acc leaky' (the mask bits of the
// layer's input, as layer_bf16 set them), red[w / 4][col] = the column sums
// of g over warp w's 32 rows (f32, in a fixed order), then, after a barrier,
// gd = bf16(g) into gs in place.
__device__ __forceinline__ void dx_epilogue(float (&acc)[2][8][4], const unsigned (&mask)[2],
                                            bf16* gs, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, u = lane & 3;
  const int r0 = (warp >> 2) * 32, n0 = (warp & 3) * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] *= (mask[i] >> (4 * j + e)) & 1u ? 1.f : 0.01f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = ((acc[0][j][c] + acc[0][j][c + 2]) + acc[1][j][c]) + acc[1][j][c + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[(warp >> 2) * HID + n0 + 8 * j + 2 * u + c] = s;
    }
  __syncthreads();  // every warp has read its last A fragment of gs; red is complete
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(gs + (r0 + 16 * i + g + 8 * h) * LDA + n0 + 8 * j + 2 * u) =
            pack(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// part += X^T Y over the K <= TILE rows (pairs, or points) of X [K][ldx] bf16
// in global memory and Y the tile buffer [TILE][LDA] (its rows from K on
// zero): dW rows c < rows are X's columns (from ldx on zero). By the whole
// block, in chunks of CHUNK_ROWS rows of dW, each chunk's X [TILE][LDX]
// (columns c0 .. c0 + 63) landing in one of two buffers in xbuf by cp.async
// while the chunk before it is multiplied, so that the 16 k-steps of a chunk
// run without a barrier; each thread's old partial values are loaded before
// the chunk's product and stored back after it (the partial's layout: float4
// q = 4 i + j of thread t holds acc[i][j][0..3] at [q][t]). Warp w computes
// the chunk's rows 32 (w / 8) .. + 32, columns 32 (w % 8) .. + 32.
__device__ __forceinline__ void dw_product(float* __restrict__ part, const bf16* __restrict__ X,
                                           int ldx, int rows, int K, const bf16* Y, bf16* xbuf) {
  const int tid = threadIdx.x, warp = tid >> 5, m0 = (warp >> 3) * 32, n0 = (warp & 7) * 32;
  const int n_chunks = (rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  auto load = [&](int c) {  // X's columns 64 c .. + 64 into buffer c % 2
    bf16* dst = xbuf + (c & 1) * TILE * LDX;
    for (int idx = tid; idx < TILE * CHUNK_ROWS / 8; idx += NT) {
      const int r = idx / (CHUNK_ROWS / 8), col = idx % (CHUNK_ROWS / 8) * 8;
      const bool ok = r < K && CHUNK_ROWS * c + col < ldx;
      cp16(dst + r * LDX + col, X + (ok ? (long)r * ldx + CHUNK_ROWS * c + col : 0), ok);
    }
    cp_commit();
  };
  __syncthreads();  // the last user of xbuf is done with it
  load(0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load(c + 1);
    } else {
      cp_commit();
    }
    float4* chunk = reinterpret_cast<float4*>(part + (long)c * CHUNK) + tid;
    float4 old[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) old[q] = chunk[q * NT];  // in flight during the product
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    cp_wait<1>();
    __syncthreads();  // chunk c landed for every thread
    const bf16* x = xbuf + (c & 1) * TILE * LDX;
#pragma unroll 2
    for (int t = 0; t < TILE / 16; ++t) {
      unsigned a0[4], a1[4];
      frag_at(a0, x, LDX, 16 * t, m0);
      frag_at(a1, x, LDX, 16 * t, m0 + 16);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        frag_b(b, Y, LDA, 16 * t, n0 + 16 * jp);
        mma(acc[0][2 * jp], a0, b[0], b[1]);
        mma(acc[1][2 * jp], a1, b[0], b[1]);
        mma(acc[0][2 * jp + 1], a0, b[2], b[3]);
        mma(acc[1][2 * jp + 1], a1, b[2], b[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 o = old[4 * i + j];
        chunk[(4 * i + j) * NT] = make_float4(o.x + acc[i][j][0], o.y + acc[i][j][1],
                                              o.z + acc[i][j][2], o.w + acc[i][j][3]);
      }
    __syncthreads();  // every warp is done with buffer c % 2 before chunk c + 2 lands in it
  }
}

// dw_product's order.
struct Acc {
  __device__ void operator()(int y, int& row, int& col) const {
    const int q = y / (4 * NT), t = y / 4 % NT, e = y % 4;
    const int warp = t >> 5, g = (t & 31) >> 2, u = t & 3;
    row = (warp >> 3) * 32 + 16 * (q >> 2) + g + 8 * (e >> 1);
    col = (warp & 7) * 32 + 8 * (q & 3) + 2 * u + (e & 1);
  }
};

}  // namespace tc
}  // namespace
