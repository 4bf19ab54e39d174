// Fused leaky-ReLU MLP stack in bf16, forward (K7f, tc::mlp_fwd) and
// backward (K7b, tc::mlp_bwd), for Hopper (sm_90a), on the tensor cores:
// bf16 mma.sync.m16n8k16 with f32 sums through the layer routines of
// csrc/bf16_mlp.cuh, which the bf16 K6f and K6b (csrc/fused_mlp_posenc.cu)
// run on too.
//
// Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp (_fwd_kernel and
// _bwd_kernel with bf16 weights and its low-precision backward), the field
// heads' MLPs (shape_net 256 -> 256 -> 1, channel_net 256 -> 256 x 4 -> 3,
// its input wider with view directions: 256 + 51 = 307 at dir_freqs 8)
// under bf16 compute. Rounding points, as npcd_tpu's kernel:
//   forward   z = bf16(bf16(sum_c h[c] W[c][o]) + b[o]), the sum in f32 over
//             exact bf16 x bf16 products; a = max(z, bf16(z * bf16(0.01)))
//             after every layer but the last;
//   backward  the cotangent g runs in f32: g *= (z > 0 ? 1 : 0.01), gd =
//             bf16(g), dW += h^T gd and g = gd W^T in f32 over bf16
//             operands, db += sum of the f32 g; dW and db are rounded to
//             bf16 at the end, dx = bf16(g) after the first layer.
//
// What bounds them on the H100: 2 * 256 * 256 flop per row and hidden layer
// against 512 bytes of input per row, so the tensor cores' rate: the
// channel_net backward's 1.13 TFLOP at the fast stage-1 step's 716,800 rows
// take 1.14 ms at 989 TFLOP/s dense bf16.
//
// The input width d_in is 64 to 512, a multiple of 64 (the wrapper pads x
// with zero columns and W_0 with zero rows up to it: 307 -> 320); only the
// first layer's product and dx see it. The tile buffer holds 256 columns,
// so a wider first layer runs over x's columns in chunks of 256
// (first_layer): each chunk lands in the buffer and its k-steps add to the
// same accumulators, so an output element's sum is its k-steps over x's
// columns in order, as one product over the whole width takes them. dx's
// columns past the first 256 come from products over W_0's rows in chunks
// of 256, stored straight to dx, before the first chunk's, which stays in
// the buffer as the narrower input's dx does.
//
// Forward: a block of 16 warps takes 128 rows; x lands by cp.async in the
// [128][264] bf16 tile buffer (rows past the last zero), the hidden layers
// run in place through tc::layer_bf16 on a ring three slabs deep (as the
// bf16 K6f's), and a 256-wide last layer through layer_product and
// last_bf16. A hidden activation is bitwise the one the backward recomputes:
// an mma's sum for one output element depends only on its sequence of
// 16-deep k-steps, not on how the rows are tiled or how deep the ring is. A
// last layer 1 or 3 wide runs on the CUDA cores, a warp per row, each lane
// 8 columns, then a shuffle reduction.
//
// Backward, as the bf16 K6b: a persistent grid of one block an SM takes
// tiles of 256 rows (block b: tiles b, b + grid, ...) as two sub-tiles of
// 128. Per tile it recomputes the hidden layers of each sub-tile in place
// (layer_bf16), keeping each layer's input as bf16 in a per-block scratch
// (L2-resident) and its mask bits z > 0; then walks back with the tile
// buffer holding gd_l: dW_l += h_l^T gd_l (tc::dw_product, into the block's
// f32 partial), g = gd_l W_l^T (layer_product<true>: W's columns through
// the ring, no transposed copy), leaky' by the mask bits, db_{l-1} and
// gd_{l-1} = bf16(g) (dx_epilogue); after layer 0 the same epilogue with
// every slope 1 leaves dx = bf16(g) in the buffer. A 256-wide last layer
// takes g_out as gd_{L-1}; a narrow one runs on the CUDA cores: its dW and
// db in f32 from the buffer's h_{L-1} and g_out, and g = g_out W^T per
// accumulator of the dX epilogue's layout. reduce_partials sums the
// partials in block order and rounds once, so the result depends only on
// the inputs and the grid. Rows past the last load x = 0 and g = 0; their g
// stays 0 through the chain, so they add exactly 0. The partials' f32
// read-modify-write is paid at every tile: 512 KB a 256-wide layer, 2.1 MB
// a tile for channel_net, whose 132 partials of 1.06 MB do not fit in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mlp.cuh"

namespace {
namespace tc {

constexpr int MAX_OUT = 3;  // widest narrow last layer
constexpr int MAX_LAYERS = 8;
constexpr long SLOT = (long)TILE * HID;  // a kept layer input in the scratch
constexpr long LAYER = (long)HID * HID + HID;  // a 256-wide layer's W and b

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// Rows 0 .. n - 1, columns 0 .. cols - 1 (a multiple of 8) of src [..][ld]
// into buf [n][LDA] by cp.async (one copy group), zero from row `valid` on.
__device__ __forceinline__ void load_tile(bf16* buf, const bf16* __restrict__ src, int ld,
                                          int cols, int n, int valid) {
  for (int idx = threadIdx.x; idx < n * cols / 8; idx += NT) {
    const int r = idx / (cols / 8), c = idx % (cols / 8) * 8;
    cp16(buf + r * LDA + c, src + (r < valid ? (long)r * ld + c : 0), r < valid);
  }
  cp_commit();
}

// Rows 0 .. valid - 1, columns 0 .. cols - 1 of buf [..][LDA] to dst [..][ld],
// 16 bytes a thread.
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, long ld, const bf16* buf,
                                           int valid, int cols = HID) {
  for (int idx = threadIdx.x; idx < valid * cols / 8; idx += NT) {
    const int r = idx / (cols / 8), c = idx % (cols / 8) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(buf + r * LDA + c);
  }
}

// The first layer's product over a sub-tile whose act holds x's columns 0
// .. min(d_in, 256) - 1 (in flight by cp.async, or landed): over them, then
// over x's further columns in chunks of 256, each loaded into act in turn
// (rows from `valid` on zero) and added to the same accumulators. x
// [..][d_in] is the sub-tile's first row, W [d_in][HID].
template <int S = 2>
__device__ __forceinline__ void first_product(float (&acc)[2][8][4], bf16* act,
                                              const bf16* __restrict__ x, int d_in, int valid,
                                              const bf16* __restrict__ W, bf16* ring) {
  const int w0 = min(d_in, HID);
  layer_product<false, S>(acc, act, W, w0, w0 / 16, ring);
  for (int c0 = HID; c0 < d_in; c0 += HID) {
    const int w = min(HID, d_in - c0);
    __syncthreads();  // every warp has read its last A fragment of the chunk before
    load_tile(act, x + c0, d_in, w, SUB, valid);
    layer_product<false, S, false>(acc, act, W + (long)c0 * HID, w, w / 16, ring);
  }
}

// The first layer as a hidden one: first_product, then the hidden epilogue
// in place (W [d_in][HID], then b).
template <int S = 2>
__device__ __forceinline__ void first_layer(bf16* act, const bf16* __restrict__ x, int d_in,
                                            int valid, const bf16* __restrict__ W,
                                            bf16* ring, unsigned (&mask)[2]) {
  float acc[2][8][4];
  first_product<S>(acc, act, x, d_in, valid, W, ring);
  hidden_bf16(acc, W + (long)d_in * HID, act, mask);
}

// bf16(acc), columns 0 .. cols - 1 of the accumulators' layout over a
// sub-tile's rows 0 .. valid - 1, to dst [..][ld] (a dX product's output
// past the tile buffer's columns).
__device__ __forceinline__ void store_acc(const float (&acc)[2][8][4], bf16* __restrict__ dst,
                                          int ld, int cols, int valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, u = lane & 3;
  const int r0 = (warp >> 2) * 32, n0 = (warp & 3) * 64;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * u;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * i + g + 8 * h;
        if (row < valid && col < cols)
          *reinterpret_cast<unsigned*>(dst + (long)row * ld + col) =
              pack(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
}

// Shared memory: the tile buffer [SUB][LDA] and the ring [FWD_STAGES][STAGE]
// bf16 (~174 KB): one block an SM.
__global__ void __launch_bounds__(NT, 1)
mlp_fwd(const bf16* __restrict__ x, const bf16* __restrict__ params, bf16* __restrict__ out,
        int rows, int n_layers, int d_out, int d_in) {
  extern __shared__ __align__(16) float sbuf[];
  bf16* act = reinterpret_cast<bf16*>(sbuf);
  bf16* ring = act + SUB * LDA;
  const long r0 = (long)blockIdx.x * SUB;
  const int valid = rows - r0 < SUB ? (int)(rows - r0) : SUB;
  // the first layer product waits for it
  load_tile(act, x + r0 * d_in, d_in, min(d_in, HID), SUB, valid);

  // ---- hidden layers 0 .. L-2 in place, as the backward recomputes them ----
  const bf16* p = params;  // W_l, then b_l
  for (int l = 0; l < n_layers - 1; ++l) {
    unsigned mk[2];
    if (l) {
      layer_bf16<FWD_STAGES>(act, p, p + HID * HID, HID, HID / 16, ring, mk);
      p += LAYER;
    } else {
      first_layer<FWD_STAGES>(act, x + r0 * d_in, d_in, valid, p, ring, mk);
      p += (long)d_in * HID + HID;
    }
  }

  if (d_out == HID) {  // ---- a 256-wide last layer: z = bf16(bf16(acc) + b) ----
    float acc[2][8][4];
    const int k_in = n_layers > 1 ? HID : d_in;
    if (n_layers > 1)
      layer_product<false, FWD_STAGES>(acc, act, p, HID, HID / 16, ring);
    else
      first_product<FWD_STAGES>(acc, act, x + r0 * d_in, d_in, valid, p, ring);
    last_bf16(acc, p + (long)k_in * HID, act);
    __syncthreads();
    store_tile(out + r0 * HID, HID, act, valid);
    return;
  }

  // ---- a narrow last layer: a warp per row, lane l columns 8 l .. 8 l + 7 ---
  cp_wait<0>();  // x, where no layer product ran
  __syncthreads();  // act holds the last layer's input
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* bias = p + HID * d_out;
  float w[8][MAX_OUT];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o)
      w[c][o] = o < d_out ? bf(p[(8 * lane + c) * d_out + o]) : 0.f;
  for (int r = warp; r < valid; r += NT / 32) {
    const uint4 v = *reinterpret_cast<const uint4*>(act + r * LDA + 8 * lane);
    const unsigned h[4] = {v.x, v.y, v.z, v.w};
    float s[MAX_OUT] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = 0; o < MAX_OUT; ++o) {
        s[o] = fmaf(lo(h[c]), w[2 * c][o], s[o]);
        s[o] = fmaf(hi(h[c]), w[2 * c + 1][o], s[o]);
      }
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o)
      for (int m = 16; m > 0; m >>= 1) s[o] += __shfl_xor_sync(0xffffffffu, s[o], m);
    if (lane == 0)
      for (int o = 0; o < d_out; ++o)
        out[(r0 + r) * d_out + o] =
            __float2bfloat16_rn(bf(__float2bfloat16_rn(s[o])) + bf(bias[o]));
  }
}

// Shared memory: the tile buffer [TILE][LDA] and the ring [RING] bf16, the
// column sums red [4][HID] and a narrow last layer's cotangent G [TILE][4]
// f32 (~212 KB): one block an SM.
// WIDE false: d_in is 256, a compile-time constant, so the chunk loops of
// a wider input vanish and the kernel keeps the registers it had before
// it took other widths (with d_in at run time it ran ~20% slower at 256).
template <bool WIDE>
__global__ void __launch_bounds__(NT, 1)
mlp_bwd(const bf16* __restrict__ x, const bf16* __restrict__ params,
        const bf16* __restrict__ g_out, bf16* __restrict__ dx, float* __restrict__ partial,
        bf16* __restrict__ scratch, int rows, int n_layers, int d_out, int d_in_arg,
        long stride) {
  const int d_in = WIDE ? d_in_arg : HID;
  extern __shared__ __align__(16) float sbuf[];
  bf16* tile = reinterpret_cast<bf16*>(sbuf);
  bf16* ring = tile + TILE * LDA;
  float* red = reinterpret_cast<float*>(ring + RING);
  float* G = red + 4 * HID;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, u = lane & 3;
  const int n_hid = n_layers - 1;  // hidden layers
  const bool wide = d_out == HID;
  const int n_act = wide ? n_hid : max(n_hid - 1, 0);  // kept layer inputs act_0 ..
  const long n_tiles = (rows + TILE - 1) / TILE;
  // the block's scratch: act_0 .. act_{n_act-1} [TILE][HID], then the mask
  // words [n_hid][2 sub-tiles][2][NT]
  bf16* acts = scratch + (long)blockIdx.x * (n_act * SLOT + (long)n_hid * 8 * NT);
  unsigned* masks = reinterpret_cast<unsigned*>(acts + n_act * SLOT);
  auto mask_at = [&](int l, int s, int w) { return masks + ((l * 2 + s) * 2 + w) * NT + tid; };
  // W_l, b_l in params; dW_l, db_l at the same offsets in the block's partial
  float* part = partial + blockIdx.x * stride;
  const long layer0 = (long)d_in * HID + HID;  // W_0 [d_in][HID] and b_0
  auto off = [&](int l) { return l ? layer0 + (l - 1) * LAYER : 0L; };
  auto W_of = [&](int l) { return params + off(l); };
  auto db_part = [&](int l) { return part + off(l) + (long)(l ? HID : d_in) * HID; };
  const bf16* W_last = W_of(n_hid);
  // the column sums of a sub-tile's g (dx_epilogue's red) into db_l
  auto add_db = [&](int l) {
    if (tid < HID) db_part(l)[tid] += ((red[tid] + red[HID + tid]) + red[2 * HID + tid]) +
                                      red[3 * HID + tid];
  };

  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long r0 = t * TILE;
    const int valid = rows - r0 < TILE ? (int)(rows - r0) : TILE;
    __syncthreads();  // the last tile is done with the tile buffer, red and G
    load_tile(tile, x + r0 * d_in, d_in, min(d_in, HID), TILE, valid);
    if (!wide)
      for (int idx = tid; idx < TILE * 4; idx += NT) {
        const int r = idx / 4, o = idx % 4;
        G[idx] = o < d_out && r < valid ? bf(g_out[(r0 + r) * d_out + o]) : 0.f;
      }
    cp_wait<0>();
    __syncthreads();

    // ---- recompute the hidden layers of each sub-tile, in place ------------
    for (int s = 0; s < 2; ++s) {
      bf16* act = tile + s * SUB * LDA;
      const int valid_s = min(max(valid - s * SUB, 0), SUB);
      for (int l = 0; l < n_hid; ++l) {
        unsigned mk[2];
        if (l)
          layer_bf16(act, W_of(l), W_of(l) + HID * HID, HID, HID / 16, ring, mk);
        else
          first_layer(act, x + (r0 + s * SUB) * d_in, d_in, valid_s, W_of(0), ring, mk);
        *mask_at(l, s, 0) = mk[0];
        *mask_at(l, s, 1) = mk[1];
        if (l < n_act) {  // act_l to the scratch: the input of dW_{l+1}
          __syncthreads();
          store_tile(acts + l * SLOT + s * SUB * HID, HID, act, SUB);
        }
      }
    }
    __syncthreads();  // the tile buffer holds h_{L-1}, the last layer's input

    int top;  // the layer whose gd the tile buffer holds
    if (wide) {
      // ---- a 256-wide last layer: gd_{L-1} = g_out, db its column sums --------
      load_tile(tile, g_out + r0 * HID, HID, HID, TILE, valid);
      cp_wait<0>();
      __syncthreads();
      const int c = tid % HID, half = tid / HID;
      float s = 0.f;
      for (int r = half * SUB; r < (half + 1) * SUB; ++r) s += bf(tile[r * LDA + c]);
      red[half * HID + c] = s;
      __syncthreads();
      if (tid < HID) db_part(n_hid)[tid] += red[tid] + red[HID + tid];
      top = n_hid;
    } else {
      // ---- a narrow last layer on the CUDA cores ----------------------------
      // dW[c][o] += sum_r h[r][c] G[r][o]: thread (c, half) over its half's
      // rows, the halves added in order; db[o] += sum_r G[r][o] by warp 0
      float* dw_last = part + off(n_hid);
      {
        const int c = tid % HID, half = tid / HID;
        float s[MAX_OUT] = {0.f, 0.f, 0.f};
        for (int r = half * SUB; r < (half + 1) * SUB; ++r) {
          const float a = bf(tile[r * LDA + c]);
          const float4 gv = *reinterpret_cast<const float4*>(G + 4 * r);
          s[0] = fmaf(a, gv.x, s[0]);
          s[1] = fmaf(a, gv.y, s[1]);
          s[2] = fmaf(a, gv.z, s[2]);
        }
        float* sums = reinterpret_cast<float*>(ring);  // [2][MAX_OUT][HID]; the ring is idle
#pragma unroll
        for (int o = 0; o < MAX_OUT; ++o) sums[(half * MAX_OUT + o) * HID + c] = s[o];
        if (warp == 0)
          for (int o = 0; o < d_out; ++o) {
            float b = 0.f;
            for (int r = lane; r < TILE; r += 32) b += G[4 * r + o];
            for (int m = 16; m > 0; m >>= 1) b += __shfl_xor_sync(0xffffffffu, b, m);
            if (lane == 0) dw_last[HID * d_out + o] += b;
          }
        __syncthreads();
        if (tid < HID)
          for (int o = 0; o < d_out; ++o)
            dw_last[tid * d_out + o] += sums[o * HID + tid] + sums[(MAX_OUT + o) * HID + tid];
      }
      // g = g_out W^T in the dX epilogue's layout, then leaky' (slope 1 when
      // there is no hidden layer: then the buffer holds dx)
      for (int s = 0; s < 2; ++s) {
        __syncthreads();  // red is free
        const int rw = s * SUB + (warp >> 2) * 32, n0 = (warp & 3) * 64;
        float acc[2][8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int col = n0 + 8 * j + 2 * u + cc;
            float wv[MAX_OUT];
#pragma unroll
            for (int o = 0; o < MAX_OUT; ++o) wv[o] = o < d_out ? bf(W_last[col * d_out + o]) : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4 gv =
                    *reinterpret_cast<const float4*>(G + 4 * (rw + 16 * i + g + 8 * h));
                acc[i][j][2 * h + cc] = fmaf(gv.z, wv[2], fmaf(gv.y, wv[1], gv.x * wv[0]));
              }
          }
        const unsigned one[2] = {~0u, ~0u};
        if (n_hid) {
          const unsigned mk[2] = {*mask_at(n_hid - 1, s, 0), *mask_at(n_hid - 1, s, 1)};
          dx_epilogue(acc, mk, tile + s * SUB * LDA, red);
          add_db(n_hid - 1);
        } else {
          dx_epilogue(acc, one, tile + s * SUB * LDA, red);
        }
      }
      top = n_hid - 1;
    }

    // ---- layers top .. 0: the tile buffer holds gd_l ------------------------
    for (int l = top; l >= 0; --l) {
      // dW_l += h_l^T gd_l over the tile's rows (h_0 = x, its rows from valid on zero)
      if (l)
        dw_product(part + off(l), acts + (l - 1) * SLOT, HID, HID, TILE, tile, ring);
      else
        dw_product(part, x + r0 * d_in, d_in, d_in, valid, tile, ring);
      for (int s = 0; s < 2; ++s) {  // g = (gd_l W_l^T) leaky'(z_{l-1}); dx = bf16(g) at l 0
        float acc[2][8][4];
        // dx's columns from 256 on (gd_0 W_0[c0 ..]^T), before the first
        // chunk's product overwrites gd_0 in the buffer
        for (int c0 = HID; !l && c0 < d_in; c0 += HID) {
          const int w = min(HID, d_in - c0);
          layer_product<true>(acc, tile + s * SUB * LDA, W_of(0) + (long)c0 * HID, w, HID / 16,
                              ring);
          store_acc(acc, dx + (r0 + s * SUB) * d_in + c0, d_in, w,
                    min(max(valid - s * SUB, 0), SUB));
        }
        layer_product<true>(acc, tile + s * SUB * LDA, W_of(l), l ? HID : min(d_in, HID),
                            HID / 16, ring);
        const unsigned mk[2] = {l ? *mask_at(l - 1, s, 0) : ~0u, l ? *mask_at(l - 1, s, 1) : ~0u};
        dx_epilogue(acc, mk, tile + s * SUB * LDA, red);
        if (l) add_db(l - 1);
      }
    }
    __syncthreads();  // the tile buffer holds dx's columns 0 .. 255
    store_tile(dx + r0 * d_in, d_in, tile, valid, min(d_in, HID));
  }
}

// out[j] = bf16(sum over blocks b, in order, of partial[b][j']) for the n
// floats of params, j' their place in a partial: the dW of each of the
// first n_wide layers in dw_product's order (Acc, chunks of 64 rows), every
// other float in place. Layer 0's W has d_in rows, every other 256.
__global__ void reduce_partials(const float* __restrict__ partial, int n_blocks, long stride,
                                long n, int n_wide, int d_in, bf16* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  long dst = j;
  const long layer0 = (long)d_in * HID + HID;
  const long l = j < layer0 ? 0 : 1 + (j - layer0) / LAYER;
  const long base = l ? layer0 + (l - 1) * LAYER : 0, y = j - base;
  if (l < n_wide && y < (long)(l ? HID : d_in) * HID) {
    int row, col;
    Acc()((int)(y % CHUNK), row, col);
    dst = base + (long)(row + CHUNK_ROWS * (int)(y / CHUNK)) * HID + col;
  }
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * stride + j];
  out[dst] = __float2bfloat16_rn(s);
}

// Widths the kernels take: 1 to 8 layers, a last layer 1, 3 or 256 wide, and
// an input of 64 to 512 columns in steps of 64, other than 256 only where
// the first layer is a hidden one or 256 wide (the narrow last layer on
// the CUDA cores reads a 256-wide input).
bool shape_ok(int n_layers, int d_out, int d_in) {
  return n_layers >= 1 && n_layers <= MAX_LAYERS && (d_out == 1 || d_out == 3 || d_out == HID) &&
         d_in >= 64 && d_in <= 2 * HID && d_in % 64 == 0 &&
         (d_in == HID || n_layers >= 2 || d_out == HID);
}

}  // namespace tc
}  // namespace

// x [rows, d_in] and out [rows, d_out] bf16 contiguous; params packs the
// layers in order as W [n_in, n_out] (row-major) then b [n_out], bf16, n_in =
// d_in for the first layer and 256 after, n_out = 256 for every layer but
// the last, d_out in {1, 3, 256} for the last; 1 <= n_layers <= 8, d_in a
// multiple of 64 up to 512 (256 where one layer is also a narrow last).
// Returns
// cudaGetLastError() after launch.
extern "C" int fused_mlp_fwd(const void* x, const void* params, void* out, int rows,
                             int n_layers, int d_out, int d_in, void* stream) {
  using namespace tc;
  if (!shape_ok(n_layers, d_out, d_in)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(bf16)) * (SUB * LDA + FWD_STAGES * STAGE);
  const int e = allow_smem(mlp_fwd, smem);
  if (e) return e;
  mlp_fwd<<<(rows + SUB - 1) / SUB, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(params), static_cast<bf16*>(out),
      rows, n_layers, d_out, d_in);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 elements of a block's scratch of fused_mlp_bwd: the kept layer
// inputs, [TILE][256] each, and the mask words.
extern "C" long fused_mlp_bwd_scratch_len(int n_layers, int d_out) {
  using namespace tc;
  const int n_hid = n_layers - 1, n_act = d_out == HID ? n_hid : (n_hid > 1 ? n_hid - 1 : 0);
  return n_act * SLOT + (long)n_hid * 8 * NT;
}

// Backward of fused_mlp_fwd for the same x and params, with g_out [rows,
// d_out] bf16 the output cotangent. Writes dx [rows, d_in] bf16 and dparams
// (dW/db packed as params, n_params of them, bf16) through partial
// [n_blocks, stride] f32 (zeroed by the caller; stride >= n_params, a
// multiple of 4) and scratch [n_blocks, fused_mlp_bwd_scratch_len] bf16
// (16-byte aligned), on a grid of n_blocks (one an SM). Returns the first
// CUDA error, or cudaSuccess.
extern "C" int fused_mlp_bwd(const void* x, const void* params, const void* g_out, void* dx,
                             void* dparams, void* partial, void* scratch, int rows, int n_layers,
                             int d_out, int d_in, int n_blocks, long n_params, long stride,
                             void* stream) {
  using namespace tc;
  if (!shape_ok(n_layers, d_out, d_in) || stride < n_params || stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(bf16)) * (TILE * LDA + RING) +
                   static_cast<int>(sizeof(float)) * (4 * HID + 4 * TILE);
  auto kernel = d_in == HID ? mlp_bwd<false> : mlp_bwd<true>;
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<n_blocks, NT, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(params),
      static_cast<const bf16*>(g_out), static_cast<bf16*>(dx), static_cast<float*>(partial),
      static_cast<bf16*>(scratch), rows, n_layers, d_out, d_in, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  reduce_partials<<<(int)((n_params + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), n_blocks, stride, n_params,
      d_out == HID ? n_layers : n_layers - 1, d_in, static_cast<bf16*>(dparams));
  return static_cast<int>(cudaGetLastError());
}
