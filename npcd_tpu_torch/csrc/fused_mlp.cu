// Fused leaky-ReLU MLP stack in bf16, forward (K7f) and backward (K7b), for
// Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp (_fwd_kernel and
// _bwd_kernel with bf16 weights and its low-precision backward), the field
// heads' MLPs (shape_net 256 -> 256 -> 1, channel_net 256 -> 256 x 4 -> 3)
// under bf16 compute. Rounding points, as npcd_tpu's kernel:
//   forward   z = bf16(bf16(sum_c h[c] W[c][o]) + b[o]), the sum in f32 over
//             exact bf16 x bf16 products; a = max(z, bf16(z * bf16(0.01)))
//             after every layer but the last;
//   backward  the cotangent g runs in f32: g *= (z > 0 ? 1 : 0.01), gd =
//             bf16(g), dW += h^T gd and g = gd W^T in f32 over bf16
//             operands, db += sum of the f32 g; dW and db are rounded to
//             bf16 at the end, dx = bf16(g) after the first layer.
//
// What bounds it on the H100: 2 * 256 * 256 flop per row and hidden layer
// against 512 bytes of input per row, so it is compute-bound. This first
// version runs on the CUDA cores' f32 FMA pipes (the TPU kernel keeps every
// activation in VMEM and runs the MXU): a block of 256 threads takes 64 rows,
// keeps their [64, 256] activation in shared memory as f32 (every value is a
// bf16 value), and walks the layers with one thread per output column holding
// its 64 rows in registers, as csrc/fused_mlp_posenc.cu does; the weights
// (128 KB per 256 x 256 bf16 layer) stream from L2 layer by layer. A last
// layer 1 or 3 wide runs as a warp per row with a shuffle reduction.
//
// The backward (K7b) recomputes the layers per 64-row tile, keeping each
// layer's input h_0 .. h_{L-2} in a per-block global scratch (L2-resident)
// and h_{L-1} in shared memory, then walks back. The dW/db reduction over
// every row runs on a persistent grid (one block per SM, chosen by the
// wrapper): each block accumulates into its own partial in global memory and
// reduce_partials sums the partials in block order, so the result depends
// only on the inputs and the grid size. Rows past the last one load x = 0
// and g = 0; their g stays 0 through the chain, so they add exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HID = 256;   // input and hidden width; one thread per column
constexpr int ROWS = 64;   // rows per block (tile)
constexpr int MAX_OUT = 3;  // widest narrow last layer
constexpr float LEAKY_BF16 = 0.010009765625f;  // bf16(0.01)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float preact(float acc, float b) { return rnd(rnd(acc) + b); }
__device__ __forceinline__ float leaky(float z) { return fmaxf(z, rnd(z * LEAKY_BF16)); }

// acc[r] = sum_c in[r][c] * W[c][t] over c < HID for the tile's 64 rows
// (in: [ROWS][HID] f32 in shared memory, W: row stride HID, bf16).
__device__ __forceinline__ void matmul_col(const float* in, const bf16* __restrict__ W, int t,
                                           float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int c = 0; c < HID; c += 4) {
    const float w0 = ld(W + (long)c * HID + t);
    const float w1 = ld(W + (long)(c + 1) * HID + t);
    const float w2 = ld(W + (long)(c + 2) * HID + t);
    const float w3 = ld(W + (long)(c + 3) * HID + t);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(in + r * HID + c);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
}

// dW[c][t] += sum_r A[r][c] * g[r] for c < HID (A: [ROWS][HID] in shared
// memory, dW: this block's f32 partial, row stride HID).
__device__ __forceinline__ void accum_dw(const float* A, const float (&g)[ROWS],
                                         float* __restrict__ dW, int t) {
  for (int c = 0; c < HID; c += 4) {
    float* d = dW + (long)c * HID + t;
    const float o0 = d[0], o1 = d[HID], o2 = d[2 * HID], o3 = d[3 * HID];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * HID + c);
      s0 = fmaf(a.x, g[r], s0);
      s1 = fmaf(a.y, g[r], s1);
      s2 = fmaf(a.z, g[r], s2);
      s3 = fmaf(a.w, g[r], s3);
    }
    d[0] = o0 + s0;
    d[HID] = o1 + s1;
    d[2 * HID] = o2 + s2;
    d[3 * HID] = o3 + s3;
  }
}

// Loads the tile's rows r0 .. r0 + ROWS - 1 of x [rows][HID] into X as f32,
// zero past the last row.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ x, float* X, long r0,
                                          int rows, int t) {
  for (int idx = t; idx < ROWS * HID; idx += HID) {
    const int r = idx / HID;
    X[idx] = r0 + r < rows ? ld(x + r0 * HID + idx) : 0.f;
  }
}

// A hidden layer over the tile: act[r][t] = leaky(z) (in place, after every
// thread has read its input rows).
__device__ __forceinline__ void hidden_layer(float* act, const bf16* __restrict__ W,
                                             const bf16* __restrict__ bias, bool linear,
                                             int t, float (&acc)[ROWS]) {
  matmul_col(act, W, t, acc);
  __syncthreads();
  const float bt = ld(bias + t);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float z = preact(acc[r], bt);
    act[r * HID + t] = linear ? z : leaky(z);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(HID)
mlp_fwd(const bf16* __restrict__ x, const bf16* __restrict__ params, bf16* __restrict__ out,
        int rows, int n_layers, int d_out) {
  extern __shared__ __align__(16) float act[];  // [ROWS][HID]
  const int t = threadIdx.x;
  const long r0 = (long)blockIdx.x * ROWS;
  load_rows(x, act, r0, rows, t);
  __syncthreads();

  float acc[ROWS];
  const bf16* p = params;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    const int n_out = last ? d_out : HID;
    const bf16* W = p;
    const bf16* bias = W + (long)HID * n_out;
    p = bias + n_out;
    if (n_out == HID) {
      hidden_layer(act, W, bias, last, t, acc);
      continue;
    }
    // narrow last layer: a warp per row, lanes over the inputs
    const int warp = t / 32, lane = t % 32;
    for (int r = warp; r < ROWS; r += HID / 32) {
      float s[MAX_OUT] = {0.f, 0.f, 0.f};
      for (int j = 0; j < HID / 32; ++j) {
        const int c = lane + 32 * j;
        const float a = act[r * HID + c];
#pragma unroll
        for (int o = 0; o < MAX_OUT; ++o)
          if (o < n_out) s[o] = fmaf(a, ld(W + c * n_out + o), s[o]);
      }
#pragma unroll
      for (int o = 0; o < MAX_OUT; ++o)
        for (int m = 16; m > 0; m >>= 1) s[o] += __shfl_xor_sync(0xffffffffu, s[o], m);
      if (lane == 0 && r0 + r < rows) {
        for (int o = 0; o < n_out; ++o)
          out[(r0 + r) * n_out + o] = __float2bfloat16_rn(preact(s[o], ld(bias + o)));
      }
    }
    return;
  }
  for (int r = 0; r < ROWS; ++r)
    if (r0 + r < rows) out[(r0 + r) * HID + t] = __float2bfloat16_rn(act[r * HID + t]);
}

__global__ void __launch_bounds__(HID, 1)
mlp_bwd(const bf16* __restrict__ x, const bf16* __restrict__ params,
        const bf16* __restrict__ params_t, const bf16* __restrict__ g_out,
        bf16* __restrict__ dx, float* __restrict__ partial, float* __restrict__ scratch,
        int rows, int n_layers, int d_out, long n_params) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                 // [ROWS][HID] the current layer's input
  float* Y = X + ROWS * HID;       // [ROWS][HID] gd, staged for dX
  float* G = Y + ROWS * HID;       // [ROWS][MAX_OUT] a narrow last layer's cotangent

  const int t = threadIdx.x;
  const long n_tiles = (rows + ROWS - 1) / ROWS;
  float* my_partial = partial + blockIdx.x * n_params;
  float* my_scratch = scratch + (long)blockIdx.x * (n_layers - 1) * ROWS * HID;

  // offsets of W_l, b_l in params (and of dW_l, db_l in the partials) and of
  // W_l^T in params_t
  long w_off[8], b_off[8], wt_off[8];
  {
    long o = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int n_out = l == n_layers - 1 ? d_out : HID;
      w_off[l] = o;
      wt_off[l] = o - (long)l * HID;  // params_t holds no biases; hidden biases are HID wide
      b_off[l] = o + (long)HID * n_out;
      o = b_off[l] + n_out;
    }
  }

  float acc[ROWS];
  const int L = n_layers;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long r0 = tile * ROWS;
    load_rows(x, X, r0, rows, t);
    __syncthreads();
    // ---- recompute the hidden layers, keeping each one's input ----------
    for (int l = 0; l < L - 1; ++l) {
      float4* keep = reinterpret_cast<float4*>(my_scratch + (long)l * ROWS * HID);
      const float4* src = reinterpret_cast<const float4*>(X);
      for (int idx = t; idx < ROWS * HID / 4; idx += HID) keep[idx] = src[idx];
      hidden_layer(X, params + w_off[l], params + b_off[l], false, t, acc);
    }
    // X holds h_{L-1}, the last layer's input

    // ---- the last (linear) layer ------------------------------------------
    if (d_out == HID) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] = r0 + r < rows ? ld(g_out + (r0 + r) * HID + t) : 0.f;
        s += acc[r];
      }
      my_partial[b_off[L - 1] + t] += s;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) Y[r * HID + t] = acc[r];  // bf16 already: gd = g
      __syncthreads();
      accum_dw(X, acc, my_partial + w_off[L - 1], t);
      matmul_col(Y, params_t + wt_off[L - 1], t, acc);
    } else {
      for (int idx = t; idx < ROWS * MAX_OUT; idx += HID) {
        const int r = idx / MAX_OUT, o = idx % MAX_OUT;
        G[idx] = o < d_out && r0 + r < rows ? ld(g_out + (r0 + r) * d_out + o) : 0.f;
      }
      __syncthreads();
      const bf16* W = params + w_off[L - 1];  // [HID][d_out]
      for (int o = 0; o < d_out; ++o) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s = fmaf(X[r * HID + t], G[r * MAX_OUT + o], s);
        my_partial[w_off[L - 1] + (long)t * d_out + o] += s;
      }
      if (t < d_out) {
        float s = 0.f;
        for (int r = 0; r < ROWS; ++r) s += G[r * MAX_OUT + t];
        my_partial[b_off[L - 1] + t] += s;
      }
      float w[MAX_OUT];
#pragma unroll
      for (int o = 0; o < MAX_OUT; ++o) w[o] = o < d_out ? ld(W + (long)t * d_out + o) : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < MAX_OUT; ++o)
          if (o < d_out) s = fmaf(G[r * MAX_OUT + o], w[o], s);
        acc[r] = s;
      }
    }
    // acc[r] = the cotangent of h_{L-1}[r][t], f32

    // ---- hidden layers L-2 .. 0: X holds h_{l+1} = leaky(z_l) --------------
    for (int l = L - 2; l >= 0; --l) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] *= X[r * HID + t] > 0.f ? 1.f : 0.01f;  // h > 0 exactly when z > 0
        s += acc[r];
        acc[r] = rnd(acc[r]);  // gd = bf16(g)
      }
      my_partial[b_off[l] + t] += s;
      __syncthreads();  // every thread has read its column of X
#pragma unroll
      for (int r = 0; r < ROWS; ++r) Y[r * HID + t] = acc[r];
      {
        const float4* src = reinterpret_cast<const float4*>(my_scratch + (long)l * ROWS * HID);
        float4* dst = reinterpret_cast<float4*>(X);
        for (int idx = t; idx < ROWS * HID / 4; idx += HID) dst[idx] = src[idx];
      }
      __syncthreads();
      accum_dw(X, acc, my_partial + w_off[l], t);
      matmul_col(Y, params_t + wt_off[l], t, acc);
    }

    // ---- dx = bf16(g) -------------------------------------------------------
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r0 + r < rows) dx[(r0 + r) * HID + t] = __float2bfloat16_rn(acc[r]);
    __syncthreads();  // X, Y and G are rebuilt by the next tile
  }
}

// out[j] = bf16(sum over blocks b, in order, of partial[b][j]).
__global__ void reduce_partials(const float* __restrict__ partial, int n_blocks, long n,
                                bf16* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n + j];
  out[j] = __float2bfloat16_rn(s);
}

}  // namespace

// x [rows, 256] and out [rows, d_out] bf16 contiguous; params packs the
// layers in order as W [256, n_out] (row-major) then b [n_out], bf16, n_out =
// 256 for every layer but the last, d_out in {1, 3, 256} for the last.
// Returns cudaGetLastError() after launch.
extern "C" int fused_mlp_fwd(const void* x, const void* params, void* out, int rows,
                             int n_layers, int d_out, void* stream) {
  const size_t smem = sizeof(float) * ROWS * HID;
  cudaError_t err =
      cudaFuncSetAttribute(mlp_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + ROWS - 1) / ROWS;
  mlp_fwd<<<grid, HID, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(params), static_cast<bf16*>(out),
      rows, n_layers, d_out);
  return static_cast<int>(cudaGetLastError());
}

// Backward of fused_mlp_fwd for the same x and params, with g_out [rows,
// d_out] bf16 the output cotangent. params_t packs W_l^T [n_out, 256] of every
// layer in order (no biases). Writes dx [rows, 256] bf16 and dparams (dW/db
// packed as params, bf16) through partial [n_blocks, n_params] f32 (zeroed by
// the caller) and scratch [n_blocks, max(n_layers - 1, 1), 64, 256] f32.
// 1 <= n_layers <= 8. Returns the first CUDA error, or cudaSuccess.
extern "C" int fused_mlp_bwd(const void* x, const void* params, const void* params_t,
                             const void* g_out, void* dx, void* dparams, void* partial,
                             void* scratch, int rows, int n_layers, int d_out, int n_blocks,
                             long n_params, void* stream) {
  if (n_layers < 1 || n_layers > 8) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * ROWS * HID + ROWS * MAX_OUT);
  cudaError_t err =
      cudaFuncSetAttribute(mlp_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_bwd<<<n_blocks, HID, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(params),
      static_cast<const bf16*>(params_t), static_cast<const bf16*>(g_out),
      static_cast<bf16*>(dx), static_cast<float*>(partial), static_cast<float*>(scratch), rows,
      n_layers, d_out, n_params);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  reduce_partials<<<(int)((n_params + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), n_blocks, n_params, static_cast<bf16*>(dparams));
  return static_cast<int>(cudaGetLastError());
}
