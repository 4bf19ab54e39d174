// Posenc-fused aggregation MLP with the k-neighbour weighted sum, forward
// (K6f) and backward (K6b, below), f32, for Hopper (sm_90a).
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
// pair weight w = pos_t[i, 3, m]. The encoding is the 'anchored' method:
// octave j is evaluated directly where j is a multiple of 5 and by the
// double-angle recurrence s' = 2sc, c' = 2c^2 - 1 in between.
//
// What bounds it on the H100: ~2*(d1*256 + 4*256*256) = 573 kflop per pair
// against ~(F + 4)*4 bytes read and 1 KB written per k pairs, so it is
// compute-bound, on the f32 FMA pipes in this exact-f32 flavour. The TPU
// kernel keeps every [pairs, 256] activation in VMEM; here a block of 256
// threads takes 64 pairs (8 points x k = 8), builds their 96-wide input in
// shared memory, and walks the layers with one thread per output column
// holding its 64 rows in registers: per 4-deep slice of the contraction a
// thread reads 4 weights (coalesced, L2-resident: the whole stack is
// ~0.9 MB) and 64 float4 broadcasts of the activations, for 256 FMAs. The
// layer output overwrites its input in place after a barrier, so shared
// memory holds one [64, 256] activation plus the layer-1 input (~90 KB at
// F = 32, two blocks per SM). Lanes past the last pair are zeroed before
// sin/cos and never written back.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HID = 256;   // width of every layer; one thread per column
constexpr int PAIRS = 64;  // (point, neighbour) pairs per block
constexpr int ANCHOR = 5;  // direct sin/cos every 5 octaves ('anchored')

__device__ __forceinline__ float leaky(float z) { return fmaxf(z, 0.01f * z); }

// out[r][t] = sum_c in[r][c] * W[c][t] for the block's 64 rows; `in` has
// row stride `ld` (a multiple of 4) and is zero in columns [kin, ld).
__device__ __forceinline__ void matmul_col(const float* in, int ld, int kin,
                                           const float* __restrict__ W, int t,
                                           float (&acc)[PAIRS]) {
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) acc[r] = 0.f;
  for (int c = 0; c < kin; c += 4) {
    const float w0 = W[(long)c * HID + t];
    const float w1 = c + 1 < kin ? W[(long)(c + 1) * HID + t] : 0.f;
    const float w2 = c + 2 < kin ? W[(long)(c + 2) * HID + t] : 0.f;
    const float w3 = c + 3 < kin ? W[(long)(c + 3) * HID + t] : 0.f;
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(in + r * ld + c);
      acc[r] = fmaf(a.x, w0, acc[r]);
      acc[r] = fmaf(a.y, w1, acc[r]);
      acc[r] = fmaf(a.z, w2, acc[r]);
      acc[r] = fmaf(a.w, w3, acc[r]);
    }
  }
}

// Builds the block's layer-1 input h0 [PAIRS][ld1] (feature rows, x, the
// 'anchored' encoding, zero pad columns) and the pair weights wpair
// [PAIRS] for pairs r0 .. r0 + PAIRS - 1 of one instance. Lanes past the
// last pair are zeroed before sin/cos.
__device__ __forceinline__ void build_input(const float* __restrict__ feat,
                                            const float* __restrict__ pos,
                                            float* h0, float* wpair, int r0,
                                            int m, int f_dim, int n_freqs,
                                            float freq_c0, int d1, int ld1,
                                            int t) {
  for (int idx = t; idx < f_dim * PAIRS; idx += HID) {
    const int f = idx / PAIRS, r = idx % PAIRS;
    h0[r * ld1 + f] = r0 + r < m ? feat[(long)f * m + r0 + r] : 0.f;
  }
  for (int idx = t; idx < 3 * PAIRS; idx += HID) {
    const int d = idx / PAIRS, r = idx % PAIRS;
    const float x = r0 + r < m ? pos[(long)d * m + r0 + r] : 0.f;
    float* row = h0 + r * ld1;
    row[f_dim + d] = x;
    float* enc = row + f_dim + 3 + d * 2 * n_freqs;
    float s = 0.f, c = 1.f;
    for (int j = 0; j < n_freqs; ++j) {
      if (j % ANCHOR == 0) {
        const float arg = __fmul_rn(freq_c0 * (float)(1 << j), x);
        s = sinf(arg);
        c = cosf(arg);
      } else {
        const float s2 = __fmul_rn(__fmul_rn(2.f, s), c);
        c = __fsub_rn(__fmul_rn(__fmul_rn(2.f, c), c), 1.f);
        s = s2;
      }
      enc[j] = s;
      enc[n_freqs + j] = c;
    }
  }
  for (int idx = t; idx < PAIRS * (ld1 - d1); idx += HID) {
    const int r = idx / (ld1 - d1), c = idx % (ld1 - d1);
    h0[r * ld1 + d1 + c] = 0.f;
  }
  if (t < PAIRS) wpair[t] = r0 + t < m ? pos[3L * m + r0 + t] : 0.f;
}

__global__ void __launch_bounds__(HID)
mlp_posenc_wsum(const float* __restrict__ feat_t, const float* __restrict__ pos_t,
                const float* __restrict__ params, float* __restrict__ out,
                int m, int f_dim, int pos_rows, int n_layers, int n_freqs,
                float freq_c0, int k) {
  extern __shared__ __align__(16) float smem[];
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int ld1 = (d1 + 3) & ~3;
  float* h0 = smem;                    // [PAIRS][ld1] layer-1 input
  float* act = h0 + PAIRS * ld1;       // [PAIRS][HID] activations
  float* wpair = act + PAIRS * HID;    // [PAIRS] pair weights

  const int t = threadIdx.x;
  const int inst = blockIdx.y;
  const int r0 = blockIdx.x * PAIRS;
  const float* feat = feat_t + (long)inst * f_dim * m;
  const float* pos = pos_t + (long)inst * pos_rows * m;

  build_input(feat, pos, h0, wpair, r0, m, f_dim, n_freqs, freq_c0, d1, ld1, t);
  __syncthreads();

  // ---- layers ---------------------------------------------------------
  float acc[PAIRS];
  const float* p = params;
  for (int layer = 0; layer < n_layers; ++layer) {
    const int kin = layer == 0 ? d1 : HID;
    const float* W = p;
    const float* bias = p + (long)kin * HID;
    p = bias + HID;
    if (layer == 0) {
      matmul_col(h0, ld1, kin, W, t, acc);
    } else {
      matmul_col(act, HID, kin, W, t, acc);
    }
    __syncthreads();  // every thread has read its input rows
    const float bt = bias[t];
    const bool last = layer == n_layers - 1;
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const float z = acc[r] + bt;
      act[r * HID + t] = last ? z : leaky(z);
    }
    __syncthreads();
  }

  // ---- k-weighted sum over each point's pairs ---------------------------
  const int n_pts = m / k;
  const int pt0 = r0 / k;
  for (int q = 0; q < PAIRS / k; ++q) {
    if (pt0 + q >= n_pts) break;
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = fmaf(wpair[q * k + j], act[(q * k + j) * HID + t], s);
    out[((long)inst * n_pts + pt0 + q) * HID + t] = s;
  }
}


// ---------------------------------------------------------------------------
// Backward (K6b). Replaces npcd_tpu/ops/pallas/fused_mlp.py:_posenc_impl_bwd
// (_bwd_posenc_kernel) with reduce_k, need_dw=False and need_dp=False, the
// aggregator's contract: the pair weights w and x_rel get no gradient, so
// the outputs are dfeat_t (the feature rows of dh0 only) and dW/db of every
// layer.
//
// Per tile of 64 pairs a block (1) rebuilds h0 and recomputes layers
// 0 .. L-2 with the forward's arithmetic (the last layer's output is not
// needed: it is linear, and w has no gradient), keeping each activation:
// act_0 .. act_{L-3} in a per-block global scratch (L2-resident) and
// act_{L-2} in shared memory; (2) expands the per-point cotangent to pairs,
// g[r] = w[r] * g_out[r / k]; (3) walks the layers back: dW_l += act^T g,
// db_l += sum g, dh = g W_l^T (through a transposed copy of W_l, so that
// the reads stay coalesced), g = dh * leaky'(z), where leaky'(z) = 1 if
// act(z) > 0 else 0.01 (act(z) > 0 exactly when z > 0); (4) writes dfeat_t
// = g_0 W_0[:F]^T.
//
// The dW reduction runs over every pair (17.92M per stage-1 step) into
// ~288K weights. Blocks run in no order, so the TPU kernel's accumulation
// in scratch across a sequential grid does not carry over, and f32
// atomics would make the result differ from run to run. Instead the grid
// is persistent: a fixed number of blocks (one per SM, as the wrapper
// chooses) takes tiles blk, blk + grid, ...; each block accumulates into
// its own partial dW/db in global memory (read-modify-write of one row of
// 256 floats per input column and tile; the old values are loaded before
// the 64-row FMA loop so the latency hides behind it), and
// reduce_partials sums the partials in block order. The result depends
// only on the inputs and the grid size.
//
// Bound: ~1.56 Mflop per pair (layers 0 .. L-2 recomputed, dX and dW),
// ~28 Tflop per stage-1 step: the f32 FMA pipes. Shared memory is h0 plus
// two [64][256] buffers (~153 KB), one block per SM.

// dW[c][t] += sum_r A[r][c] * g[r] for c < kin (A has row stride ld and
// zero columns up to the next multiple of 4); db[t] += sum_r g[r].
__device__ __forceinline__ void accum_dw(const float* A, int ld, int kin,
                                         const float (&g)[PAIRS],
                                         float* __restrict__ dW,
                                         float* __restrict__ db, int t) {
  for (int c = 0; c < kin; c += 4) {
    float* d = dW + (long)c * HID + t;
    const float o0 = d[0];
    const float o1 = c + 1 < kin ? d[HID] : 0.f;
    const float o2 = c + 2 < kin ? d[2 * HID] : 0.f;
    const float o3 = c + 3 < kin ? d[3 * HID] : 0.f;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + r * ld + c);
      s0 = fmaf(a.x, g[r], s0);
      s1 = fmaf(a.y, g[r], s1);
      s2 = fmaf(a.z, g[r], s2);
      s3 = fmaf(a.w, g[r], s3);
    }
    d[0] = o0 + s0;
    if (c + 1 < kin) d[HID] = o1 + s1;
    if (c + 2 < kin) d[2 * HID] = o2 + s2;
    if (c + 3 < kin) d[3 * HID] = o3 + s3;
  }
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) s += g[r];
  db[t] += s;
}

__global__ void __launch_bounds__(HID, 1)
mlp_posenc_wsum_bwd(const float* __restrict__ feat_t, const float* __restrict__ pos_t,
                    const float* __restrict__ params, const float* __restrict__ params_t,
                    const float* __restrict__ g_out, float* __restrict__ dfeat_t,
                    float* __restrict__ partial, float* __restrict__ scratch,
                    int inst, int m, int f_dim, int pos_rows, int n_layers,
                    int n_freqs, float freq_c0, int k, long n_params) {
  extern __shared__ __align__(16) float smem[];
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int ld1 = (d1 + 3) & ~3;
  float* h0 = smem;                  // [PAIRS][ld1] layer-1 input
  float* X = h0 + PAIRS * ld1;       // [PAIRS][HID] activation act_l
  float* Y = X + PAIRS * HID;        // [PAIRS][HID] cotangent g_l
  float* wpair = Y + PAIRS * HID;    // [PAIRS]

  const int t = threadIdx.x;
  const int n_pts = m / k;
  const int tiles_per_inst = (m + PAIRS - 1) / PAIRS;
  const long n_tiles = (long)inst * tiles_per_inst;
  float* my_partial = partial + blockIdx.x * n_params;
  float* my_scratch = scratch + (long)blockIdx.x * (n_layers - 2) * PAIRS * HID;

  // offsets of W_l and b_l in params (and of dW_l, db_l in the partials),
  // and of W_l^T in params_t
  long w_off[8], b_off[8], wt_off[8];
  {
    long o = 0, ot = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int kin = l == 0 ? d1 : HID;
      w_off[l] = o;
      b_off[l] = o + (long)kin * HID;
      o = b_off[l] + HID;
      wt_off[l] = ot;
      ot += (long)kin * HID;
    }
  }

  float acc[PAIRS];
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = (int)(tile / tiles_per_inst);
    const int r0 = (int)(tile % tiles_per_inst) * PAIRS;
    build_input(feat_t + (long)i * f_dim * m, pos_t + (long)i * pos_rows * m, h0,
                wpair, r0, m, f_dim, n_freqs, freq_c0, d1, ld1, t);
    __syncthreads();

    // ---- recompute layers 0 .. L-2 -------------------------------------
    for (int l = 0; l < n_layers - 1; ++l) {
      if (l == 0) {
        matmul_col(h0, ld1, d1, params + w_off[0], t, acc);
      } else {
        matmul_col(X, HID, HID, params + w_off[l], t, acc);
      }
      __syncthreads();  // every thread has read its input rows
      const float bt = params[b_off[l] + t];
      float* keep = l < n_layers - 2 ? my_scratch + (long)l * PAIRS * HID : nullptr;
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) {
        const float a = leaky(acc[r] + bt);
        X[r * HID + t] = a;
        if (keep) keep[r * HID + t] = a;
      }
      __syncthreads();
    }

    // ---- cotangent of the last layer's output, per pair ------------------
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      acc[r] = r0 + r < m
          ? wpair[r] * g_out[((long)i * n_pts + (r0 + r) / k) * HID + t] : 0.f;
    }

    // ---- layers L-1 .. 1: X holds act_{l-1}, acc holds g_l ---------------
    for (int l = n_layers - 1; l >= 1; --l) {
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) Y[r * HID + t] = acc[r];
      __syncthreads();
      accum_dw(X, HID, HID, acc, my_partial + w_off[l], my_partial + b_off[l], t);
      matmul_col(Y, HID, HID, params_t + wt_off[l], t, acc);
#pragma unroll
      for (int r = 0; r < PAIRS; ++r) acc[r] *= X[r * HID + t] > 0.f ? 1.f : 0.01f;
      __syncthreads();  // X and Y are free
      if (l >= 2) {
        const float4* src =
            reinterpret_cast<const float4*>(my_scratch + (long)(l - 2) * PAIRS * HID);
        float4* dst = reinterpret_cast<float4*>(X);
        for (int idx = t; idx < PAIRS * HID / 4; idx += HID) dst[idx] = src[idx];
      }
    }

    // ---- layer 0: input h0; dfeat = g_0 W_0[:F]^T -------------------------
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) Y[r * HID + t] = acc[r];
    __syncthreads();
    accum_dw(h0, ld1, d1, acc, my_partial + w_off[0], my_partial + b_off[0], t);
    const float* wt0 = params_t + wt_off[0];  // [HID][d1]
    for (int idx = t; idx < PAIRS * f_dim; idx += HID) {
      const int r = idx / f_dim, f = idx % f_dim;
      float s = 0.f;
      for (int c = 0; c < HID; ++c) s = fmaf(Y[r * HID + c], wt0[(long)c * d1 + f], s);
      X[f * PAIRS + r] = s;  // staged [f][r] for coalesced stores
    }
    __syncthreads();
    float* df = dfeat_t + (long)i * f_dim * m;
    for (int idx = t; idx < PAIRS * f_dim; idx += HID) {
      const int f = idx / PAIRS, r = idx % PAIRS;
      if (r0 + r < m) df[(long)f * m + r0 + r] = X[f * PAIRS + r];
    }
    __syncthreads();  // h0, X and wpair are rebuilt by the next tile
  }
}

// out[j] = sum over blocks b (in order) of partial[b][j].
__global__ void reduce_partials(const float* __restrict__ partial, int n_blocks,
                                long n, float* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long)b * n + j];
  out[j] = s;
}

}  // namespace

// feat_t [inst, f_dim, m], pos_t [inst, pos_rows >= 4, m], out
// [inst, m / k, 256], all f32 contiguous. params packs the layers in order
// as W [k_in, 256] (row-major, k_in = f_dim + 3*(1 + 2*n_freqs) for the
// first layer, 256 after) followed by b [256]. k must divide 64 and m.
// The positional encoding is the 'anchored' method.
// Returns cudaGetLastError() after launch.
extern "C" int fused_mlp_posenc_wsum_fwd(const void* feat_t, const void* pos_t,
                                         const void* params, void* out, int inst,
                                         int m, int f_dim, int pos_rows,
                                         int n_layers, int n_freqs,
                                         float freq_c0, int k,
                                         void* stream) {
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int ld1 = (d1 + 3) & ~3;
  const size_t smem = sizeof(float) * (PAIRS * ld1 + PAIRS * HID + PAIRS);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_posenc_wsum, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + PAIRS - 1) / PAIRS, inst);
  mlp_posenc_wsum<<<grid, HID, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat_t), static_cast<const float*>(pos_t),
      static_cast<const float*>(params), static_cast<float*>(out), m, f_dim,
      pos_rows, n_layers, n_freqs, freq_c0, k);
  return static_cast<int>(cudaGetLastError());
}

// Backward of fused_mlp_posenc_wsum_fwd for the same feat_t, pos_t and
// params, with g_out [inst, m / k, 256] the output cotangent. params_t
// packs W_l^T [256, k_in] of every layer in order (no biases). Writes
// dfeat_t [inst, f_dim, m] and dparams (dW/db packed as params) through
// partial [n_blocks, n_params] (zeroed by the caller) and scratch
// [n_blocks, n_layers - 2, 64, 256]. 2 <= n_layers <= 8. Returns the first
// CUDA error, or cudaSuccess.
extern "C" int fused_mlp_posenc_wsum_bwd(
    const void* feat_t, const void* pos_t, const void* params, const void* params_t,
    const void* g_out, void* dfeat_t, void* dparams, void* partial, void* scratch,
    int inst, int m, int f_dim, int pos_rows, int n_layers, int n_freqs, float freq_c0,
    int k, int n_blocks, long n_params, void* stream) {
  if (n_layers < 2 || n_layers > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int d1 = f_dim + 3 * (1 + 2 * n_freqs);
  const int ld1 = (d1 + 3) & ~3;
  const size_t smem = sizeof(float) * (PAIRS * ld1 + 2 * PAIRS * HID + PAIRS);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_posenc_wsum_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp_posenc_wsum_bwd<<<n_blocks, HID, smem, s>>>(
      static_cast<const float*>(feat_t), static_cast<const float*>(pos_t),
      static_cast<const float*>(params), static_cast<const float*>(params_t),
      static_cast<const float*>(g_out), static_cast<float*>(dfeat_t),
      static_cast<float*>(partial), static_cast<float*>(scratch), inst, m, f_dim,
      pos_rows, n_layers, n_freqs, freq_c0, k, n_params);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  reduce_partials<<<(int)((n_params + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), n_blocks, n_params,
      static_cast<float*>(dparams));
  return static_cast<int>(cudaGetLastError());
}

