// Posenc-fused aggregation MLP with the k-neighbour weighted sum, forward,
// f32, for Hopper (sm_90a).
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

  // ---- layer-1 input --------------------------------------------------
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
