// k-nearest-neighbour search over one object's points, f32, for Hopper,
// and the minimum squared distance (min_d2_kernel, below).
//
// Replaces npcd_tpu/ops/pallas/knn.py:pallas_knn_t (_knn_kernel): for each
// query, the k nearest of the instance's P points by the direct sum of
// squared differences, in ascending order, ties resolved to the lower point
// index (lax.top_k's order). The radius mask is applied by the caller.
// Layout: queries [I, N, 3], points [I, P, 3] -> idx [I, N, k] int32 and
// d2 [I, N, k] f32 (the layout ops/knn.py:dense_knn_batched returns).
// Where P < k the trailing slots hold (index 0, d2 = inf), as in the TPU
// kernel.
//
// What bounds it on the H100: about 9 flops per (query, point) pair and 12
// bytes read per query; at P = 512 that is ~4.6 kflop per 44 bytes, so it
// is bound by the FP32 pipes and the per-pair compare/insert, not by memory.
// Design: one thread per query and one block per (instance, 128-query
// tile); the instance's P x 3 points are staged in shared memory (6 KB at
// P = 512) and read as warp-wide broadcasts; the running top-k lives in
// registers as a sorted insertion list (k = 8, the config's, fully
// unrolled).
// The TPU kernel packs the point index into the low mantissa bits of d2 to
// get one-pass min reductions; here d2 keeps all its bits. The products and
// sums use round-to-nearest intrinsics so nvcc does not contract them into
// FMAs: d2 is then the same float as the plain PyTorch ((p - x)**2).sum().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int K = 8;  // neighbours per query

__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ x, const float* __restrict__ pts,
           int* __restrict__ idx_out, float* __restrict__ d2_out, int n,
           int p) {
  extern __shared__ float sp[];  // [p][3]
  const int inst = blockIdx.y;
  const float* src = pts + (long)inst * p * 3;
  for (int i = threadIdx.x; i < p * 3; i += THREADS) sp[i] = src[i];
  __syncthreads();

  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const float* xq = x + ((long)inst * n + q) * 3;
  const float x0 = xq[0], x1 = xq[1], x2 = xq[2];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  for (int j = 0; j < p; ++j) {
    const float dx = __fsub_rn(sp[3 * j], x0);
    const float dy = __fsub_rn(sp[3 * j + 1], x1);
    const float dz = __fsub_rn(sp[3 * j + 2], x2);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < bd[K - 1]) {
      // insert after every entry <= d (equal distances keep index order)
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        if (s > 0 && bd[s - 1] > d) {
          bd[s] = bd[s - 1];
          bi[s] = bi[s - 1];
        } else if (bd[s] > d) {
          bd[s] = d;
          bi[s] = j;
        }
      }
    }
  }
  const long o = ((long)inst * n + q) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    idx_out[o + s] = bi[s];
    d2_out[o + s] = bd[s];
  }
}

// Minimum squared distance from each query to the instance's points.
//
// Replaces npcd_tpu/ops/pallas/knn.py:pallas_min_d2_t (_min_d2_kernel), the
// sample-validity test of stage-1 training and of `validity: knn` renders
// (min d2 < radius^2). Same layout and arithmetic as knn_kernel with k = 1
// and no index: one thread per query, the P x 3 points in shared memory, a
// running min of the round-to-nearest sum ((dx*dx + dy*dy) + dz*dz), so
// the result is the same float as the plain PyTorch version and a validity
// bit cannot flip between the card and the CPU. ~9 flops per (query,
// point) pair against 16 bytes per query: bound by the FP32 pipes.
__global__ void __launch_bounds__(THREADS)
min_d2_kernel(const float* __restrict__ x, const float* __restrict__ pts,
              float* __restrict__ out, int n, int p) {
  extern __shared__ float sp[];  // [p][3]
  const int inst = blockIdx.y;
  const float* src = pts + (long)inst * p * 3;
  for (int i = threadIdx.x; i < p * 3; i += THREADS) sp[i] = src[i];
  __syncthreads();

  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const float* xq = x + ((long)inst * n + q) * 3;
  const float x0 = xq[0], x1 = xq[1], x2 = xq[2];
  float best = INFINITY;
  for (int j = 0; j < p; ++j) {
    const float dx = __fsub_rn(sp[3 * j], x0);
    const float dy = __fsub_rn(sp[3 * j + 1], x1);
    const float dz = __fsub_rn(sp[3 * j + 2], x2);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    best = fminf(best, d);
  }
  out[(long)inst * n + q] = best;
}

}  // namespace

// x [inst, n, 3], pts [inst, p, 3] f32 contiguous; out [inst, n] (inf
// where p = 0). p * 12 bytes must fit 48 KB of shared memory (p <= 4096).
// Returns cudaGetLastError() after launch.
extern "C" int min_d2_fwd(const void* x, const void* pts, void* out, int inst,
                          int n, int p, void* stream) {
  dim3 grid((n + THREADS - 1) / THREADS, inst);
  min_d2_kernel<<<grid, THREADS, p * 3 * sizeof(float),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pts),
      static_cast<float*>(out), n, p);
  return static_cast<int>(cudaGetLastError());
}

// x [inst, n, 3], pts [inst, p, 3] f32 contiguous; idx/d2 [inst, n, 8].
// k must be 8; p * 12 bytes must fit the 48 KB of static-size shared
// memory (p <= 4096). Returns cudaGetLastError() after launch, or
// cudaErrorInvalidValue for another k.
extern "C" int knn_fwd(const void* x, const void* pts, void* idx, void* d2,
                       int inst, int n, int p, int k, void* stream) {
  if (k != K) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + THREADS - 1) / THREADS, inst);
  knn_kernel<<<grid, THREADS, p * 3 * sizeof(float),
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pts),
      static_cast<int*>(idx), static_cast<float*>(d2), n, p);
  return static_cast<int>(cudaGetLastError());
}
