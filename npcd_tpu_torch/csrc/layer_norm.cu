// LayerNorm forward and residual-add + LayerNorm forward over the last dim,
// f32 and bf16 IO, f32 statistics, for Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/layer_norm.py: _ln_fwd_kernel (K2a, y =
// LN(x)) and _lnres_fwd_kernel (K2b, r = x + delta, y = LN(r)), in the
// arithmetic and rounding points of the port's plain version
// (ops/kernels/layer_norm.py:layer_norm_fwd_plain): every input upcast to
// f32; r = x + delta summed in f32 and written in the IO type; mean =
// sum(r) / W and var = sum((r - mean)^2) / W of the unrounded f32 sum;
// rstd = rsqrt(var + eps); y = ((r - mean) * rstd) * gamma + beta (gamma,
// beta f32), each product and the sum rounded in f32 as the plain version
// computes them, then rounded once to the IO type. mean and rstd (f32 [rows])
// are written only when the caller passes them (the autograd Function saves
// them for the backward, K2c/K2d, which stay in Triton).
//
// What bounds it on the H100: a row of W = 1024 is read once (twice with
// the residual) and written once (twice), with ~10 flops per element: HBM
// bytes, 4.2 / 8.4 MB per 1024 rows in f32, so a whole [1040, 1024] f32
// launch is ~2.5 us of the card's bandwidth, and the denoiser's f32 slabs
// are small enough that the host's cost per launch (the Python wrapper,
// the launch itself) sets the time, not the device. Design:
//   * one warp per row, 4 rows (warps) per block, so [1040, 1024] gives
//     260 blocks over the 132 SMs and [16,640, 1024] 4,160;
//   * each lane holds its share of the row in registers (32 f32 values at
//     W = 1024): 16-byte loads (4 f32 or 8 bf16), neighbouring lanes on
//     neighbouring addresses, all of a lane's loads in flight before the
//     first use; where W is not a multiple of the vector or a pointer is not 16-
//     byte aligned, a masked scalar path (lane + 32 i) does the same;
//   * mean, then the centred variance, by xor-shuffle trees over the warp:
//     no shared memory, no __syncthreads, and every lane ends with the same
//     bits (a + b == b + a), so the result is bitwise repeatable;
//   * x and delta are read once, r and y written from registers.
// Widths up to MAX_WIDTH (64 values a lane) are instantiated; a wider row
// is refused (cudaErrorInvalidValue). The C entry point launches on the
// given stream and returns cudaGetLastError(); nothing allocates, so a
// launch can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;  // rows per block
constexpr int MAX_WIDTH = 2048;

typedef __nv_bfloat16 bf16;

// E consecutive elements of a row from p as f32 (E = 1, or 16 bytes)
template <int E>
__device__ __forceinline__ void load(const float* p, float* out) {
  if constexpr (E == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void load(const bf16* p, float* out) {
  if constexpr (E == 1) {
    out[0] = __bfloat162float(*p);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int E>
__device__ __forceinline__ void store(float* p, const float* in) {
  if constexpr (E == 1) {
    *p = in[0];
  } else {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
  }
}

// rounded to bf16 to nearest even, once
template <int E>
__device__ __forceinline__ void store(bf16* p, const float* in) {
  if constexpr (E == 1) {
    *p = __float2bfloat16_rn(in[0]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      w[i] = *reinterpret_cast<unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp per row. Slot i of a lane holds elements [E (lane + 32 i), +E)
// of the row (the masked slots, past the width, hold 0 and are left out).
// delta and r are null without the residual; mean and rstd null when the
// statistics are not saved.
template <typename T, int E, int NV>
__global__ void __launch_bounds__(32 * WARPS)
ln_fwd(const T* __restrict__ x, const T* __restrict__ delta, const float* __restrict__ gamma,
       const float* __restrict__ beta, T* __restrict__ y, T* __restrict__ r,
       float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int width,
       float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int slots = width / E;  // E divides the width
  const long base = row * width;
  float v[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int s = lane + 32 * i;
    if (s < slots) {
      load<E>(x + base + (long)s * E, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = 0.f;
    }
  }
  if (delta != nullptr) {
    float d[NV][E];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < slots) load<E>(delta + base + (long)(lane + 32 * i) * E, d[i]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int s = lane + 32 * i;
      if (s < slots) {
#pragma unroll
        for (int e = 0; e < E; ++e) v[i][e] += d[i][e];
        store<E>(r + base + (long)s * E, v[i]);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) sum += v[i][e];
  const float mean = warp_sum(sum) / width;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < slots) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[i][e] -= mean;  // centred, in place
        sq = fmaf(v[i][e], v[i][e], sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / width + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int s = lane + 32 * i;
    if (s < slots) {
      float gm[E], bt[E];
      load<E>(gamma + (long)s * E, gm);
      load<E>(beta + (long)s * E, bt);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[i][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e], rstd), gm[e]), bt[e]);
      store<E>(y + base + (long)s * E, v[i]);
    }
  }
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, int E, int NV>
int launch(const void* x, const void* delta, const void* gamma, const void* beta, void* y,
           void* r, void* mean, void* rstd, int rows, int width, float eps, cudaStream_t s) {
  const dim3 grid((rows + WARPS - 1) / WARPS);
  ln_fwd<T, E, NV><<<grid, 32 * WARPS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), static_cast<T*>(r),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation holding `per_lane` values a lane (8, 16, 32 or 64) in
// slots of E elements.
template <typename T, int E>
int launch_e(const void* x, const void* delta, const void* gamma, const void* beta, void* y,
             void* r, void* mean, void* rstd, int rows, int width, float eps, int per_lane,
             cudaStream_t s) {
#define LN_LAUNCH(K) \
  launch<T, E, K / E>(x, delta, gamma, beta, y, r, mean, rstd, rows, width, eps, s)
  if (per_lane <= 8) return LN_LAUNCH(8);
  if (per_lane <= 16) return LN_LAUNCH(16);
  if (per_lane <= 32) return LN_LAUNCH(32);
  return LN_LAUNCH(64);
#undef LN_LAUNCH
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0; }

template <typename T>
int launch_t(const void* x, const void* delta, const void* gamma, const void* beta, void* y,
             void* r, void* mean, void* rstd, int rows, int width, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int per_lane = (width + 31) / 32;
  const bool vec = width % V == 0 && aligned16(x) && aligned16(delta) && aligned16(gamma) &&
                   aligned16(beta) && aligned16(y) && aligned16(r);
  if (vec)
    return launch_e<T, V>(x, delta, gamma, beta, y, r, mean, rstd, rows, width, eps, per_lane, s);
  return launch_e<T, 1>(x, delta, gamma, beta, y, r, mean, rstd, rows, width, eps, per_lane, s);
}

}  // namespace

// x, delta, y, r [rows, width] contiguous in the IO type (bf16 != 0:
// bfloat16, else float32); gamma, beta [width] f32; mean, rstd [rows] f32.
// delta and r null without the residual; mean and rstd null when the
// statistics are not wanted. width in [1, 2048] (cudaErrorInvalidValue
// otherwise). Returns cudaGetLastError() after the launch.
extern "C" int layer_norm_fwd(const void* x, const void* delta, const void* gamma,
                              const void* beta, void* y, void* r, void* mean, void* rstd,
                              int rows, int width, float eps, int bf16_io, void* stream) {
  if (width < 1 || width > MAX_WIDTH || rows < 0 || (delta == nullptr) != (r == nullptr) ||
      (mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_t<bf16>(x, delta, gamma, beta, y, r, mean, rstd, rows, width, eps, s)
                 : launch_t<float>(x, delta, gamma, beta, y, r, mean, rstd, rows, width, eps, s);
}
