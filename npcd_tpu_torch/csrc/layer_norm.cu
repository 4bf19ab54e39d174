// LayerNorm and residual-add + LayerNorm over the last dim, forward and
// backward, f32 and bf16 IO, f32 statistics, for Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/layer_norm.py: _ln_fwd_kernel (K2a, y =
// LN(x)), _lnres_fwd_kernel (K2b, r = x + delta, y = LN(r)), _ln_bwd_kernel
// (K2c) and _lnres_bwd_kernel (K2d), in the arithmetic and rounding points
// of the port's plain versions (ops/kernels/layer_norm.py).
//
// Forward (layer_norm_fwd): every input upcast to f32; r = x + delta summed
// in f32 and written in the IO type; mean = sum(r) / W and var = sum((r -
// mean)^2) / W of the unrounded f32 sum; rstd = rsqrt(var + eps); y = ((r -
// mean) * rstd) * gamma + beta (gamma, beta f32), each product and the sum
// rounded in f32 as the plain version computes them, then rounded once to
// the IO type. mean and rstd (f32 [rows]) are written only when the caller
// passes them (the autograd Function saves them for the backward).
//
// Backward (layer_norm_bwd): from x (r for K2d) in the IO type and the f32
// mean and rstd, xhat = (x - mean) * rstd; dxhat = gy * gamma; m1 =
// sum(dxhat) / W, m2 = sum(dxhat * xhat) / W; dx = rstd * ((dxhat - m1) -
// xhat * m2), plus gr in f32 for K2d, rounded once to the IO type; dgamma =
// sum(gy * xhat) and dbeta = sum(gy) over rows, in f32. A zero pad row with
// zero cotangents gives dx exactly 0.
//
// What bounds both on the H100: HBM bytes. A row of W = 1024 is read once
// (twice with the residual or gr) and written once (twice), with ~10 flops
// per element; the backward reads x and gy (and gr) and writes dx: 136.5
// MB, 41 us, at the bf16 residual form's [16,640, 1024]. The forward's f32
// sampler slabs are small enough that the host's cost per launch sets its
// time. Design:
//   * one warp per row: each lane holds its share of the row in registers
//     (32 f32 values at W = 1024): 16-byte loads (4 f32 or 8 bf16),
//     neighbouring lanes on neighbouring addresses, all of a lane's loads of
//     a row in flight before the first use; where W is not a multiple of the
//     vector or a pointer is not 16-byte aligned, a masked scalar path (lane
//     + 32 i) does the same;
//   * row sums by xor-shuffle trees over the warp (the forward's mean, then
//     the centred variance; the backward's m1 and m2 in one tree carrying
//     both): no shared memory, no __syncthreads, and every lane ends with the
//     same bits (a + b == b + a), so the result is bitwise repeatable;
//   * forward: 4 rows (warps) a block, one row a warp, so [1040, 1024] gives
//     260 blocks over the 132 SMs and [16,640, 1024] 4,160;
//   * backward: a persistent grid of as many 8-warp blocks as the card holds
//     resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); warp g
//     of G takes rows g, g + G, ..., so its loads overlap the other resident
//     warps' row sums and stores (a second row in flight a warp, loaded
//     before the current one's sums, measured no faster, and 4-warp blocks
//     2-6% slower: the last row's tail, ceil(rows / G), weighs more). A lane
//     keeps its slots as loaded, bf16 as bits, and computes xhat and dxhat
//     twice, for the row sums and for dx: bf16 rows in f32 had cost the
//     residual form 194 registers. It adds its columns' gy * xhat and gy
//     across its warp's rows in registers up to 32 values a lane (W <= 1024,
//     the denoiser's width: 152-191 registers at 1024, no spills); above it
//     in the warp's own columns of shared memory, with gr read after the row
//     sums (W <= 2048: 64 values a lane of x and gy leave no room for 128
//     accumulators in 255 registers). The block writes its warps' columns
//     to shared memory and adds them in warp order into one partial row [2,
//     W] per block; a second kernel adds the blocks' rows in a fixed order
//     (warp j of 32 takes blocks j, j + 32, ..., then the 32 sums in warp
//     order) into the [2, W] output. No atomics: two launches give the same
//     bits, and a row's dx does not depend on which warp took it.
// Widths up to MAX_WIDTH (64 values a lane) are instantiated; a wider row
// is refused (cudaErrorInvalidValue). The C entry points launch on the
// given stream and return cudaGetLastError(); nothing allocates (the
// caller passes every output and the backward's partials, as many rows of
// them as layer_norm_bwd_blocks names), so a launch can be captured in a CUDA
// graph.

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

// ---------------------------------------------------------------- backward

constexpr int BWD_WARPS = 8;   // warps (rows in flight) a backward block
constexpr int SUM_WARPS = 32;  // warps a block of the partials' sum
constexpr int REG_ACC = 32;    // values a lane up to which dgamma/dbeta stay in registers
constexpr int MAX_DEVICES = 64;

// E consecutive elements of a row as loaded: f32 values, or the bits of
// bf16 ones (two a register), widened to f32 where they are used.
template <typename T, int E>
struct Raw {
  float v[E];
  __device__ __forceinline__ void fetch(const float* p) { load<E>(p, v); }
  __device__ __forceinline__ float at(int e) const { return v[e]; }
};

template <int E>
struct Raw<bf16, E> {
  static_assert(E == 1 || E == 8, "bf16 rows are read one element or 16 bytes at a time");
  unsigned w[(E + 1) / 2];
  __device__ __forceinline__ void fetch(const bf16* p) {
    if constexpr (E == 1) {
      w[0] = static_cast<unsigned>(__bfloat16_as_ushort(*p)) << 16;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
  }
  __device__ __forceinline__ float at(int e) const {
    if constexpr (E == 1)
      return __uint_as_float(w[0]);
    else
      return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
};

// A persistent grid of BWD_WARPS-warp blocks; warp g of G takes rows g, g +
// G, ... Slot i of a lane holds elements [E (lane + 32 i), +E) of the row,
// kept as loaded (bf16 bits in bf16) through the row sums: xhat and dxhat are
// computed for the sums and again for dx, the same operations on the same
// values. The dynamic shared memory holds [BWD_WARPS][2][width] f32: each
// warp's dgamma columns, then its dbeta columns (the accumulators themselves
// above REG_ACC values a lane, else written there once after the rows). part
// gets the block's row [2, width], its warps' columns added in warp order.
// gr is null unless GR.
template <typename T, int E, int NV, bool GR>
__global__ void __launch_bounds__(32 * BWD_WARPS)
ln_bwd(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ mean,
       const float* __restrict__ rstd, const T* __restrict__ gy, const T* __restrict__ gr,
       T* __restrict__ dx, float* __restrict__ part, int rows, int width) {
  constexpr bool REG = NV * E <= REG_ACC;
  extern __shared__ float4 smem4[];
  float* const cols = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = width / E;  // E divides the width
  float* const acc = cols + 2 * width * warp;
  float dg[NV][E], db[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) dg[i][e] = db[i][e] = 0.f;
    const int s = lane + 32 * i;
    if (!REG && s < slots) {
      store<E>(acc + s * E, dg[i]);
      store<E>(acc + width + s * E, db[i]);
    }
  }
  const long stride = (long)gridDim.x * BWD_WARPS;
  for (long row = (long)blockIdx.x * BWD_WARPS + warp; row < rows; row += stride) {
    const long base = row * width;
    Raw<T, E> xr[NV], gyr[NV], grr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const long off = base + (long)(lane + 32 * i) * E;
      if (lane + 32 * i < slots) {
        xr[i].fetch(x + off);
        gyr[i].fetch(gy + off);
        if constexpr (GR && REG) grr[i].fetch(gr + off);
      }
    }
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int s = lane + 32 * i;
      if (s < slots) {
        float gm[E], tg[E], tb[E];
        load<E>(gamma + (long)s * E, gm);
        if constexpr (!REG) {
          load<E>(acc + s * E, tg);
          load<E>(acc + width + s * E, tb);
        }
        float* const ag = REG ? dg[i] : tg;
        float* const ab = REG ? db[i] : tb;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float g = gyr[i].at(e);
          const float xh = __fmul_rn(__fsub_rn(xr[i].at(e), mu), rs);
          const float dxh = __fmul_rn(g, gm[e]);
          ag[e] = fmaf(g, xh, ag[e]);
          ab[e] = __fadd_rn(ab[e], g);
          s1 = __fadd_rn(s1, dxh);
          s2 = fmaf(dxh, xh, s2);
        }
        if constexpr (!REG) {
          store<E>(acc + s * E, tg);
          store<E>(acc + width + s * E, tb);
        }
      }
    }
    // m1 and m2: one xor-shuffle tree carrying both; every lane gets the same bits
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    const float m1 = s1 / width, m2 = s2 / width;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int s = lane + 32 * i;
      if (s < slots) {
        float gm[E], v[E];
        load<E>(gamma + (long)s * E, gm);
        if constexpr (GR && !REG) grr[i].fetch(gr + base + (long)s * E);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = __fmul_rn(__fsub_rn(xr[i].at(e), mu), rs);
          const float dxh = __fmul_rn(gyr[i].at(e), gm[e]);
          v[e] = __fmul_rn(rs, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2)));
          if constexpr (GR) v[e] = __fadd_rn(v[e], grr[i].at(e));
        }
        store<E>(dx + base + (long)s * E, v);
      }
    }
  }
  if constexpr (REG) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int s = lane + 32 * i;
      if (s < slots) {
        store<E>(acc + s * E, dg[i]);
        store<E>(acc + width + s * E, db[i]);
      }
    }
  }
  __syncthreads();
  float* const out = part + (long)blockIdx.x * 2 * width;
  for (int c = threadIdx.x; c < 2 * width; c += 32 * BWD_WARPS) {
    float v = cols[c];
#pragma unroll
    for (int w = 1; w < BWD_WARPS; ++w) v = __fadd_rn(v, cols[2 * width * w + c]);
    out[c] = v;
  }
}

// out[c] = the sum of part[b][c] over the blocks b < blocks, in a fixed
// order: warp j adds blocks j, j + SUM_WARPS, ... in turn (lane = column),
// then warp 0 adds the SUM_WARPS sums in warp order. blocks may be 0.
__global__ void __launch_bounds__(32 * SUM_WARPS)
ln_bwd_sum(const float* __restrict__ part, int blocks, int n, float* __restrict__ out) {
  __shared__ float sums[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (c < n) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += SUM_WARPS) v = __fadd_rn(v, part[(long)b * n + c]);
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < SUM_WARPS; ++w) t = __fadd_rn(t, sums[w][lane]);
    out[c] = t;
  }
}

size_t bwd_smem(int width) { return sizeof(float) * 2 * width * BWD_WARPS; }

// The blocks of one instantiation that the card holds resident at this
// width, found once per device and width (the shared-memory limit raised
// to the widest row's first); 0 after a CUDA error.
template <typename T, int E, int NV, bool GR>
int resident_blocks(int width) {
  static int cached_width[MAX_DEVICES], cached_blocks[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return 0;
  if (cached_width[dev] != width) {
    auto kernel = ln_bwd<T, E, NV, GR>;
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bwd_smem(MAX_WIDTH))) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * BWD_WARPS,
                                                      bwd_smem(width)) != cudaSuccess)
      return 0;
    cached_blocks[dev] = sms * per_sm;
    cached_width[dev] = width;
  }
  return cached_blocks[dev];
}

template <typename T, int E, int NV, bool GR>
int launch_bwd(const void* x, const void* gamma, const void* mean, const void* rstd,
               const void* gy, const void* gr, void* dx, void* out, void* part, int rows,
               int width, int max_blocks, cudaStream_t s) {
  int blocks = 0;
  if (rows > 0) {
    const int resident = resident_blocks<T, E, NV, GR>(width);
    if (resident < 1) {
      const cudaError_t err = cudaGetLastError();
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    }
    blocks = (rows + BWD_WARPS - 1) / BWD_WARPS;
    blocks = blocks < resident ? blocks : resident;
    blocks = blocks < max_blocks ? blocks : max_blocks;
    ln_bwd<T, E, NV, GR><<<blocks, 32 * BWD_WARPS, bwd_smem(width), s>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const T*>(gy), static_cast<const T*>(gr), static_cast<T*>(dx),
        static_cast<float*>(part), rows, width);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ln_bwd_sum<<<(2 * width + 31) / 32, 32 * SUM_WARPS, 0, s>>>(
      static_cast<const float*>(part), blocks, 2 * width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, bool GR>
int launch_bwd_e(const void* x, const void* gamma, const void* mean, const void* rstd,
                 const void* gy, const void* gr, void* dx, void* out, void* part, int rows,
                 int width, int max_blocks, int per_lane, cudaStream_t s) {
#define LN_BWD_LAUNCH(K)                                                                       \
  launch_bwd<T, E, K / E, GR>(x, gamma, mean, rstd, gy, gr, dx, out, part, rows, width,       \
                              max_blocks, s)
  if (per_lane <= 8) return LN_BWD_LAUNCH(8);
  if (per_lane <= 16) return LN_BWD_LAUNCH(16);
  if (per_lane <= 32) return LN_BWD_LAUNCH(32);
  return LN_BWD_LAUNCH(64);
#undef LN_BWD_LAUNCH
}

template <typename T, int E, bool GR>
int resident_e(int width) {
  const int per_lane = (width + 31) / 32;
  if (per_lane <= 8) return resident_blocks<T, E, 8 / E, GR>(width);
  if (per_lane <= 16) return resident_blocks<T, E, 16 / E, GR>(width);
  if (per_lane <= 32) return resident_blocks<T, E, 32 / E, GR>(width);
  return resident_blocks<T, E, 64 / E, GR>(width);
}

// The most blocks a backward of rows x width launches, whichever of its
// instantiations the pointers' alignment and gr select: the partial rows the
// caller provides. -1 after a CUDA error.
template <typename T>
int bwd_blocks_t(int rows, int width) {
  constexpr int V = 16 / sizeof(T);
  int most = resident_e<T, 1, false>(width);
  const int others[3] = {resident_e<T, 1, true>(width),
                         width % V ? most : resident_e<T, V, false>(width),
                         width % V ? most : resident_e<T, V, true>(width)};
  for (int r : others) {
    if (r < 1 || most < 1) return -1;
    most = r > most ? r : most;
  }
  const int blocks = (rows + BWD_WARPS - 1) / BWD_WARPS;
  return blocks < most ? blocks : most;
}

template <typename T>
int launch_bwd_t(const void* x, const void* gamma, const void* mean, const void* rstd,
                 const void* gy, const void* gr, void* dx, void* out, void* part, int rows,
                 int width, int max_blocks, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int per_lane = (width + 31) / 32;
  const bool vec = width % V == 0 && aligned16(x) && aligned16(gamma) && aligned16(gy) &&
                   aligned16(gr) && aligned16(dx);
#define LN_BWD_ARGS \
  x, gamma, mean, rstd, gy, gr, dx, out, part, rows, width, max_blocks, per_lane, s
  if (gr != nullptr)
    return vec ? launch_bwd_e<T, V, true>(LN_BWD_ARGS) : launch_bwd_e<T, 1, true>(LN_BWD_ARGS);
  return vec ? launch_bwd_e<T, V, false>(LN_BWD_ARGS) : launch_bwd_e<T, 1, false>(LN_BWD_ARGS);
#undef LN_BWD_ARGS
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

// The backward of layer_norm_fwd. x (r for the residual form), gy, gr, dx
// [rows, width] contiguous in the IO type (bf16 != 0: bfloat16, else
// float32); gamma [width], mean, rstd [rows] f32; gr null without the
// residual's cotangent. out [2, width] f32 gets dgamma, then dbeta; part
// holds max_blocks partial rows [2, width] f32 (the grid takes at most
// that many blocks; layer_norm_bwd_blocks says how many it needs). width in
// [1, 2048], max_blocks >= 1 when rows > 0 (cudaErrorInvalidValue
// otherwise). Returns cudaGetLastError() after the launches.
extern "C" int layer_norm_bwd(const void* x, const void* gamma, const void* mean,
                              const void* rstd, const void* gy, const void* gr, void* dx,
                              void* out, void* part, int rows, int width, int max_blocks,
                              int bf16_io, void* stream) {
  if (width < 1 || width > MAX_WIDTH || rows < 0 || (rows > 0 && max_blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_io ? launch_bwd_t<bf16>(x, gamma, mean, rstd, gy, gr, dx, out, part, rows, width,
                                      max_blocks, s)
                 : launch_bwd_t<float>(x, gamma, mean, rstd, gy, gr, dx, out, part, rows,
                                       width, max_blocks, s);
}

// The partial rows layer_norm_bwd needs for rows x width on the current
// device (0 when rows is 0): its max_blocks. The negated CUDA error after a
// failure, -cudaErrorInvalidValue for a width or row count it does not take.
extern "C" int layer_norm_bwd_blocks(int rows, int width, int bf16_io) {
  if (width < 1 || width > MAX_WIDTH || rows < 0) return -static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int blocks = bf16_io ? bwd_blocks_t<bf16>(rows, width) : bwd_blocks_t<float>(rows, width);
  if (blocks >= 1) return blocks;
  const cudaError_t err = cudaGetLastError();
  return -static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
}
