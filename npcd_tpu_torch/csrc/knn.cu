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
// is bound by issuing instructions and by shared-memory loads, not by
// HBM: the exact distance takes 8 FP32 instructions a pair (no FMA: see
// below), and keeping the k best costs more than that wherever it runs.
// The plain way, one thread per query with a sorted insertion list, spends
// ~40 instructions per insertion and a warp pays one whenever any of its 32
// queries inserts, which is on most of the 512 steps (a query inserts ~8 (1
// + ln(P / 8)) times, mostly early, and 32 queries rarely all skip): 2.23
// ms at the stage-1 shape. Four lanes a query with its list spread over
// them, one insertion round per step that has a candidate, ran 2.20; the
// sweeps below with the four lanes reading their own points, 2.81 (a
// warp's 128-bit shared load then serves several addresses).
// Design: two sweeps over the points that insert nothing, every lane of a
// warp loading the same four points at once (the points in shared memory
// as x, y and z arrays, three 128-bit broadcast loads per four points), L
// lanes per query taking the four-point groups in turn. L = 1, one thread
// per query, where that fills the card: device time on the H100 at 700 W
// (chip_smoke.py phases 8 and 11, a replayed CUDA graph) 1.228 ms at the
// stage-1 shape (400 x 5,600 queries) against 1.666 at L = 4, 0.429 at the
// fast step's (400 x 1,792) against 0.541; L = 4 below FEW_QUERIES queries
// a launch, where one thread a query leaves each SM fewer than 32 warps and
// the sweeps' latency shows: 0.039 ms at the render's (8 x 5,120) against
// 0.045, 0.0134 at the TV loss's (8 x 512) against 0.0316 (L = 2, timed
// from the host only: 1.39 ms at the stage-1 shape, 0.46 at the fast
// step's):
//   1. each lane keeps the KC / 4 smallest d2 of each of the four
//      interleaved subsets of its points (a min/max chain, no branch); with
//      q = ceil(k / 4), the q smallest of each subset are 4 q >= k distinct
//      points, so t, the largest of the four subsets' q-th smallest, bounds
//      the k-th smallest d2 of the query, and so does the least t of its
//      lanes (k 8: the two smallest of each subset);
//   2. each lane stores the indices of its points with d2 <= t in shared
//      memory (a predicated store): ~14 a query at P = 512, k 8 and one
//      lane (t sits near rank 14), in ascending index;
// then each lane inserts its candidates, with their exact d2, into a sorted
// list of KC (strict compares in ascending index: ties keep the lower
// index), and the L lists are merged with shuffles, k rounds of the
// lexicographic (d2, index) minimum over the query's lanes (a stable sort's
// order). Both sweeps take d2 with two FMAs (6 instructions, not 8): within
// 6 ulps (~2**-21.4 relative) of the exact d2, both being sums of three
// non-negative terms from the same dx, dy, dz that round at most three
// times; so sweep 2 keeps every point whose approximate d2 is at most t (1
// + 2**-18) (+ 2**-100 for subnormals), which holds every point whose exact
// d2 ties or beats the k-th smallest. A lane with more than CAP candidates
// (many exact ties at the bound) inserts every point of its share instead.
// k is a run-time value below a compile-time ceiling KC of 8, 16 or 32 (the
// list's length; the smallest ceiling at or above k is launched), so k 6
// and 12 run the kernels of 8 and 16 and write their first k slots.
// The exact d2 uses round-to-nearest intrinsics so nvcc does not contract
// them into FMAs: it is the same float as the plain PyTorch version's
// ((dx*dx + dy*dy) + dz*dz). Shared memory: the points, P rounded up to 4
// (+inf past P, so their d2 is inf), 12 bytes each (6 KB at P = 512, 48 KB
// at the limit of 4096), and CAP candidate indices a lane (12, 20 or 36 KB
// at KC 8, 16, 32). The TPU kernel packs the point index into the low
// mantissa bits of d2 to get one-pass min reductions; here d2 keeps all
// its bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // a block, of min_d2_kernel and of knn_kernel
constexpr int MAX_K = 32;     // the largest k: the largest list ceiling KC
// candidates a lane keeps, for a list of KC
__host__ __device__ constexpr int cap_of(int kc) { return kc == 8 ? 48 : kc == 16 ? 80 : 144; }
// below this many queries a launch, one thread a query gives each of the
// H100's 132 SMs fewer than 32 warps: four lanes a query there
constexpr long FEW_QUERIES = 132L * 32 * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int QUERIES = 4;  // min_d2_kernel: queries a thread
constexpr int GROUPS = 32;  // min_d2_kernel: groups of points a query keeps a minimum of

// d2 as the plain version rounds it: ((dx*dx + dy*dy) + dz*dz)
__device__ __forceinline__ float dist2(float px, float py, float pz, float x0, float x1,
                                       float x2) {
  const float dx = __fsub_rn(px, x0);
  const float dy = __fsub_rn(py, x1);
  const float dz = __fsub_rn(pz, x2);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// d2 with two FMAs, within 6 ulps of dist2
__device__ __forceinline__ float dist2_fma(float px, float py, float pz, float x0, float x1,
                                           float x2) {
  const float dx = __fsub_rn(px, x0);
  const float dy = __fsub_rn(py, x1);
  const float dz = __fsub_rn(pz, x2);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// The four points of group g's approximate d2.
__device__ __forceinline__ float4 dist2_fma4(const float4* px, const float4* py,
                                             const float4* pz, int g, float x0, float x1,
                                             float x2) {
  const float4 a = px[g], b = py[g], c = pz[g];
  return make_float4(dist2_fma(a.x, b.x, c.x, x0, x1, x2), dist2_fma(a.y, b.y, c.y, x0, x1, x2),
                     dist2_fma(a.z, b.z, c.z, x0, x1, x2), dist2_fma(a.w, b.w, c.w, x0, x1, x2));
}

// (d, j) into the sorted list (bd, bi) after every entry <= d.
template <int KC>
__device__ __forceinline__ void insert(float (&bd)[KC], int (&bi)[KC], float d, int j) {
#pragma unroll
  for (int s = KC - 1; s >= 0; --s) {  // from the end: each reads the old s - 1
    if (s > 0 && bd[s - 1] > d) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (bd[s] > d) {
      bd[s] = d;
      bi[s] = j;
    }
  }
}

template <int L, int KC>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ x, const float* __restrict__ pts,
           int* __restrict__ idx_out, float* __restrict__ d2_out, int n, int p, int k) {
  constexpr int QB = THREADS / L;  // queries a block
  constexpr int CAP = cap_of(KC), M = KC / 4;
  extern __shared__ float4 sp4[];  // x, y, z of the points: 3 arrays of p4 / 4 float4
  __shared__ unsigned short cj[CAP][THREADS];  // each lane's candidates (p <= 4096)
  const int groups = (p + 3) / 4, p4 = 4 * groups;
  float* sp = reinterpret_cast<float*>(sp4);
  const int inst = blockIdx.y;
  const float* src = pts + (long)inst * p * 3;
  for (int i = threadIdx.x; i < p4; i += THREADS) {
    const bool real = i < p;
    sp[i] = real ? src[3 * i] : INFINITY;
    sp[p4 + i] = real ? src[3 * i + 1] : INFINITY;
    sp[2 * p4 + i] = real ? src[3 * i + 2] : INFINITY;
  }
  __syncthreads();
  const float4 *px = sp4, *py = sp4 + groups, *pz = sp4 + 2 * groups;

  const int lane = threadIdx.x & 31, r = lane & (L - 1);  // r: the lane's rank in its query
  const int q = blockIdx.x * QB + threadIdx.x / L;
  const bool ok = q < n;  // the same for a query's L lanes
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (ok) {
    const float* xq = x + ((long)inst * n + q) * 3;
    x0 = xq[0];
    x1 = xq[1];
    x2 = xq[2];
  }

  // sweep 1: the M smallest approximate d2 of each subset u of the lane's
  // points (4 g + u for its groups g = r, r + L, ...), ascending
  float ms[4][M];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < M; ++e) ms[u][e] = INFINITY;
  for (int g = r; g < groups; g += L) {
    const float4 d = dist2_fma4(px, py, pz, g, x0, x1, x2);
    const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = dv[u];
#pragma unroll
      for (int e = 0; e < M; ++e) {
        const float lo = fminf(ms[u][e], v);
        v = fmaxf(ms[u][e], v);
        ms[u][e] = lo;
      }
    }
  }
  // the largest of the subsets' q-th smallest, q = ceil(k / 4); inf without
  // 4 q points
  const int q_th = (k + 3) / 4 - 1;
  float t = 0.f;
#pragma unroll
  for (int e = 0; e < M; ++e)
    if (e == q_th) t = fmaxf(fmaxf(ms[0][e], ms[1][e]), fmaxf(ms[2][e], ms[3][e]));
#pragma unroll
  for (int o = 1; o < L; o <<= 1) t = fminf(t, __shfl_xor_sync(FULL, t, o));
  const float bound = ok ? __fmaf_rn(t, 1.f + 0x1p-18f, 0x1p-100f) : -1.f;

  // sweep 2: the lane's candidates, in ascending index
  int c = 0;
  for (int g = r; g < groups; g += L) {
    const float4 d = dist2_fma4(px, py, pz, g, x0, x1, x2);
    const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dv[u] <= bound) {
        if (c < CAP) cj[c][threadIdx.x] = static_cast<unsigned short>(4 * g + u);
        ++c;
      }
  }

  // the lane's k best by exact d2: its candidates, or (past CAP) its points;
  // empty slots (inf, an index past every point's, distinct per lane)
  float bd[KC];
  int bi[KC];
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0x7fffffff - r;
  }
  if (c <= CAP) {
    for (int i = 0; i < c; ++i) {
      const int j = cj[i][threadIdx.x];
      if (j >= p) continue;  // a pad point (p < 8: every point is a candidate)
      const float d = dist2(sp[j], sp[p4 + j], sp[2 * p4 + j], x0, x1, x2);
      if (d < bd[KC - 1]) insert(bd, bi, d, j);
    }
  } else {
    for (int g = r; g < groups; g += L)
      for (int j = 4 * g; j < min(4 * g + 4, p); ++j) {
        const float d = dist2(sp[j], sp[p4 + j], sp[2 * p4 + j], x0, x1, x2);
        if (d < bd[KC - 1]) insert(bd, bi, d, j);
      }
  }

  // merge the query's L lists: k rounds of the (d2, index) minimum of their
  // heads; the winner (indices are distinct) pops its head; lane s % L
  // writes slot s, slots past p (0, inf)
  const long o = ((long)inst * n + q) * k;
#pragma unroll
  for (int s = 0; s < KC; ++s) {
    if (s >= k) break;  // the same for every lane
    float md = bd[L > 1 ? 0 : s];
    int mi = bi[L > 1 ? 0 : s];
#pragma unroll
    for (int w = 1; w < L; w <<= 1) {
      const float od = __shfl_xor_sync(FULL, md, w);
      const int oi = __shfl_xor_sync(FULL, mi, w);
      if (od < md || (od == md && oi < mi)) {
        md = od;
        mi = oi;
      }
    }
    if (ok && r == s % L) {
      idx_out[o + s] = mi < p ? mi : 0;
      d2_out[o + s] = md;
    }
    if (L > 1 && bi[0] == mi) {
#pragma unroll
      for (int e = 0; e < KC - 1; ++e) {
        bd[e] = bd[e + 1];
        bi[e] = bi[e + 1];
      }
      bd[KC - 1] = INFINITY;
      bi[KC - 1] = 0x7fffffff - r;
    }
  }
}

// Minimum squared distance from each query to the instance's points (K5).
//
// Replaces npcd_tpu/ops/pallas/knn.py:pallas_min_d2_t (_min_d2_kernel), the
// sample-validity test of stage-1 training and of `validity: knn` renders
// (min d2 < radius^2). The result is bitwise the plain PyTorch version's:
// the f32 minimum over all P points of d = ((dx*dx + dy*dy) + dz*dz), each
// operation rounded, so a validity bit cannot flip between the card and the
// CPU. x [I, N, 3], points [I, P, 3] -> [I, N]; inf where P = 0.
//
// What bounds it on the H100: issuing instructions. Every pair is needed
// (the minimum over all P points, as the TPU kernel computes it): at P = 512
// ~1,550 FP32 instructions a query (3 a pair and the exact pass) against 16
// bytes. A direct loop over the pairs (this kernel until it was redesigned)
// issues 11 instructions a pair in its SASS (44 a 4 points: 5 FADD, 3 FMUL,
// 1 FMNMX, 3/4 LDS.128, 3/4 of the loop's):
// 1.067 ms at the stage-1 shape (400 x 14,336 x 512; H100 at 700 W, a
// replayed CUDA graph), near full issue. The redesign sweeps every pair with
// a cheaper filter and takes the exact d only where the filter cannot rule
// a point out:
//   - point j sits in shared memory as one float4 (-px, -py, -pz, |p|^2),
//     |p|^2 = fma(pz, pz, fma(py, py, px*px)); one broadcast LDS.128 serves
//     a thread's QUERIES = 4 queries (168 registers, 3 blocks an SM; 2 and 3
//     queries a thread, more loads a pair, ran 8% and 4% slower: PERF.md);
//   - the filter s = fma(-pz, 2 x2, fma(-py, 2 x1, fma(-px, 2 x0, |p|^2))),
//     |p - x|^2 - |x|^2 up to rounding: 3 FFMA and 1 FMNMX a pair; the
//     sweep's SASS is 548 instructions a 128 pairs (384 FFMA, 128 FMNMX, 32
//     LDS.128, 4 of the loop's), 4.28 a pair;
//   - each query keeps the minimum of s per group of points, group g holding
//     points g, g + 32, g + 64, ... (GROUPS = 32: 128 registers a thread);
//     with s_min the least of them, the groups whose minimum is at most the
//     bound t = fl(s_min + fma(2^-18, fl(r2 + |x|^2), 2^-100)) (r2 the
//     instance's largest |p|^2, |x|^2 computed as |p|^2 is) take the exact
//     pass: dist2 of every point of the group, 11 instructions a point in
//     the SASS; usually one group, 16 points at P = 512. Lanes of a warp in
//     different groups read points g + 32 k at the same k: distinct banks.
// Why the exact minimum is never lost (u = 2^-24, gamma_k = k u / (1 - k u),
// no overflow): d is within gamma_5 |p - x|^2 of |p - x|^2 (five roundings
// of non-negative terms); |p|^2 is within gamma_3 of its value and the
// three FMAs add at most gamma_3 (|p|^2 (1 + gamma_3) + 2 |p| |x|), so with
// 2 |p| |x| <= |p|^2 + |x|^2 and |p - x|^2 <= 2 (|p|^2 + |x|^2), |s + |x|^2
// - d| <= E = (gamma_3 (3 + gamma_3) + 2 gamma_5) (|p|^2 + |x|^2) ~ 19 u
// (|p|^2 + |x|^2). If point a has the least d and point b the least s, then
// s_a <= d_a - |x|^2 + E <= d_b - |x|^2 + E <= s_b + 2E = s_min + 2E, and t
// covers s_min + 2E: 2E <= 38 u (1 + 4u) (r2 + |x|^2) as computed, t's own
// roundings cost at most ~2 u (r2 + |x|^2), against 2^-18 = 64 u of it; the
// 2^-100 covers underflow (each rounding's absolute error is at most
// 2^-150). So a's group is taken, and the least exact d over the taken
// groups' points is the least over all points. Where r2 + |x|^2 is above
// 2^100 or not finite, every group is taken. Only exact d reach the output:
// npcd_tpu's XLA path returns |x|^2 - 2 x.p + |p|^2 itself, and flips
// validity bits against the direct sum.
__global__ void __launch_bounds__(THREADS)
min_d2_kernel(const float* __restrict__ x, const float* __restrict__ pts,
              float* __restrict__ out, int n, int p) {
  extern __shared__ float4 fp[];  // point j: (-px, -py, -pz, |p|^2); (0, 0, 0, inf) past p
  __shared__ float warp_r2[THREADS / 32];
  const int rounds = (p + GROUPS - 1) / GROUPS;
  const float* src = pts + (long)blockIdx.y * p * 3;
  float r2 = 0.f;  // the largest |p|^2 of the instance
  for (int i = threadIdx.x; i < rounds * GROUPS; i += THREADS) {
    float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
    if (i < p) {
      const float a = src[3 * i], b = src[3 * i + 1], c = src[3 * i + 2];
      v = make_float4(-a, -b, -c, __fmaf_rn(c, c, __fmaf_rn(b, b, __fmul_rn(a, a))));
      r2 = fmaxf(r2, v.w);
    }
    fp[i] = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r2 = fmaxf(r2, __shfl_xor_sync(FULL, r2, o));
  if ((threadIdx.x & 31) == 0) warp_r2[threadIdx.x >> 5] = r2;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) r2 = fmaxf(r2, warp_r2[w]);

  // the thread's queries q0 + q THREADS, zeros past n; read again after the
  // sweep (volatile: not held in registers through it)
  const long row = (long)blockIdx.y * n;
  const int q0 = blockIdx.x * (QUERIES * THREADS) + threadIdx.x;
  auto query = [&](int q, float (&xq)[3]) {
    const int qi = q0 + q * THREADS;
    const volatile float* xv = x + (row + qi) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) xq[c] = qi < n ? xv[c] : 0.f;
  };
  float x2[QUERIES][3];  // 2x, exact
#pragma unroll
  for (int q = 0; q < QUERIES; ++q) {
    query(q, x2[q]);
#pragma unroll
    for (int c = 0; c < 3; ++c) x2[q][c] = __fmul_rn(2.f, x2[q][c]);
  }

  // the sweep: every pair's s, its minimum per group
  float m[QUERIES][GROUPS];
#pragma unroll
  for (int q = 0; q < QUERIES; ++q)
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) m[q][g] = INFINITY;
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const float4 v = fp[r * GROUPS + g];
#pragma unroll
      for (int q = 0; q < QUERIES; ++q)
        m[q][g] = fminf(m[q][g], __fmaf_rn(v.z, x2[q][2], __fmaf_rn(v.y, x2[q][1],
                                                                    __fmaf_rn(v.x, x2[q][0], v.w))));
    }
  }

  // the exact pass over the groups whose minimum is at most the bound
#pragma unroll
  for (int q = 0; q < QUERIES; ++q) {
    float xq[3];
    query(q, xq);
    float s_min = m[q][0];
#pragma unroll
    for (int g = 1; g < GROUPS; ++g) s_min = fminf(s_min, m[q][g]);
    const float sum = __fadd_rn(
        r2, __fmaf_rn(xq[2], xq[2], __fmaf_rn(xq[1], xq[1], __fmul_rn(xq[0], xq[0]))));
    const bool all = !(sum <= 0x1p100f);
    const float bound = __fadd_rn(s_min, __fmaf_rn(0x1p-18f, sum, 0x1p-100f));
    unsigned taken = 0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      if (all || m[q][g] <= bound) taken |= 1u << g;
    float best = INFINITY;
    while (taken) {
      const int g = __ffs(taken) - 1;
      taken &= taken - 1;
      for (int j = g; j < p; j += GROUPS) {
        const float4 v = fp[j];
        best = fminf(best, dist2(-v.x, -v.y, -v.z, xq[0], xq[1], xq[2]));
      }
    }
    const int qi = q0 + q * THREADS;
    if (qi < n) out[row + qi] = best;
  }
}

int launch_min_d2(const float* x, const float* pts, float* out, int inst, int n, int p,
                  cudaStream_t stream) {
  const int smem = (p + GROUPS - 1) / GROUPS * GROUPS * static_cast<int>(sizeof(float4));
  // above 48 KB with warp_r2 (p > 3040) only with the attribute raised
  if (smem + THREADS / 32 * static_cast<int>(sizeof(float)) > 48 * 1024)
    if (int err = static_cast<int>(cudaFuncSetAttribute(
            min_d2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
  dim3 grid((n + QUERIES * THREADS - 1) / (QUERIES * THREADS), inst);
  min_d2_kernel<<<grid, THREADS, smem, stream>>>(x, pts, out, n, p);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int KC>
int launch_knn(const float* x, const float* pts, int* idx, float* d2, int inst, int n, int p,
               int k, cudaStream_t stream) {
  const int smem = 3 * ((p + 3) / 4) * static_cast<int>(sizeof(float4));
  // above 48 KB in all only with the attribute raised
  if (smem + cap_of(KC) * THREADS * static_cast<int>(sizeof(unsigned short)) > 48 * 1024)
    if (int err = static_cast<int>(cudaFuncSetAttribute(
            knn_kernel<L, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
  constexpr int per_block = THREADS / L;  // queries a block
  dim3 grid((n + per_block - 1) / per_block, inst);
  knn_kernel<L, KC><<<grid, THREADS, smem, stream>>>(x, pts, idx, d2, n, p, k);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_knn_k(const float* x, const float* pts, int* idx, float* d2, int inst, int n, int p,
                 int k, cudaStream_t stream) {
  return (long)inst * n < FEW_QUERIES ? launch_knn<4, KC>(x, pts, idx, d2, inst, n, p, k, stream)
                                      : launch_knn<1, KC>(x, pts, idx, d2, inst, n, p, k, stream);
}

}  // namespace

// x [inst, n, 3], pts [inst, p, 3] f32 contiguous; out [inst, n] (inf
// where p = 0); p <= 4096 (p * 16 bytes of shared memory). Returns
// cudaGetLastError() after launch.
extern "C" int min_d2_fwd(const void* x, const void* pts, void* out, int inst,
                          int n, int p, void* stream) {
  return launch_min_d2(static_cast<const float*>(x), static_cast<const float*>(pts),
                       static_cast<float*>(out), inst, n, p, static_cast<cudaStream_t>(stream));
}

// x [inst, n, 3], pts [inst, p, 3] f32 contiguous; idx/d2 [inst, n, k],
// 1 <= k <= 32; p <= 4096 (p * 12 bytes of shared memory). Returns
// cudaGetLastError() after launch, or cudaErrorInvalidValue for another k.
extern "C" int knn_fwd(const void* x, const void* pts, void* idx, void* d2,
                       int inst, int n, int p, int k, void* stream) {
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = k <= 8 ? &launch_knn_k<8> : k <= 16 ? &launch_knn_k<16> : &launch_knn_k<32>;
  return launch(static_cast<const float*>(x), static_cast<const float*>(pts),
                static_cast<int*>(idx), static_cast<float*>(d2), inst, n, p, k,
                static_cast<cudaStream_t>(stream));
}
