// What csrc/flash_attention.cu and csrc/fused_qkv_attention.cu share: the
// cp.async copies and quad reductions of their tensor-core kernels, and the
// building blocks of their f32 kernels in 3xTF32 (namespace tf).
//
// 3xTF32: TF32 runs at 495 TFLOP/s dense but keeps 10 mantissa bits, so
// every f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away; x - hi is exact) and each product is a_lo
// b_hi + a_hi b_lo + a_hi b_hi on mma.sync.m16n8k8 (tf32 in, f32
// accumulate): ~2**-21 of the f32 product, at 495 / 3 TFLOP/s. A block is 4
// warps, each owning 16 rows (64 a block) that stay raw f32 in shared memory
// (Own) and are split per 8-column slab as they are read, once for all the
// n-tiles of a step (their hi and lo in registers would take 128 registers a
// thread at D 64). The other side streams through a two-stage cp.async ring
// of tiles that land as raw f32 and are split once, in place, by the whole
// block into hi and lo arrays (Split), so that the four warps read split
// values. Its rows are read by ldmatrix.x4 as 8 x 4 blocks of 32-bit values
// (a tf32 B fragment's layout) where they are the B operand's columns, and
// by 32-bit ld.shared where they are the summed dimension: ldmatrix.trans
// moves 16-bit elements and cannot transpose 32-bit ones. There the C
// fragment of the A operand (p or ds) is the next A fragment with its k
// order permuted (A's column u is C's 2u, u + 4 is 2u + 1, so B's rows are
// the tile's 2u and 2u + 1), which needs no shuffle, and is split in
// registers. Rows are padded to D + 4 words, so both access patterns fall in
// 32 distinct banks. All three products of a step go into one fresh f32
// fragment per n-tile that is added to the running sum in f32 (the MMA's
// own sums do not round as f32 adds do). tf32 rounding is (bits + 0x1000) &
// ~0x1fff, the bits cvt.rna.tf32.f32 gives for finite x in two integer
// operations: the PTX conversion compiles to a longer sequence (it tests for
// NaN), and the kernels ran slower with it.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok (src is
// then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n of this thread's copy groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// The max and the sum over the four lanes of a fragment row (lane / 4).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A kernel's dynamic shared memory above the default 48 KB needs the
// function's attribute raised first.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

namespace tf {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;    // threads per block
constexpr int ROWS = 16 * WARPS;  // the block's own rows: 16 per warp

// Rows of the streamed side per shared-memory tile, and the blocks an SM
// should hold: at D 64, 16-row tiles keep a block's shared memory at 52-70
// KB, so three blocks (12 warps) share an SM; at D 128, 32-row tiles (one
// block), where 16-row ones ran slower (ptxas spilled K8b's dK/dV pass).
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 64 ? 16 : 32;
}

template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 3 : 1;
}

// The block's own rows of one head (raw f32), each padded by 4 floats: with
// a row stride of D + 4 (4 mod 32 banks) the fragment reads below fall in
// 32 distinct banks.
template <int D>
struct Own {
  float r[ROWS][D + 4];
};

// A streamed tile split into tf32 hi and lo (their f32 bit patterns), rows
// padded as Own's: cp.async lands the raw f32 rows in hi, split_tile then
// splits them in place, once for the block's four warps.
template <int D>
struct Split {
  unsigned hi[tile_rows<D>()][D + 4];
  unsigned lo[tile_rows<D>()][D + 4];
};

// Rows [r0, r0 + N) of one head (src: its row 0; rows `stride` elements
// apart) into t by cp.async; rows at or past `end` are zero-filled.
template <int D, int N>
__device__ __forceinline__ void load_rows(void* t, const float* src, long stride, int r0,
                                          int end) {
  float(*dst)[D + 4] = reinterpret_cast<float(*)[D + 4]>(t);
#pragma unroll
  for (int it = 0; it < N * D / 4 / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < end;
    cp16(&dst[r][c], src + (ok ? (long)(r0 + r) * stride + c : 0), ok);
  }
}

// The block's own rows times x, in place, by the whole block (a scale
// folded into an operand before it is split).
template <int D>
__device__ __forceinline__ void scale_rows(Own<D>& a, float x) {
#pragma unroll
  for (int it = 0; it < ROWS * D / 4 / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4& v = *reinterpret_cast<float4*>(&a.r[r][c]);
    v = make_float4(v.x * x, v.y * x, v.z * x, v.w * x);
  }
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for finite x (the low 13 bits 0,
// so it is also an f32), in two integer operations (the PTX conversion
// compiles to a longer sequence that also tests for NaN; a NaN or inf
// input makes the output non-finite either way)
__device__ __forceinline__ unsigned tf32(unsigned x) { return (x + 0x1000u) & 0xffffe000u; }

// x as hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in f32): hi + lo
// carries x to within ~2**-22 of itself
__device__ __forceinline__ void split(unsigned x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));
}

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  split(__float_as_uint(x), hi, lo);
}

// The raw rows in t.hi split into hi and lo in place, by the whole block.
template <int D>
__device__ __forceinline__ void split_tile(Split<D>& t) {
#pragma unroll
  for (int it = 0; it < tile_rows<D>() * D / 4 / NT; ++it) {
    const int i = threadIdx.x + it * NT, r = i / (D / 4), c = (i % (D / 4)) * 4;
    const uint4 x = *reinterpret_cast<const uint4*>(&t.hi[r][c]);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(&t.hi[r][c]) = h;
    *reinterpret_cast<uint4*>(&t.lo[r][c]) = l;
  }
}

// Four 8 x 4 blocks of 32-bit values (as ldmatrix's 8 x 8 b16 matrices):
// lane l gives the row address of block l / 8, and receives row l / 4,
// element l % 4 of block i in r[i], which is a tf32 B fragment's layout.
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const unsigned* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

// c += a b: a the 16 x 8 A fragment (row-major), b0/b1 the 8 x 8 B fragment
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a_lo b_hi + a_hi b_lo + a_hi b_hi (the 3xTF32 product; a_lo b_lo is
// below f32 precision)
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// Fragment addressing; lane = threadIdx.x & 31, g = lane / 4, u = lane % 4.
// A (16 x 8): a0 (g, u), a1 (g + 8, u), a2 (g, u + 4), a3 (g + 8, u + 4);
// B (8 x 8): b0 (u, g), b1 (u + 4, g); C (16 x 8): c0 (g, 2u), c1 (g, 2u +
// 1), c2 (g + 8, 2u), c3 (g + 8, 2u + 1).
//
// c[j] = a . t[n0 + 8j, n0 + 8j + 8)^T over the D columns, for the NJ (even)
// n-tiles (the B operand is t's rows: keys or queries; a: the warp's 16
// rows of own, from row a0, split as they are read, each 8-column slab once
// for the NJ n-tiles; banks (4g + u) mod 32). The B fragments of two
// n-tiles' hi (or lo) come from one ldmatrix.x4.
template <int D, int NJ>
__device__ __forceinline__ void rows_product(float (&c)[NJ][4], const Own<D>& a, int a0,
                                             const Split<D>& t, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int d = 8 * kk + u;
    unsigned ah[4], al[4];
    split(a.r[a0 + g][d], ah[0], al[0]);
    split(a.r[a0 + g + 8][d], ah[1], al[1]);
    split(a.r[a0 + g][d + 4], ah[2], al[2]);
    split(a.r[a0 + g + 8][d + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int row = n0 + 8 * (j + (lane >> 4)) + (lane & 7);
      const int col = 8 * kk + 4 * ((lane >> 3) & 1);
      unsigned bh[4], bl[4];
      ldsm(bh, &t.hi[row][col]);
      ldsm(bl, &t.lo[row][col]);
      mma3(c[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(c[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
}

// acc[n] = acc[n] * mul + p . t[k0, k0 + 8 NK)[8n, 8n + 8) for the D / 8
// n-tiles (the B operand is t's columns, summed over its rows; mul per row:
// mul0 for g, mul1 for g + 8, 1 in a plain sum, where acc * 1 + x rounds as
// acc + x). p is NK C fragments (16 x 8 each), taken as the A fragments of
// the NK k-steps with the k order permuted: A's column u is C's column 2u
// and A's column u + 4 is C's 2u + 1, so B's row u is t's row 2u and its
// row u + 4 is t's row 2u + 1 (32-bit ld.shared: ldmatrix cannot transpose
// 32-bit elements; banks (8u + g) and (8u + 4 + g) mod 32). p is split into
// tf32 hi and lo here; the 3 NK products of each n-tile go into one fresh
// f32 fragment, which is then added to acc in f32 (the MMA's own sums do
// not round as f32 adds do).
template <int D, int NK>
__device__ __forceinline__ void split_product(float (&acc)[D / 8][4], const float (&p)[NK][4],
                                              const Split<D>& t, int k0, float mul0 = 1.f,
                                              float mul1 = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, u = lane & 3;
  unsigned ph[NK][4], pl[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    split(p[kk][0], ph[kk][0], pl[kk][0]);
    split(p[kk][2], ph[kk][1], pl[kk][1]);
    split(p[kk][1], ph[kk][2], pl[kk][2]);
    split(p[kk][3], ph[kk][3], pl[kk][3]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float f[4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int r = k0 + 8 * kk + 2 * u, col = 8 * n + g;
      mma3(f, ph[kk], pl[kk], t.hi[r][col], t.hi[r + 1][col], t.lo[r][col], t.lo[r + 1][col]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], e < 2 ? mul0 : mul1, f[e]);
  }
}

// Rows g and g + 8 of a warp's [16, D] f32 accumulator at dst + row *
// stride for the rows below `end` (row0: the warp's first row).
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long stride, const float (&acc)[D / 8][4],
                                           int row0, int end) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + g + 8 * r >= end) continue;
    float2* row = reinterpret_cast<float2*>(dst + (long)(row0 + g + 8 * r) * stride + c);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) row[4 * n] = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

}  // namespace tf

}  // namespace
