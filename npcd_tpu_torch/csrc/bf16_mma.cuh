// The building blocks of the bf16 tensor-core kernels of
// csrc/fused_mlp_posenc.cu (namespace tc): mma.sync.m16n8k16 with bf16
// operands and f32 accumulation (each product of two bf16 values exact, the
// sums in f32), its operands read from shared memory by ldmatrix. A product
// X . W reads both sides in the layout they have: an operand stored with its
// contracted dimension contiguous (X's rows, or W^T's) by ldmatrix, one
// stored the other way (W [k_in][256] as the params hold it, the activations
// of a dW product X^T G) by ldmatrix.trans, which transposes 16-bit elements
// as it loads them. Rows are padded so that the eight 16-byte rows of an 8 x
// 8 matrix fall in distinct banks (a row stride of 16 mod 128 bytes). The
// cp.async helpers are tf32_mma.cuh's.

#pragma once

#include <cuda_bf16.h>

#include "tf32_mma.cuh"

namespace {
namespace tc {

typedef __nv_bfloat16 bf16;

// Four 8 x 8 matrices of 16-bit elements: lane l gives the address of row l
// % 8 of matrix l / 8 and receives in r[i] row l / 4, elements 2 (l % 4) and
// 2 (l % 4) + 1 of matrix i.
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

// As ldsm, transposed: r[i] holds column l / 4, rows 2 (l % 4) and 2 (l % 4)
// + 1 of matrix i.
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem(p)));
}

// Two matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem(p)));
}

// c += a b: a the 16 x 16 A fragment (row-major), b0/b1 the 16 x 8 B
// fragment; exact bf16 products, f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The low (first column's) and high halves of a bf16x2 as f32.
__device__ __forceinline__ float lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// Fragment addressing; lane = threadIdx.x & 31, g = lane / 4, u = lane % 4.
// A (16 x 16): a[0] (g, 2u..2u+1), a[1] (g + 8, 2u..), a[2] (g, 2u + 8..),
// a[3] (g + 8, 2u + 8..); B (16 x 8): b0 (2u..2u+1, g), b1 (2u + 8.., g); C
// (16 x 8): c0, c1 (g, 2u and 2u + 1), c2, c3 (g + 8, ...). ld: the row
// stride of the array in shared memory, in elements.
//
// The A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of t [M][K].
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* t, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm(a, t + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// The A fragment of A = t^T (t [K][M]): A's rows [m0, m0 + 16) are t's
// columns, its k [k0, k0 + 16) t's rows.
__device__ __forceinline__ void frag_at(unsigned (&a)[4], const bf16* t, int ld, int k0,
                                        int m0) {
  const int lane = threadIdx.x & 31;
  ldsm_t(a, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8);
}

// The B fragments of n-tiles [n0, n0 + 8) (b[0], b[1]) and [n0 + 8, n0 + 16)
// (b[2], b[3]) at k [k0, k0 + 16) of B = t (t [K][N]).
__device__ __forceinline__ void frag_b(unsigned (&b)[4], const bf16* t, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_t(b, t + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// As frag_b for B = t^T (t [N][K]).
__device__ __forceinline__ void frag_bt(unsigned (&b)[4], const bf16* t, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  ldsm(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

}  // namespace tc
}  // namespace
