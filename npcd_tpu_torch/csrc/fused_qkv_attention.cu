// Fused-qkv attention, forward, f32, for Hopper (sm_90a).
//
// Replaces npcd_tpu/ops/pallas/fused_qkv_attention.py:fused_qkv_attention_2d
// (_fwd_impl -> _fwd_kernel): softmax(Q K^T / sqrt(D)) V per head, read in
// place from the fused qkv projection [B*S, 3W] in the grouped [Q|K|V]
// column order (G head groups; head h of group g = h / (H/G) has its Q
// columns at g*3*Wg + (h mod H/G)*D, K at +Wg, V at +2*Wg, Wg = W/G).
// Keys at positions >= valid_len are masked; the output is [B*S, W]
// head-major. Query rows in [valid_len, S) are computed like any other row
// and discarded by the caller. The log-sum-exp the TPU kernel also writes
// feeds only its backward and is not produced here.
//
// What bounds it on the H100: at the denoiser's shapes (S 520, D 64, f32)
// the work is 4*S*S*D flops per (sequence, head), about 1.1 GFLOP per call
// at batch 2, against 2*S*3W*4 bytes of qkv read once: it is compute-bound,
// on the f32 FMA pipes (no tensor cores in the exact-f32 flavour).
// One (sequence, head)'s K and V in f32 are 2*520*64*4 = 266 KB, above the
// 227 KB of shared memory a block can hold, so the design streams key tiles
// with an online softmax (running max and sum) instead of staging the
// sequence: one block per (sequence, head, 64-query tile), two threads per
// query that split the 64 head dims in interleaved float4 chunks (the pair
// reads 32 contiguous bytes of shared memory per load) and combine their
// partial dot products with one shuffle per key. K/V tiles of 32 keys are
// loaded as float4s by all threads. The scores of a tile's 32 keys are
// accumulated side by side, so the FMAs form 32 independent chains rather
// than one serial chain per key. Scores are kept in base 2 (log2(e) folded
// into the query scale), as in the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;            // head dim
constexpr int QT = 64;           // queries per block
constexpr int KT = 32;           // keys per shared-memory tile
constexpr int CH = D / 8;        // float4 chunks per thread: half h owns chunks 2c + h
constexpr int THREADS = 2 * QT;

__global__ void __launch_bounds__(THREADS)
fqa_fwd(const float* __restrict__ qkv, float* __restrict__ out, int seq,
        int heads, int groups, int valid_len, float scale_log2) {
  __shared__ __align__(16) float ks[KT][D];
  __shared__ __align__(16) float vs[KT][D];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int qi = blockIdx.x * QT + (tid >> 1);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = heads * D;
  const int wg = w / groups;
  const int hg = heads / groups;
  const int col = (h / hg) * 3 * wg + (h % hg) * D;
  const long row_stride = 3L * w;
  const float* base = qkv + (long)b * seq * row_stride;

  const bool q_ok = qi < seq;
  const float4* qrow = reinterpret_cast<const float4*>(
      base + (long)(q_ok ? qi : 0) * row_stride + col);
  float4 q[CH], o[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float4 t = qrow[2 * c + half];
    q[c] = make_float4(t.x * scale_log2, t.y * scale_log2, t.z * scale_log2, t.w * scale_log2);
    o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(&ks[0][0]);
  const float4* v4 = reinterpret_cast<const float4*>(&vs[0][0]);

  for (int k0 = 0; k0 < valid_len; k0 += KT) {
    const int nk = min(KT, valid_len - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < KT * D / 4; idx += THREADS) {
      const int j = idx / (D / 4), c4 = idx % (D / 4);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < nk) {
        const float* r = base + (long)(k0 + j) * row_stride + col;
        kv = reinterpret_cast<const float4*>(r + wg)[c4];
        vv = reinterpret_cast<const float4*>(r + 2 * wg)[c4];
      }
      reinterpret_cast<float4*>(&ks[j][0])[c4] = kv;
      reinterpret_cast<float4*>(&vs[j][0])[c4] = vv;
    }
    __syncthreads();

    float s[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float4 qc = q[c];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 kk = k4[j * (D / 4) + 2 * c + half];
        s[j] = fmaf(qc.x, kk.x, s[j]);
        s[j] = fmaf(qc.y, kk.y, s[j]);
        s[j] = fmaf(qc.z, kk.z, s[j]);
        s[j] = fmaf(qc.w, kk.w, s[j]);
      }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float sj = s[j] + __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] = j < nk ? sj : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = exp2f(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      o[c].x *= alpha; o[c].y *= alpha; o[c].z *= alpha; o[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = exp2f(s[j] - m_new);  // masked keys give exp2(-inf) = 0
      l += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = v4[j * (D / 4) + 2 * c + half];
        o[c].x = fmaf(p, vv.x, o[c].x);
        o[c].y = fmaf(p, vv.y, o[c].y);
        o[c].z = fmaf(p, vv.z, o[c].z);
        o[c].w = fmaf(p, vv.w, o[c].w);
      }
    }
    m = m_new;
  }

  if (q_ok) {
    const float inv = 1.f / l;
    float4* orow = reinterpret_cast<float4*>(out + ((long)b * seq + qi) * w + h * D);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      orow[2 * c + half] = make_float4(o[c].x * inv, o[c].y * inv, o[c].z * inv, o[c].w * inv);
  }
}

}  // namespace

// qkv [batch*seq, 3*heads*64] f32, out [batch*seq, heads*64] f32, both
// contiguous and 16-byte aligned. Returns cudaGetLastError() after launch.
extern "C" int fused_qkv_attention_fwd(const void* qkv, void* out, int batch,
                                       int seq, int heads, int groups,
                                       int valid_len, float scale_log2,
                                       void* stream) {
  dim3 grid((seq + QT - 1) / QT, heads, batch);
  fqa_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), seq, heads,
      groups, valid_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
