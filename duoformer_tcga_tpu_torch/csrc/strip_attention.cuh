// One warp's share of block-diagonal attention for the int8 86-token
// kernel (csrc/fused_attention_residual_int8_s86.cu): softmax(q k^T *
// scale) v for one m16 strip of query rows of one head, with the strip's
// scores and probabilities held in registers (FlashAttention-2's layout)
// instead of in shared memory.
//
// The block's shared tile sQKV [RT, ld] holds one segment of S live rows
// from row 0, its q | k | v in columns [0, D), [D, 2D), [2D, 3D) (bf16);
// keys at or past S are masked out, so padding rows (whatever they hold,
// as long as it is finite) contribute nothing. The scores of the strip,
// [16, RT] in float32, are the mma accumulators themselves (RT / 2
// registers a thread); the softmax reduces each row over the 4 lanes of a
// quad; the probabilities, cast to bf16, are packed straight into the A
// fragments of P.V (an m16n8 accumulator pair is an m16k16 A fragment).
// Rounding points are the TPU kernel's: scores in float32 times scale,
// float32 softmax (exp(s - max) / sum), the probabilities cast to bf16,
// P.V accumulated in float32 and the head's output cast to bf16.

#pragma once

#include "tile_ops.cuh"

namespace {

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Strip m (rows 16m .. 16m + 15) of the head in sQKV; the head's output
// [16, D] in bf16 overwrites the strip's own q columns, which no other
// warp reads. The caller synchronises the block before (sQKV complete)
// and after (before sQKV is rewritten).
template <int RT>
__device__ __forceinline__ void strip_attention(bf16* sQKV, int ld, int m,
                                                int S, float scale,
                                                int lane) {
  constexpr int D = 64;
  constexpr int NT = RT / 8;        // n8 tiles of scores
  const int g = lane >> 2, t = lane & 3;
  float c[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = 0.f;
  // ---- scores q k^T (float32) ----
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    unsigned a[4];
    ldsm_a(a, sQKV + m * 16 * ld + k0, ld, lane);
#pragma unroll
    for (int nt = 0; nt < RT / 16; ++nt) {
      unsigned b[4];
      ldsm_bt2(b, sQKV + nt * 16 * ld + D + k0, ld, lane);
      mma16816(c[2 * nt], a, b[0], b[1]);
      mma16816(c[2 * nt + 1], a, b[2], b[3]);
    }
  }
  // ---- softmax over the live keys of rows g (q = 0, 1) and g + 8 ----
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 8 * j + 2 * t + (q & 1);
      c[j][q] = col < S ? c[j][q] * scale : -CUDART_INF_F;
      mx[q >> 1] = fmaxf(mx[q >> 1], c[j][q]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 8 * j + 2 * t + (q & 1);
      c[j][q] = col < S ? expf(c[j][q] - mx[q >> 1]) : 0.f;
      sum[q >> 1] += c[j][q];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  // ---- the probabilities in float32 ----
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j][q] = c[j][q] / sum[q >> 1];
  // ---- P V: probabilities cast to bf16 as A fragments ----
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[n][q] = 0.f;
#pragma unroll
  for (int kb = 0; kb < RT / 16; ++kb) {
    unsigned a[4];
    a[0] = pack_bf16(c[2 * kb][0], c[2 * kb][1]);
    a[1] = pack_bf16(c[2 * kb][2], c[2 * kb][3]);
    a[2] = pack_bf16(c[2 * kb + 1][0], c[2 * kb + 1][1]);
    a[3] = pack_bf16(c[2 * kb + 1][2], c[2 * kb + 1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 16; ++nt) {
      unsigned b[4];
      ldsm_b2(b, sQKV + kb * 16 * ld + 2 * D + nt * 16, ld, lane);
      mma16816(o[2 * nt], a, b[0], b[1]);
      mma16816(o[2 * nt + 1], a, b[2], b[3]);
    }
  }
  // ---- the head's output, cast to bf16, over the strip's q ----
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(
          sQKV + (m * 16 + g + 8 * hr) * ld + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hr], o[n][2 * hr + 1]);
  __syncwarp();
}

// The strip's output (rows 16m.., bf16 [16, D] in sQKV's q columns) into
// out [rows, C] at row row0 + 16m.. and column col0; rows at or past S
// are not written. 16-byte stores, 8 lanes a row.
__device__ __forceinline__ void store_strip(const bf16* sQKV, int ld, int m,
                                            int S, bf16* __restrict__ out,
                                            long row0, int C, int col0,
                                            int lane) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u, r = m * 16 + (i >> 3), seg = i & 7;
    if (r < S)
      *reinterpret_cast<uint4*>(out + (row0 + r) * C + col0 + seg * 8) =
          *reinterpret_cast<const uint4*>(sQKV + r * ld + seg * 8);
  }
}

}  // namespace
