// Device helpers shared by the port's fused kernels (sm_90a): warp
// reductions, cp.async, ldmatrix fragment loads, the m16n8k16 bf16 and
// m16n8k32 int8 mma, the LayerNorm row prologues (bf16, and quantized for
// the int8 kernels) and the int8 kernels' dequantizing epilogue.
//
// mma.sync m16n8k16 fragment layout (lane = 4 * g + t): the accumulator
// holds rows g and g + 8, columns 2t and 2t + 1 of its 16x8 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dropout_hash.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A fragment of a 16x16 tile of a row-major [*, ld] bf16 matrix at p.
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4], const bf16* p,
                                       int ld, int lane) {
  const bf16* q = p + (lane & 15) * ld + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(q)));
}

// B fragments of two n8 tiles (k16 x n16) of a row-major [K, ld] matrix at
// p: b[0..1] for columns 0-7, b[2..3] for columns 8-15.
__device__ __forceinline__ void ldsm_b2(unsigned (&b)[4], const bf16* p,
                                        int ld, int lane) {
  const bf16* q = p + (lane & 15) * ld + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(q)));
}

// B fragments of two n8 tiles of B = M^T for a row-major [N, ld] matrix M
// at p (n16 rows of M, k16 columns): b[0..1] for rows 0-7, b[2..3] 8-15.
__device__ __forceinline__ void ldsm_bt2(unsigned (&b)[4], const bf16* p,
                                         int ld, int lane) {
  const bf16* q = p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                  ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(q)));
}

// A fragment of a 16x16 tile of A = M^T for a row-major [K, ld] matrix M
// at p (k16 rows of M, m16 columns).
__device__ __forceinline__ void ldsm_at(unsigned (&a)[4], const bf16* p,
                                        int ld, int lane) {
  const bf16* q = p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                  ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(q)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- int8 operands of mma.sync m16n8k32 (s8 x s8 -> s32) ----
// The A fragment of a 16x32 int8 tile has the byte layout of a 16x16 bf16
// tile's, and the B fragment of an n8 x k32 tile of a K-contiguous [N, K]
// int8 matrix that of a bf16 B = M^T fragment, so the b16 ldmatrix loads
// both (sm_90a has no 8-bit transposing ldmatrix: B must be K-major). ld
// is in bytes, a multiple of 16.

// A fragment of a 16x32 tile of a row-major [*, ld] int8 matrix at p.
__device__ __forceinline__ void ldsm_a8(unsigned (&a)[4], const int8_t* p,
                                        int ld, int lane) {
  const int8_t* q = p + (lane & 15) * ld + (lane >> 4) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(q)));
}

// B fragments of two n8 tiles (k32) of a K-contiguous [N, ld] int8 matrix
// at p (n16 rows, 32 bytes of K): b[0..1] for rows 0-7, b[2..3] for 8-15.
__device__ __forceinline__ void ldsm_b8x2(unsigned (&b)[4], const int8_t* p,
                                          int ld, int lane) {
  const int8_t* q = p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                    ((lane >> 3) & 1) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(q)));
}

// B fragment of one n8 tile (k32) of a K-contiguous [N, ld] int8 matrix.
__device__ __forceinline__ void ldsm_b8x1(unsigned (&b)[2], const int8_t* p,
                                          int ld, int lane) {
  const int8_t* q = p + (lane & 7) * ld + ((lane >> 3) & 1) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(q)));
}

// d += a . b over k32, exact in int32; d's layout is the float one above.
__device__ __forceinline__ void mma16832(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-row symmetric int8 (the TPU kernels' _rowquant): scale = amax / 127
// (1 for a zero row); q = clip(round(v / scale), +-127) with IEEE division
// and roundf, which rounds ties away from zero as jax.lax.round does.
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? amax / 127.f : 1.f;
}
__device__ __forceinline__ signed char quant8(float v, float scale) {
  return (signed char)fminf(fmaxf(roundf(v / scale), -127.f), 127.f);
}

// (float)acc * row scale * column scale + bias, in this order and without
// contraction into fma: the TPU kernels' dequantization.
__device__ __forceinline__ float dequant(int acc, float rs, float cs,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, rs), cs), b);
}

// Rows [0, RT) of the block into dst (int8, row stride ld bytes),
// quantized per row from float32: LayerNorm with float32 statistics
// (two-pass variance) when use_ln, else x itself. scales[r] receives each
// row's scale. Rows at or past R (the ragged tail) are zeros of scale 1.
// One warp per row.
template <int C, int RT, int WARPS>
__device__ __forceinline__ void lnq_rows(const bf16* __restrict__ x,
                                         long row0, int R,
                                         const float* __restrict__ lns,
                                         const float* __restrict__ lnb,
                                         float eps, bool use_ln,
                                         int8_t* dst0, int ld,
                                         float* scales) {
  constexpr int NT = C / 64;       // pairs per lane in a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RT; r += WARPS) {
    int8_t* dst = dst0 + r * ld;
    if (r >= R) {
      for (int c = lane * 4; c < C; c += 128)
        *reinterpret_cast<int*>(dst + c) = 0;
      if (lane == 0) scales[r] = 1.f;
      continue;
    }
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(x + (row0 + r) * C);
    float2 v[NT];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      v[i] = __bfloat1622float2(src[lane + 32 * i]);
      sum += v[i].x + v[i].y;
    }
    if (use_ln) {
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float a = v[i].x - mean, b = v[i].y - mean;
        sq += a * a + b * b;
      }
      const float inv = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = 2 * (lane + 32 * i);
        v[i].x = __fadd_rn(__fmul_rn(__fmul_rn(v[i].x - mean, inv), lns[c]),
                           lnb[c]);
        v[i].y = __fadd_rn(
            __fmul_rn(__fmul_rn(v[i].y - mean, inv), lns[c + 1]), lnb[c + 1]);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      amax = fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));
    const float s = row_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<char2*>(dst + 2 * (lane + 32 * i)) =
          make_char2(quant8(v[i].x, s), quant8(v[i].y, s));
    if (lane == 0) scales[r] = s;
  }
}

// out[row0 + row, col0 + col] = dequant(acc, row scale, column scale,
// bias) [+ x], cast once to bf16, for the warp's MT x NJ int32 tiles
// (rows 16m.., columns col0 + 8n..); rows at or past R are not written.
template <int C, int MT, int NJ>
__device__ __forceinline__ void store_rows_dq(
    const int (&acc)[MT][NJ][4], int col0, const float* rs,
    const float* __restrict__ cs, const float* __restrict__ bias,
    const bf16* __restrict__ x, bf16* __restrict__ out, long row0, int R,
    int use_residual) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int col = col0 + n * 8 + 2 * t;
      const float cs0 = cs[col], cs1 = cs[col + 1];
      const float bb0 = bias[col], bb1 = bias[col + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + g + 8 * hr;
        if (row >= R) continue;
        float y0 = dequant(acc[m][n][2 * hr], rs[row], cs0, bb0);
        float y1 = dequant(acc[m][n][2 * hr + 1], rs[row], cs1, bb1);
        const long off = (row0 + row) * C + col;
        if (use_residual) {
          const float2 r2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off));
          y0 += r2.x;
          y1 += r2.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

// Rows [0, RT) of the block into dst (row stride ld) as bf16: LayerNorm
// with float32 statistics (two-pass variance) when use_ln, else a copy of
// x. Rows at or past R (the ragged tail) are zeros. One warp per row.
template <int C, int RT, int WARPS>
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x, long row0,
                                        int R, const float* __restrict__ lns,
                                        const float* __restrict__ lnb,
                                        float eps, bool use_ln, bf16* dst0,
                                        int ld) {
  constexpr int NT = C / 64;       // bf16 pairs per lane in a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RT; r += WARPS) {
    bf16* dst = dst0 + r * ld;
    if (r >= R) {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(x + (row0 + r) * C);
    float2 v[NT];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      v[i] = __bfloat1622float2(src[lane + 32 * i]);
      sum += v[i].x + v[i].y;
    }
    if (use_ln) {
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float a = v[i].x - mean, b = v[i].y - mean;
        sq += a * a + b * b;
      }
      const float inv = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = 2 * (lane + 32 * i);
        v[i].x = (v[i].x - mean) * inv * lns[c] + lnb[c];
        v[i].y = (v[i].y - mean) * inv * lns[c + 1] + lnb[c + 1];
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i)
      reinterpret_cast<__nv_bfloat162*>(dst)[lane + 32 * i] =
          __floats2bfloat162_rn(v[i].x, v[i].y);
  }
}

}  // namespace
