// The reg backward's upstream gradients (sm_90a), for the attention
// backward's chain at up to 86 tokens a segment (csrc/attention_bwd_sm90
// .cu): from g, the
// proj-masked gm = bf16(g * proj mask / keep) and geff = bf16(bf16(gm or
// g) * gamma), the cotangent the proj's transpose takes
// (pallas_attention.py:809-822). One elementwise pass in bf16 pairs; the
// proj mask at the global row (row0 + the row within g) and the column.

#pragma once

#include "tile_ops.cuh"

namespace {

// g, geff, gm [n / C, C] (rows row0.. of the call); gm is written when the
// proj dropout is on and gm is given; gamma may be null.
__global__ void geff_kernel(const bf16* __restrict__ g,
                            const float* __restrict__ gamma, Drop pdrop,
                            bf16* __restrict__ geff, bf16* __restrict__ gm,
                            long n, int C, long row0) {
  for (long i = 2 * ((long)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 2L * gridDim.x * blockDim.x) {
    const uint32_t row = (uint32_t)(row0 + i / C);
    const int col = (int)(i % C);
    float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        g + i));
    if (pdrop.on) {
      const __nv_bfloat162 m = __floats2bfloat162_rn(
          pdrop.apply(v.x, row, col), pdrop.apply(v.y, row, col + 1));
      if (gm != nullptr) *reinterpret_cast<__nv_bfloat162*>(gm + i) = m;
      v = __bfloat1622float2(m);
    }
    if (gamma != nullptr) {
      v.x = __fmul_rn(v.x, gamma[col]);
      v.y = __fmul_rn(v.y, gamma[col + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(geff + i) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

// geff_kernel over n elements (rows row0..) on `stream`.
cudaError_t launch_geff(const bf16* g, const float* gamma, Drop pdrop,
                        bf16* geff, bf16* gm, long n, int C, long row0,
                        cudaStream_t stream) {
  const long pairs = n / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256
                                                      : 4096);
  geff_kernel<<<blocks, 256, 0, stream>>>(g, gamma, pdrop, geff, gm, n, C,
                                          row0);
  return cudaGetLastError();
}

}  // namespace
