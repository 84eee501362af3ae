// Elementwise dropout passes of the reg MLP backward for Hopper (sm_90a).
//
// Over a [rows, cols] bf16 tensor src (rows the global flat rows of the
// forward, so each element's mask is the forward's), in float32, one bf16
// result per element:
//     hd:  out = drop(gelu(z))             z the saved pre-dropout fc1
//                                          output: the dW2 operand
//     dz:  out = drop(dh) * gelu'(z)       dh float32 [rows, cols], the
//                                          cotangent of the dropped hidden
//     gm:  out = drop(g)                   the output-dropout-masked
//                                          upstream gradient
// with drop(v) = v * float32(1 / (1 - rate)) where the keep mask of
// (seed, site, row, col) is set, else 0 (csrc/dropout_hash.cuh, the hash
// the forward kernels use). GELU is the exact one, with erff.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _drop_ew_kernel
// (:1949), driven by _drop_ew (:1985). The reg MLP backward
// (_fmr_reg_bwd, :2079-2090) runs it three times per block when the MLP
// dropout is on: gm (site 3) over [rows, C], hd and dz (site 2) over
// [rows, 4C]; dh arrives in float32, as the TPU package passes it.
//
// Design. Elementwise, 8 elements (16 bytes of bf16) per thread and grid
// step, in a grid-stride loop of at most 8 blocks per SM's worth; cols is
// a multiple of 8, so the 8 share a row. What bounds it on this card: the
// bytes (2 per element in and out, 4 more for dh); the hash costs ~20
// integer operations per element, far under the memory time at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MODE_HD = 0, MODE_DZ = 1, MODE_GM = 2;
constexpr int THREADS = 256;
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

__global__ void __launch_bounds__(THREADS)
drop_ew_kernel(const bf16* __restrict__ src, const float* __restrict__ dh,
               bf16* __restrict__ out, long n, int cols, int mode,
               Drop drop) {
  const long stride = (long)gridDim.x * THREADS * 8;
  for (long i = ((long)blockIdx.x * THREADS + threadIdx.x) * 8; i < n;
       i += stride) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + i);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    float d[8];
    if (mode == MODE_DZ) {
      const float4 a = *reinterpret_cast<const float4*>(dh + i);
      const float4 b = *reinterpret_cast<const float4*>(dh + i + 4);
      d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
      d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
    }
    const uint32_t row = (uint32_t)(i / cols);
    const uint32_t col0 = (uint32_t)(i % cols);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float z = __bfloat162float(v[e]);
      const bool keep = keep_mask(drop.seed_plus, row, col0 + e, drop.thr);
      float r;
      if (mode == MODE_GM) {
        r = keep ? z * drop.scale : 0.f;
      } else {
        const float phi = 0.5f * (1.f + erff(z * SQRT1_2));
        if (mode == MODE_HD) {
          r = keep ? (z * phi) * drop.scale : 0.f;
        } else {
          const float dd = keep ? d[e] * drop.scale : 0.f;
          r = dd * (phi + z * (INV_SQRT_2PI * expf(-0.5f * z * z)));
        }
      }
      o[e] = __float2bfloat16(r);
    }
    *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(o);
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: src and out bf16 [rows, cols], dh float32
// [rows, cols] for mode 1 (dz) and null otherwise, cols a multiple of 8,
// every pointer 16-byte aligned. mode: 0 hd, 1 dz, 2 gm. seed and site make
// the mask's seed (site 2 for hd and dz, 3 for gm); thr and scale are the
// keep threshold and keep scale.
int launch_drop_ew(const void* src, const void* dh, void* out, int rows,
                   int cols, int mode, int seed, int site, int thr,
                   float scale, void* stream) {
  if (cols <= 0 || cols % 8 != 0 || mode < 0 || mode > 2 || thr < 0)
    return (int)cudaErrorInvalidValue;
  const long n = (long)rows * cols;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long want = (n / 8 + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 8L * sms ? want : 8L * sms);
  drop_ew_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)src, (const float*)dh, (bf16*)out, n, cols, mode,
      make_drop(seed, (uint32_t)site, thr, scale));
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
