// Row LayerNorm for Hopper (sm_90a):
//
//     y = (x - mean) / sqrt(var + eps) * scale + bias   over each row of C
//
// x and y are [rows, C] bf16; scale and bias are float32 [C].
//
// Replaces: duoformer_tcga_tpu/ops/pallas_norm.py, _ln_kernel, driven by
// _impl (fused_layernorm). The JAX package takes it for every nn.layernorm
// outside the fused blocks when DUOFORMER_FUSED_LN=1 and C % 128 == 0:
// in the port the release family's fc_norm and the final norm of the
// legacy family and of the ViTs, one launch per forward, when the model
// is built with fused_ln.
//
// Rounding points are the TPU kernel's: the row read once, mean and the
// two-pass variance in float32, (x - mean) * rsqrt(var + eps), then times
// scale plus bias in float32, and y rounded once to bf16.
//
// Design. One warp per row: each lane reads 8-byte chunks of 4 elements,
// the lanes stepping 128 columns at a time, so every C that is a multiple
// of 128 gives every lane whole chunks (3 a lane at C = 384, where 16-byte
// chunks in 256-column steps left half the lanes idle for the second
// step); it sums them, and the warp reduces with shuffles; the second and
// third passes over the row (the centred squares, then the output) read it
// again from L1. Blocks of 8 warps, one row each, cover the rows. The
// wrapper binds this entry's signature once and calls it without entering
// a device context when the tensor's device is current: at the shapes it
// runs ([128, 768], [6400, 384]) a call is mostly the host's.
//
// What bounds it on this card. 2 bytes in and 2 out per element against
// ~8 float operations: bound by the bytes (0.0173 ms at [18816, 768]).

#include "tile_ops.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void unpack4(const uint2& u, float (&v)[4]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                 const float* __restrict__ lnb, bf16* __restrict__ out,
                 long rows, int C, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  const bf16* xr = x + r * C;
  float v[4];
  float sum = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    unpack4(*reinterpret_cast<const uint2*>(xr + c), v);
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += v[i];
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    unpack4(*reinterpret_cast<const uint2*>(xr + c), v);
#pragma unroll
    for (int i = 0; i < 4; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane * 4; c < C; c += 128) {
    unpack4(*reinterpret_cast<const uint2*>(xr + c), v);
    uint2 o;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      po[i] = __floats2bfloat162_rn(
          (v[2 * i] - mean) * inv * lns[c + 2 * i] + lnb[c + 2 * i],
          (v[2 * i + 1] - mean) * inv * lns[c + 2 * i + 1] +
              lnb[c + 2 * i + 1]);
    *reinterpret_cast<uint2*>(out + r * C + c) = o;
  }
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: rows >= 1, C a positive multiple of 128,
// x and out 8-byte aligned.
int launch_layernorm(const void* x, const void* lns, const void* lnb,
                     void* out, long rows, int C, float eps, void* stream) {
  if (rows < 1 || C <= 0 || C % 128 != 0) return (int)cudaErrorInvalidValue;
  const long blocks = (rows + WARPS - 1) / WARPS;
  layernorm_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)lns, (const float*)lnb, (bf16*)out, rows,
      C, eps);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
