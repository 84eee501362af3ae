// The MLP residual branch in float32 for Hopper (sm_90a):
//
//     y = [x +] fc2( gelu_erf( fc1( LN(x) ) ) )      (and z = fc1(LN x))
//
// x is [rows, C] float32; w1 [C, H] and w2 [H, C] float32 in (in, out)
// layout; the LayerNorm scale/bias and both biases float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_mlp_kernel
// (serving) and _fused_mlp_kernel_z (the training forward, which also
// writes the pre-GELU hidden z for the backward), driven by
// _fused_mlp_impl, at dtype float32: every ScaleBlock of the release
// model built with dtype float32. In float32 the TPU kernels' casts are
// no-ops (row tiles halved by _f32_shrink), and so is this chain's: no
// rounding point below float32.
//
// Design: a chain of launches from csrc/f32_tile.cuh on the caller's
// stream: the LayerNorm into ln [rows, C]; z = ln w1 + b1 with the exact
// GELU in the product's epilogue, h = gelu(z) into [rows, H] scratch (and
// z into the z form's output); y = h w2 + b2 [+ x]. The products are
// float32 FMA (the header says why not TF32).
//
// What bounds it on this card: 4*rows*C*H flops at the float32 FMA rate;
// h crosses device memory twice (8*rows*H bytes, the TPU kernel keeps it
// in VMEM). Streaming h through shared memory a hidden chunk at a time,
// as the bf16 kernel does, is the next step.

#include "f32_tile.cuh"

namespace {

template <int C>
cudaError_t launch(const float* x, const float* lns, const float* lnb,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, float* zout, float* ln,
                   float* h, int rows, int hidden, float eps,
                   int use_residual, cudaStream_t stream) {
  cudaError_t err =
      f32::ln_fwd<C>(x, lns, lnb, eps, ln, nullptr, rows, stream);
  if (err != cudaSuccess) return err;
  err = f32::gemm<false>(ln, w1, rows, hidden, C,
                         f32::EpiGelu{h, zout, b1, hidden}, stream);
  if (err != cudaSuccess) return err;
  return f32::gemm<false>(
      h, w2, rows, C, hidden,
      f32::EpiStore{out, b2, use_residual ? x : nullptr, C}, stream);
}

}  // namespace

extern "C" {

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: C in {256, 512, 768},
// hidden a multiple of 128, every pointer 32-byte aligned; zout [rows,
// hidden] or null (the serving form); scratch ln [rows, C] and h [rows,
// hidden], float32.
int launch_fused_mlp_residual_f32(const void* x, const void* lns,
                                  const void* lnb, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* zout,
                                  void* ln, void* h, int rows, int C,
                                  int hidden, float eps, int use_residual,
                                  void* stream) {
  if (hidden % 128 != 0) return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const float*)x, (const float*)lns, (const float*)lnb, (const float*)w1, \
      (const float*)b1, (const float*)w2, (const float*)b2, (float*)out,   \
      (float*)zout, (float*)ln, (float*)h, rows, hidden, eps, use_residual, \
      (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch<256>(ARGS);
    case 512: return (int)launch<512>(ARGS);
    case 768: return (int)launch<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
