// The attention residual branch in float32 for Hopper (sm_90a):
//
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) )
//
// x is [n_seg, S, C] float32, S <= 64; each segment of S tokens attends
// only within itself. Weights are float32 in (in, out) layout: wqkv
// [C, 3C] (columns q | k | v, head h at h*64), wproj [C, C]; the
// LayerNorm scale/bias and both biases float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_block_kernel
// (driven by _fused_block_impl) at dtype float32, inert: the full form
// (LN + residual) in every ScaleBlock of the release model built with
// dtype float32 (S=6 at 2 scales, 22 at 3), the bare form (use_ln =
// use_residual = 0) in every PatchBlock (S=50). In float32 each of the
// TPU kernel's casts to x's dtype is a no-op, so it computes in float32
// throughout, with row tiles halved by _f32_shrink; so does this chain,
// with no rounding point below float32.
//
// Design: a chain of launches from csrc/f32_tile.cuh on the caller's
// stream, into float32 scratch the wrapper allocates:
//   1. the LayerNorm of x (full form) into ln [rows, C];
//   2. qkv = ln wqkv + bqkv [rows, 3C] (the tiled FMA product);
//   3. the attention core, one block per (segment, head): q k^T * scale,
//      the softmax, P V into o [rows, C];
//   4. y = o wproj + bproj [+ x] (the product, bias and residual in its
//      epilogue).
// The products are float32 FMA, not TF32 tensor-core products (see the
// header): single-pass TF32 would miss the float32 bars by ~30x.
//
// What bounds it on this card: the two products, 2*rows*C*4C flops at
// the FMA rate (67 TFLOP/s; 3xTF32 would reach at most 165 TFLOP/s of
// float32-accurate work); the chain moves ln, qkv and o through device
// memory (the TPU kernel keeps them in VMEM), ~24 bytes a row and column
// more than the 8 the function must move. Keeping them on chip (one
// block per row tile through all four steps, as the bf16 kernel does)
// is the next step once the form is right.

#include "f32_tile.cuh"

namespace {

template <int C>
cudaError_t launch(const float* x, const float* lns, const float* lnb,
                   const float* wqkv, const float* bqkv, const float* wproj,
                   const float* bproj, float* out, float* ln, float* qkv,
                   float* o, int n_seg, int S, float scale, float eps,
                   int use_ln, int use_residual, cudaStream_t stream) {
  const int rows = n_seg * S;
  cudaError_t err;
  const float* a = x;
  if (use_ln) {
    err = f32::ln_fwd<C>(x, lns, lnb, eps, ln, nullptr, rows, stream);
    if (err != cudaSuccess) return err;
    a = ln;
  }
  err = f32::gemm<false>(a, wqkv, rows, 3 * C, C,
                         f32::EpiStore{qkv, bqkv, nullptr, 3 * C}, stream);
  if (err != cudaSuccess) return err;
  err = f32::attention_core(qkv, o, n_seg, S, C, scale, stream);
  if (err != cudaSuccess) return err;
  return f32::gemm<false>(
      o, wproj, rows, C, C,
      f32::EpiStore{out, bproj, use_residual ? x : nullptr, C}, stream);
}

}  // namespace

extern "C" {

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: S in 1..64, C = 64 *
// num_heads with C in {256, 512, 768}, every pointer 32-byte aligned;
// scratch ln [rows, C] (null for the bare form), qkv [rows, 3C] and o
// [rows, C], float32.
int launch_fused_attention_residual_f32(
    const void* x, const void* lns, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, void* out,
    void* ln, void* qkv, void* o, int n_seg, int S, int C, int num_heads,
    float scale, float eps, int use_ln, int use_residual, void* stream) {
  if (S < 1 || S > 64 || C != num_heads * 64) return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const float*)x, (const float*)lns, (const float*)lnb, (const float*)wqkv, \
      (const float*)bqkv, (const float*)wproj, (const float*)bproj,          \
      (float*)out, (float*)ln, (float*)qkv, (float*)o, n_seg, S, scale, eps, \
      use_ln, use_residual, (cudaStream_t)stream
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
