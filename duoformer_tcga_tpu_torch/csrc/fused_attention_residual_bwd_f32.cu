// The attention residual branch's backward in float32 for Hopper (sm_90a),
// without the weight gradients (the dw=False form):
//
//     x, g [n_seg, S, C] -> dx, ln, attn, dqkv and the column sums dlns,
//     dlnb, dbqkv, dbproj
//
// recomputing the forward (csrc/fused_attention_residual_f32.cu). All
// operands and outputs are float32; S <= 64.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_bwd_kernel (dw=False, driven by _fused_block_bwd_impl) at
// dtype float32: the backward of every ScaleBlock (full form, S=6 at 2
// scales, 22 at 3) and PatchBlock (bare, S=50) of a float32 training
// step. In float32 the TPU kernel's casts are no-ops (row tiles halved by
// _f32_shrink); p stays float32 in ds there as here; no rounding point
// below float32.
//
// Design: a chain of launches from csrc/f32_tile.cuh on the caller's
// stream:
//   1. the LayerNorm of x (full form) into the ln output, with each row's
//      mean and 1/std;
//   2. qkv = ln wqkv + bqkv into [rows, 3C] scratch;
//   3. dattn = g wproj^T into [rows, C] scratch;
//   4. the attention core's backward, one block per (segment, head):
//      recomputes p and o (the attn output), dv = p^T do, dp = do v^T,
//      ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q into dqkv;
//   5. dln = dqkv wqkv^T; the full form's LayerNorm backward (dx = LN
//      backward + g, the warp sums of dln * xhat and dln), the bare
//      form's dx = dln [+ g] in the product's epilogue;
//   6. the column sums dbqkv of dqkv and dbproj of g, and dlns, dlnb from
//      the LayerNorm backward's partials, each added in a fixed order.
// The products are float32 FMA (the header says why not TF32).
//
// What bounds it on this card: the four products, 2*rows*C*7C flops at
// the float32 FMA rate; qkv, dattn and dln cross device memory (the TPU
// kernel keeps them in VMEM).

#include "f32_tile.cuh"

namespace {

template <int C>
cudaError_t launch(const float* x, const float* g, const float* lns,
                   const float* lnb, const float* wqkv, const float* bqkv,
                   const float* wproj, float* dx, float* ln, float* attn,
                   float* dqkv, float* sums, float* qkv, float* dattn,
                   float* dln, float* stats, float* part, int n_seg, int S,
                   float scale, float eps, int use_ln, int use_residual,
                   cudaStream_t stream) {
  const int rows = n_seg * S;
  const float* gres = use_residual ? g : nullptr;
  cudaError_t err;
  const float* a = x;
  if (use_ln) {
    err = f32::ln_fwd<C>(x, lns, lnb, eps, ln, stats, rows, stream);
    if (err != cudaSuccess) return err;
    a = ln;
  }
  err = f32::gemm<false>(a, wqkv, rows, 3 * C, C,
                         f32::EpiStore{qkv, bqkv, nullptr, 3 * C}, stream);
  if (err != cudaSuccess) return err;
  err = f32::gemm<true>(g, wproj, rows, C, C,
                        f32::EpiStore{dattn, nullptr, nullptr, C}, stream);
  if (err != cudaSuccess) return err;
  err = f32::attention_core_bwd(qkv, dattn, attn, dqkv, n_seg, S, C, scale,
                                stream);
  if (err != cudaSuccess) return err;
  if (use_ln) {
    err = f32::gemm<true>(dqkv, wqkv, rows, C, 3 * C,
                          f32::EpiStore{dln, nullptr, nullptr, C}, stream);
    if (err != cudaSuccess) return err;
    const int nparts = f32::ln_bwd_parts(rows);
    f32::ln_bwd_kernel<C>
        <<<(nparts + f32::LN_WARPS - 1) / f32::LN_WARPS, f32::LN_WARPS * 32,
           0, stream>>>(dln, x, stats, lns, gres, dx, part, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = f32::sum_parts(part, nparts, 2 * C, sums, stream);   // dlns, dlnb
  } else {
    err = f32::gemm<true>(dqkv, wqkv, rows, C, 3 * C,
                          f32::EpiStore{dx, nullptr, gres, C}, stream);
  }
  if (err != cudaSuccess) return err;
  err = f32::colsum(dqkv, rows, 3 * C, part, sums + 2 * C, stream);
  if (err != cudaSuccess) return err;
  return f32::colsum(g, rows, C, part, sums + 5 * C, stream);
}

}  // namespace

extern "C" {

// Floats of the `part` scratch the launch needs for `rows` rows at C.
long long attention_bwd_f32_part_floats(int rows, int C) {
  const long long a = (long long)f32::ln_bwd_parts(rows) * 2 * C;
  const long long b = (long long)f32::colsum_parts(rows) * 3 * C;
  return a > b ? a : b;
}

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: S in 1..64, C = 64 *
// num_heads with C in {256, 512, 768}, every pointer 32-byte aligned.
// Outputs dx [n_seg, S, C], ln [rows, C] (null for the bare form), attn
// [rows, C], dqkv [rows, 3C], sums [6C] (dlns | dlnb | dbqkv | dbproj;
// the bare form's dlns and dlnb left as the caller's zeros); scratch qkv
// [rows, 3C], dattn [rows, C], dln [rows, C] and stats [rows, 2] (null
// for the bare form) and part (attention_bwd_f32_part_floats), float32.
int launch_fused_attention_residual_bwd_f32(
    const void* x, const void* g, const void* lns, const void* lnb,
    const void* wqkv, const void* bqkv, const void* wproj, void* dx,
    void* ln, void* attn, void* dqkv, void* sums, void* qkv, void* dattn,
    void* dln, void* stats, void* part, int n_seg, int S, int C,
    int num_heads, float scale, float eps, int use_ln, int use_residual,
    void* stream) {
  if (S < 1 || S > 64 || C != num_heads * 64) return (int)cudaErrorInvalidValue;
#define ARGS                                                                  \
  (const float*)x, (const float*)g, (const float*)lns, (const float*)lnb,     \
      (const float*)wqkv, (const float*)bqkv, (const float*)wproj,            \
      (float*)dx, (float*)ln, (float*)attn, (float*)dqkv, (float*)sums,       \
      (float*)qkv, (float*)dattn, (float*)dln, (float*)stats, (float*)part,   \
      n_seg, S, scale, eps, use_ln, use_residual, (cudaStream_t)stream
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
