// Fused MLP residual branch for Hopper (sm_90a):
//
//     y = [x +] fc2( gelu_erf( fc1( LN(x) ) ) )
//
// x is [rows, C] in bf16; w1 [C, H] and w2 [H, C] are bf16 in (in, out)
// layout (H = 4C in the model); LayerNorm scale/bias, b1 and b2 are
// float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py:1306
// _fused_mlp_kernel (the serving form) and :1350 _fused_mlp_kernel_z (the
// same forward that also writes the pre-GELU hidden z [rows, H] in bf16 for
// the save-hidden backward), both driven by _fused_mlp_impl (:1398). The
// serving form runs once in every ScaleBlock of the serving path, the z form
// once in every ScaleBlock of a training step. The reg instantiations
// (fused_mlp_residual_reg, pallas_attention.py:1940; kernel semantics
// :1330-1347, :1379-1395) are runtime arguments of the same kernels:
// dropout of the post-GELU hidden (site 2) before its bf16 cast, dropout of
// fc2 + b2 (site 3), then a LayerScale gamma, then the residual, every mask
// at the global flat row (csrc/dropout_hash.cuh); the z form saves z before
// any dropout.
//
// Rounding points are the TPU kernel's: LN in float32 with its output cast
// to bf16 (:1319-1325); fc1 + b1, the exact GELU and the hidden dropout in
// float32, the post-GELU hidden cast to bf16 (the TPU kernel keeps it in a
// bf16 VMEM scratch, hid_scratch, :1334); fc2 + b2, the output dropout,
// gamma and the residual in float32, cast once. GELU's erf is the TPU
// kernel's Abramowitz-Stegun polynomial (max abs error 1.5e-7; the plain
// version uses torch.erf): both agree far inside the bf16 rounding of the
// hidden.
//
// Design. The fusion is split at the bf16 hidden, where the TPU kernel
// rounds anyway: a fused fc1 -> GELU -> fc2 has to hold a float32 [rows, C]
// fc2 accumulator in registers (393 KB for 128 rows at C = 768, against an
// SM's 256 KB), which forces small row tiles and a re-read of all of w1 and
// w2 per tile. So one wrapper call runs, for each chunk of rows, three
// launches:
//   1. ln_kernel: LayerNorm of the chunk's rows into a bf16 scratch
//      [rows, C] (tile_ops.cuh's ln_rows, one warp per row);
//   2. gemm_sm90<EPI_GELU> (fc1): h = drop(gelu(ln w1 + b1)) into a bf16
//      scratch [rows, H]; the z form also stores z = ln w1 + b1;
//   3. gemm_sm90<EPI_OUT> (fc2): out = [x +] gamma * drop(h w2 + b2).
// The wrapper takes the rows in chunks so that the two scratches together
// stay within ops/fused_attention.MLP_SCRATCH_BYTES (192 MiB: one chunk up
// to 26,112 rows at C = 768); each chunk passes its first global row, from
// which every mask counts. A call makes 3 CUDA launches per chunk.
//
// The two products are csrc/gemm_sm90.cuh's persistent TMA-fed wgmma
// kernel (shared with the attention branch's qkv and proj products), with
// its EPI_GELU and EPI_OUT epilogues: 128 x 128 output tiles, a producer
// warpgroup keeping a 5-stage ring of TMA loads full, two pairs of
// consumer warpgroups running wgmma m64n128k16 on alternate tiles, and the
// epilogue TMA-storing its bf16 tile.
//
// What bounds it on this card: 4 rows C H flops (177.6 GFLOP at 18,816
// rows and C = 768, 0.18 ms at the bf16 peak); the bf16 hidden's round trip
// (2 rows H 2 bytes) and the LN scratch are the price of the split. Every
// row tile reads its weight slabs from L2 again (no cluster multicast yet).
// The old design (one block of 8 warps per 48 rows, mma.sync on cp.async
// weight slabs, the hidden in shared memory) took 1.157 ms at 18,816 rows
// and 2.313 ms in the z form at 37,632 (PERF.md §6).

#include "gemm_sm90.cuh"

extern "C" {

// Arguments are checked by the Python wrapper: C in {256, 384, 512, 768},
// hidden a positive multiple of 128, every pointer 32-byte aligned. Each
// entry returns its first failing launch's error (0 on success). A chunk
// of rows is one call of each, in this order: ln is read by the products.

// LayerNorm of a chunk's rows of x into ln, bf16 [rows rounded up to 128,
// C].
int launch_mlp_layernorm(const void* x, const void* lns, const void* lnb,
                         void* ln, int rows, int C, float eps, void* stream) {
  return (int)run_layernorm((const bf16*)x, (const float*)lns,
                            (const float*)lnb, (bf16*)ln, rows, C, eps,
                            (cudaStream_t)stream);
}

// fc1 then fc2 of a chunk: rows of x, out (and z) from the chunk's first
// row, row0 that row's global index (the mask counters). ln from
// launch_mlp_layernorm; h: bf16 scratch [rows, hidden]. z: null (the
// serving form), or [rows, hidden] bf16 for the pre-GELU hidden (the z
// form). The reg form: gamma float32 [C] or null; seed the int32 dropout
// seed; drop_thr the keep threshold of both sites (< 0: no dropout),
// drop_scale their keep scale.
int launch_mlp_products(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, void* z,
                        const void* ln, void* h, int rows, int row0, int C,
                        int hidden, int use_residual, const void* gamma,
                        int seed, int drop_thr, float drop_scale,
                        void* stream) {
  if (hidden <= 0 || hidden % 128 != 0 || C % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const GemmArgs g1{rows, hidden, C, (const float*)b1, nullptr, nullptr, 0,
                    z != nullptr,
                    make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale),
                    (uint32_t)row0};
  cudaError_t err = run_gemm<EPI_GELU>((const bf16*)ln, (const bf16*)w1,
                                       (bf16*)h, (bf16*)z, g1,
                                       (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs g2{rows, C, hidden, (const float*)b2, (const bf16*)x,
                    (const float*)gamma, use_residual, 0,
                    make_drop(seed, SITE_MLP_OUT, drop_thr, drop_scale),
                    (uint32_t)row0};
  return (int)run_gemm<EPI_OUT>((const bf16*)h, (const bf16*)w2,
                                (bf16*)out, nullptr, g2,
                                (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
