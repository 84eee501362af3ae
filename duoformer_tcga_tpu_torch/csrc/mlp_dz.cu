// The dz pass of the save-hidden MLP backward for Hopper (sm_90a):
//
//     dh  = g @ w2^T                      (float32 accumulate)
//     dz  = bf16( dh * gelu'(z) )         gelu'(z) = Phi(z) + z * phi(z)
//     db1 = column sums of the rounded dz (float32)
//
// g is [rows, C] and z (the pre-GELU hidden the forward saved) [rows, H],
// both bf16; w2 is [H, C] bf16 in (in, out) layout, read here as the
// K-major B of dh. dz is [rows, H] bf16; db1 [H] float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _mlp_dz_kernel
// (emit_h=False), driven by _mlp_dz_impl. It runs once in every ScaleBlock
// of a training step's backward.
//
// Rounding points are the TPU kernel's: gelu'(z) in float32 from the bf16
// z (erff here, the A&S polynomial there), dz rounded once to bf16, and
// db1 summed from the ROUNDED dz in float32 (pallas_attention.py:1748).
//
// Design: one C entry a call, two launches.
//   1. gemm_sm90.cuh's persistent TMA-fed wgmma product with the EPI_DZ
//      epilogue: 128 x 128 tiles of dh (two consumer pairs taking turns,
//      so one pair's epilogue runs under the other's products); each
//      consumer TMA-loads its tile's z into its staging tile as its
//      products start, writes dz over it, TMA-stores it, and sums each
//      column of the rounded dz over its 64 rows; the pair's eight warps'
//      sums are added in one fixed order into one float32 partial per
//      (row tile, column).
//   2. sum_partials_kernel adds each column's partials in row-tile order.
//   The TPU kernel summed db1 over its sequential grid in one revisited
//   block; here no atomics either, so db1 and dz are the same bits from
//   launch to launch.
//
// What bounds it on this card. 2*rows*C*H flops against 2*rows*(C + 2H)
// bytes (g and z in, dz out): about 340 operations a byte at C=768,
// H=3072, just above the card's ridge of ~295, so bound by operations,
// with the bytes close behind (z and dz are 0.14 ms of 0.18 at 37,632
// rows): the z loads and dz stores run under the other pair's products.

#include "gemm_sm90.cuh"

namespace {

// out[j] = sum over b < nb of part[b * width + j], in order of b.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nb,
                                    int width, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[(long)b * width + j];
  out[j] = s;
}

}  // namespace

extern "C" {

// Returns the first cudaGetLastError() of the two launches (0 on success).
// Arguments are checked by the Python wrapper: rows >= 1, C a multiple of
// 64, hidden a multiple of 128, every pointer 32-byte aligned. part is a
// float32 workspace of ceil(rows / 128) * hidden.
int launch_mlp_dz(const void* g, const void* z, const void* w2, void* dz,
                  void* db1, void* part, int rows, int C, int hidden,
                  void* stream) {
  if (rows < 1 || C % BK != 0 || hidden % BN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GemmArgs a{};
  a.M = rows;
  a.N = hidden;
  a.K = C;
  a.out = (float*)part;
  cudaError_t err = run_gemm<EPI_DZ, false, true>(g, w2, dz, z, a, st);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(hidden + 255) / 256, 256, 0, st>>>(
      (const float*)part, (rows + BM - 1) / BM, hidden, (float*)db1);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
