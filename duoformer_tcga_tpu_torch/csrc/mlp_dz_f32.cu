// The dz pass of the save-hidden MLP backward in float32 for Hopper
// (sm_90a):
//
//     dh  = g @ w2^T
//     dz  = dh * gelu'(z)          gelu'(z) = Phi(z) + z * phi(z)
//     db1 = column sums of dz
//
// g is [rows, C], z (the pre-GELU hidden the forward saved) [rows, H] and
// w2 [H, C] (in, out), all float32; dz [rows, H] and db1 [H] float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _mlp_dz_kernel
// (emit_h=False, driven by _mlp_dz_impl) at dtype float32: once in every
// ScaleBlock of a float32 training step's backward. In float32 its casts
// are no-ops (row tiles halved by _f32_shrink), and db1 sums the float32
// dz, as here.
//
// Design: the tiled FMA product of csrc/f32_tile.cuh with w2's rows as the
// transposed operand, gelu' applied in its epilogue from the tile's z;
// then db1 as column sums over chunks of 256 rows, the chunks added in a
// fixed order (no atomics). The product is float32 FMA (the header says
// why not TF32).
//
// What bounds it on this card: 2*rows*C*H flops at the float32 FMA rate
// (the bytes, 4*rows*(C + 2H), take a tenth of that time).

#include "f32_tile.cuh"

extern "C" {

// Floats of the `part` scratch the launch needs for `rows` rows.
long long mlp_dz_f32_part_floats(int rows, int hidden) {
  return (long long)f32::colsum_parts(rows) * hidden;
}

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: C a multiple of 8, hidden a
// multiple of 128, every pointer 32-byte aligned; part float32
// (mlp_dz_f32_part_floats).
int launch_mlp_dz_f32(const void* g, const void* z, const void* w2,
                      void* dz, void* db1, void* part, int rows, int C,
                      int hidden, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = f32::gemm<true>(
      (const float*)g, (const float*)w2, rows, hidden, C,
      f32::EpiDz{(const float*)z, (float*)dz, hidden}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)f32::colsum((const float*)dz, rows, hidden, (float*)part,
                          (float*)db1, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
