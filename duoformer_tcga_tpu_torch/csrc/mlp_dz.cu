// The dz pass of the save-hidden MLP backward for Hopper (sm_90a):
//
//     dh  = g @ w2^T                      (float32 accumulate)
//     dz  = bf16( dh * gelu'(z) )         gelu'(z) = Phi(z) + z * phi(z)
//     db1 = column sums of the rounded dz (float32)
//
// g is [rows, C] and z (the pre-GELU hidden the forward saved) [rows, H],
// both bf16; w2 is [H, C] bf16 in (in, out) layout, read here as the
// transposed operand of dh. dz is [rows, H] bf16; db1 [H] float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _mlp_dz_kernel
// (emit_h=False), driven by _mlp_dz_impl. It runs once in every ScaleBlock
// of a training step's backward.
//
// Rounding points are the TPU kernel's: gelu'(z) in float32 from the bf16
// z (erff here, the A&S polynomial there), dz rounded once to bf16, and
// db1 summed from the ROUNDED dz in float32 (pallas_attention.py:1748).
//
// Design. A tiled product: one block of 8 warps computes a 128-row x
// 128-column tile of dh (each warp 64 x 32, 64 float32 accumulators), with
// K = C streamed through shared memory in slabs of 64 (g rows and w2 rows
// side by side, cp.async, double-buffered); mma.sync m16n8k16 on ldmatrix
// fragments, w2's rows giving the B operand without a transpose. The
// epilogue reads the tile's z, applies gelu', stores dz and sums each
// column of the rounded dz over the tile's rows into one float32 partial
// per (row tile, column). The TPU kernel summed db1 over its sequential
// grid in one revisited block; a CUDA grid runs in parallel, so a second,
// small kernel adds the partials of each column in a fixed order. No
// atomics: db1 does not depend on the order the blocks ran in.
//
// What bounds it on this card. 2*rows*C*H flops against 2*rows*(C + 2H)
// bytes (g and z in, dz out): about 340 operations a byte at C=768,
// H=3072, just above the card's ridge of ~295, so bound by operations,
// with the bytes close behind. mma.sync from a two-slab ring reaches only
// part of the tensor-core roof; wgmma with a deeper TMA ring is the next
// step.

#include "tile_ops.cuh"

namespace {

constexpr int BM = 128;            // rows per block
constexpr int BN = 128;            // hidden columns per block
constexpr int BK = 64;             // K (= C) per slab
constexpr int LD = BK + 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WM = 64, WN = 32;    // warp tile: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int STAGE = (BM + BN) * LD;
constexpr size_t SMEM = sizeof(bf16) * 2 * STAGE + sizeof(float) * 2 * BN;
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

// Slab k0: g rows [r0, r0 + BM) then w2 rows [n0, n0 + BN), columns
// [k0, k0 + BK) of each. g rows at or past `rows` are zeros.
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* g,
                                          const bf16* w2, long r0, int n0,
                                          int k0, int rows, int C) {
  for (int i = threadIdx.x; i < (BM + BN) * (BK / 8); i += THREADS) {
    const int row = i / (BK / 8), seg = i % (BK / 8);
    bf16* d = dst + row * LD + seg * 8;
    if (row < BM) {
      if (r0 + row < rows)
        cp_async16(d, g + (r0 + row) * C + k0 + seg * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else {
      cp_async16(d, w2 + (long)(n0 + row - BM) * C + k0 + seg * 8);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
mlp_dz_kernel(const bf16* __restrict__ g, const bf16* __restrict__ z,
              const bf16* __restrict__ w2, bf16* __restrict__ dz,
              float* __restrict__ part, int rows, int C, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(stage0 + 2 * STAGE);   // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const long r0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  const int total = C / BK;
  load_slab(stage0, g, w2, r0, n0, 0, rows, C);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_slab(stage0 + ((s + 1) & 1) * STAGE, g, w2, r0, n0, (s + 1) * BK,
                rows, C);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* sA = stage0 + (s & 1) * STAGE;
    const bf16* sB = sA + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned b[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_bt2(b[np], sB + (wn * WN + np * 16) * LD + kk, LD, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned a[4];
        ldsm_a(a, sA + (wm * WM + m * 16) * LD + kk, LD, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma16816(acc[m][2 * np], a, b[np][0], b[np][1]);
          mma16816(acc[m][2 * np + 1], a, b[np][2], b[np][3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: dz = bf16(dh * gelu'(z)); column sums of the rounded dz
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + wn * WN + n * 8 + 2 * t;
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long row = r0 + wm * WM + m * 16 + gq + 8 * hr;
        if (row >= rows) continue;
        const long off = row * hidden + col;
        const float2 zf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(z + off));
        const float p0 = 0.5f * (1.f + erff(zf.x * SQRT1_2));
        const float p1 = 0.5f * (1.f + erff(zf.y * SQRT1_2));
        const float d0 = p0 + zf.x * (INV_SQRT_2PI * expf(-0.5f * zf.x * zf.x));
        const float d1 = p1 + zf.y * (INV_SQRT_2PI * expf(-0.5f * zf.y * zf.y));
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[m][n][2 * hr] * d0, acc[m][n][2 * hr + 1] * d1);
        *reinterpret_cast<__nv_bfloat162*>(dz + off) = v;
        const float2 vf = __bfloat1622float2(v);
        cs0 += vf.x;
        cs1 += vf.y;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
    }
    if (gq == 0) {
      red[wm * BN + col - n0] = cs0;
      red[wm * BN + col - n0 + 1] = cs1;
    }
  }
  __syncthreads();
  if (threadIdx.x < BN)
    part[(long)blockIdx.y * hidden + n0 + threadIdx.x] =
        red[threadIdx.x] + red[BN + threadIdx.x];
}

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
  cudaError_t err = cudaFuncSetAttribute(
      mlp_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nb = (rows + BM - 1) / BM;
  mlp_dz_kernel<<<dim3(hidden / BN, nb), THREADS, SMEM, st>>>(
      (const bf16*)g, (const bf16*)z, (const bf16*)w2, (bf16*)dz,
      (float*)part, rows, C, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(hidden + 255) / 256, 256, 0, st>>>(
      (const float*)part, nb, hidden, (float*)db1);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
