// Fused MLP residual branch for Hopper (sm_90a):
//
//     y = [x +] fc2( gelu_erf( fc1( LN(x) ) ) )
//
// x is [rows, C] in bf16; w1 [C, H] and w2 [H, C] are bf16 in (in, out)
// layout (H = 4C in the model); LayerNorm scale/bias, b1 and b2 are
// float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_mlp_kernel
// (inert instantiation) and _fused_mlp_kernel_z (the same forward that also
// writes the pre-GELU hidden z [rows, H] in bf16 for the save-hidden
// backward), both driven by _fused_mlp_impl. The serving form runs once in
// every ScaleBlock of the serving path, the z form once in every ScaleBlock
// of a training step. The reg instantiations (fused_mlp_residual_reg,
// pallas_attention.py:1940; kernel semantics :1330-1347, :1379-1395) are
// runtime arguments of the same kernel: dropout of the post-GELU hidden
// (site 2) before its bf16 cast, dropout of fc2 + b2 (site 3), then a
// LayerScale gamma, then the residual, every mask at the global flat row
// (csrc/dropout_hash.cuh); the z form still saves z before any dropout.
// The legacy family runs the serving form with gamma in every block of a
// forward and the z form with gamma and dropout in every block of a step.
// The z form writes z from the fc1 accumulator
// fragments as they are, before GELU: 4 threads store 16 contiguous bytes
// of a row, so the write is not fully coalesced (rows * H * 2 bytes, 231 MB
// per block at B=128).
//
// Rounding points are the TPU kernel's: LN output cast to bf16, fc1 + b1
// and the exact GELU in float32, the post-GELU hidden cast to bf16, fc2 +
// b2 + residual accumulated in float32 and cast once. GELU uses CUDA's
// erff (max error 2 ulp); the TPU kernel uses the Abramowitz-Stegun
// polynomial (max abs error 1.5e-7) and the plain version torch.erf. The
// three agree far inside the bf16 rounding of the hidden.
//
// Design. One block of 8 warps takes 48 rows. It normalises them once into
// shared memory, then walks the hidden width in chunks of 128: fc1 for the
// chunk (each warp: 48 rows x 16 hidden columns; at C = 384 over three
// 128-row w1 slabs, elsewhere 256-row ones), bias and GELU, the bf16
// chunk into shared memory, and the chunk's fc2 partial product added into
// a float32 [48, C] accumulator held in registers (each warp: 48 rows x
// C/8 columns, 144 registers at C=768). The [rows, 4C] hidden never
// touches device memory (the TPU kernel kept a [256, 4C] VMEM scratch,
// 1.5 MB, which no SM could hold). Weights stream through shared memory in
// slabs (w1: 256 rows x 128 columns, w2: 32 rows x C) with cp.async,
// double-buffered, so each weight byte crosses L2 once per block. The
// products are mma.sync m16n8k16 (bf16 in, float32 accumulate) on operands
// loaded with ldmatrix; each fc2 weight fragment serves 3 row tiles and
// each hidden fragment C/64 column tiles. A ragged last block masks its
// missing rows; x is never padded in device memory.
//
// What bounds it on this card. The arithmetic is compute bound (4*rows*C*H
// flops against 4*rows*C bytes of activations), but this kernel is far
// from the tensor-core roof: every block re-reads all of w1 and w2 (9.4 MB
// at C=768) from L2, each slab costs two block-wide barriers, and
// mma.sync reaches only part of what wgmma can. wgmma with TMA-fed slabs,
// multicast of the slabs across a cluster (one L2 read for several
// blocks) and larger row tiles are the next steps.

#include "tile_ops.cuh"

namespace {

constexpr int RT = 48;             // rows per block
constexpr int MT = RT / 16;        // m16 row tiles
constexpr int HC = 128;            // hidden chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int H_LD = HC + 8;
constexpr int W1_LD = HC + 8;
constexpr int K2 = 32;             // w2 slab: K2 rows x C columns

template <int C_>
struct Shape {
  static constexpr int C = C_;
  // w1 slab: K1 rows x HC columns. 256 rows where C is a multiple of 256;
  // at C = 384 (ViT-S) a 256-row slab would leave C / 256 = 1 slab and
  // drop the last 128 rows of the fc1 product, so 128-row slabs (3).
  static constexpr int K1 = C % 256 == 0 ? 256 : 128;
  static_assert(C % K1 == 0 && C % 64 == 0,
                "the w1 slabs must tile C; each warp owns C / 8 columns");
  static constexpr int NJ = C / 8 / 8;            // fc2 n8 tiles per warp
  static_assert(NJ % 2 == 0, "fc2 takes its n8 tiles in pairs");
  static constexpr int LN_LD = C + 8;
  static constexpr int W2_LD = C + 8;
  static constexpr int SLABS1 = C / K1;           // w1 slabs per chunk
  static constexpr int SLABS = SLABS1 + HC / K2;  // + w2 slabs per chunk
  static constexpr int STAGE = (K1 * W1_LD > K2 * W2_LD) ? K1 * W1_LD
                                                         : K2 * W2_LD;
  static constexpr size_t SMEM =
      sizeof(bf16) * (RT * LN_LD + RT * H_LD + 2 * STAGE);
};

// Slab s of the weight stream (chunk s / SLABS): w1 slabs first, then w2.
template <int C>
__device__ __forceinline__ void load_slab(bf16* dst, int s, const bf16* w1,
                                          const bf16* w2, int hidden) {
  typedef Shape<C> S;
  const int chunk = s / S::SLABS, j = s % S::SLABS, c0 = chunk * HC;
  if (j < S::SLABS1) {
    const int k0 = j * S::K1;
    for (int i = threadIdx.x; i < S::K1 * (HC / 8); i += THREADS) {
      const int row = i / (HC / 8), seg = i % (HC / 8);
      cp_async16(dst + row * W1_LD + seg * 8,
                 w1 + (long)(k0 + row) * hidden + c0 + seg * 8);
    }
  } else {
    const int r0 = c0 + (j - S::SLABS1) * K2;
    for (int i = threadIdx.x; i < K2 * (C / 8); i += THREADS) {
      const int row = i / (C / 8), seg = i % (C / 8);
      cp_async16(dst + row * S::W2_LD + seg * 8,
                 w2 + (long)(r0 + row) * C + seg * 8);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                 const float* __restrict__ lnb, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out,
                 bf16* __restrict__ zout, int rows, int hidden, float eps,
                 int use_residual, const float* __restrict__ gamma,
                 Drop hdrop, Drop odrop) {
  typedef Shape<C> S;
  constexpr int NJ = S::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLN = reinterpret_cast<bf16*>(smem);
  bf16* sH = sLN + RT * S::LN_LD;
  bf16* stage0 = sH + RT * H_LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair
  const long row0 = (long)blockIdx.x * RT;
  const int R = (int)min((long)RT, rows - row0);  // live rows of this block

  const int total = (hidden / HC) * S::SLABS;
  load_slab<C>(stage0, 0, w1, w2, hidden);
  cp_async_commit();

  // ---- 1. LayerNorm of the block's rows into sLN (bf16) ----
  ln_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, true, sLN, S::LN_LD);

  // fc1: warp owns hidden columns [16*warp, 16*warp + 16) of the chunk;
  // fc2: warp owns output columns [warp * C/8, (warp + 1) * C/8)
  float h1[MT][2][4];
  float acc[MT][NJ][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_slab<C>(stage0 + ((s + 1) & 1) * S::STAGE, s + 1, w1, w2, hidden);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* slab = stage0 + (s & 1) * S::STAGE;
    const int j = s % S::SLABS;
    if (j < S::SLABS1) {
      // ---- 2. fc1 partial over this slab's K1 rows ----
      if (j == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) h1[m][n][q] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < S::K1; kk += 16) {
        unsigned b[4];
        ldsm_b2(b, slab + kk * W1_LD + warp * 16, W1_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sLN + m * 16 * S::LN_LD + j * S::K1 + kk, S::LN_LD,
                 lane);
          mma16816(h1[m][0], a, b[0], b[1]);
          mma16816(h1[m][1], a, b[2], b[3]);
        }
      }
      if (j == S::SLABS1 - 1) {
        // bias + exact GELU in float32, hidden chunk to bf16; the z form
        // also stores the pre-GELU z = fc1 + b1 in bf16
        const int c0 = (s / S::SLABS) * HC;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = warp * 16 + n * 8 + 2 * t;
            const float bb0 = b1[c0 + col], bb1 = b1[c0 + col + 1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = m * 16 + g + 8 * hr;
              const float z0 = h1[m][n][2 * hr] + bb0;
              const float z1 = h1[m][n][2 * hr + 1] + bb1;
              float a0 = 0.5f * z0 * (1.f + erff(z0 * 0.70710678118654752f));
              float a1 = 0.5f * z1 * (1.f + erff(z1 * 0.70710678118654752f));
              if (hdrop.on) {
                a0 = hdrop.apply(a0, (uint32_t)(row0 + row), c0 + col);
                a1 = hdrop.apply(a1, (uint32_t)(row0 + row), c0 + col + 1);
              }
              if (zout != nullptr && row < R)
                *reinterpret_cast<__nv_bfloat162*>(
                    zout + (row0 + row) * hidden + c0 + col) =
                    __floats2bfloat162_rn(z0, z1);
              *reinterpret_cast<__nv_bfloat162*>(sH + row * H_LD + col) =
                  __floats2bfloat162_rn(a0, a1);
            }
          }
      }
    } else {
      // ---- 3. acc += hidden[:, K2 slice] @ w2 slab ----
      const int kh = (j - S::SLABS1) * K2;
#pragma unroll
      for (int kk = 0; kk < K2; kk += 16) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_a(a[m], sH + m * 16 * H_LD + kh + kk, H_LD, lane);
#pragma unroll
        for (int n = 0; n < NJ; n += 2) {
          unsigned b[4];
          ldsm_b2(b, slab + kk * S::W2_LD + warp * (C / 8) + n * 8, S::W2_LD,
                  lane);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma16816(acc[m][n], a[m], b[0], b[1]);
            mma16816(acc[m][n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- 4. epilogue: + b2 (, output dropout, * gamma) [+ x], one cast,
  // live rows only ----
  store_rows<C, MT, NJ>(acc, warp * (C / 8), b2, x, out, row0, R,
                        use_residual, gamma, odrop);
}

template <int C>
cudaError_t launch(const bf16* x, const float* lns, const float* lnb,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, bf16* out, bf16* zout, int rows,
                   int hidden, float eps, int use_residual,
                   const float* gamma, Drop hdrop, Drop odrop,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + RT - 1) / RT;
  fused_mlp_kernel<C><<<blocks, THREADS, smem, stream>>>(
      x, lns, lnb, w1, b1, w2, b2, out, zout, rows, hidden, eps,
      use_residual, gamma, hdrop, odrop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: C in {256, 384, 512, 768}, hidden a positive
// multiple of 128, every pointer 32-byte aligned. z: null (the serving
// form), or [rows, hidden] bf16 for the pre-GELU hidden (the z form). The
// reg form: gamma float32 [C] or null; seed the int32 dropout seed;
// drop_thr the keep threshold of both sites (< 0: no dropout), drop_scale
// their keep scale.
int launch_fused_mlp_residual(const void* x, const void* lns, const void* lnb,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* z, int rows,
                              int C, int hidden, float eps, int use_residual,
                              const void* gamma, int seed, int drop_thr,
                              float drop_scale, void* stream) {
  if (hidden <= 0 || hidden % HC != 0) return (int)cudaErrorInvalidValue;
#define ARGS                                                              \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const bf16*)w1, \
      (const float*)b1, (const bf16*)w2, (const float*)b2, (bf16*)out,   \
      (bf16*)z, rows, hidden, eps, use_residual, (const float*)gamma,    \
      make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale),                 \
      make_drop(seed, SITE_MLP_OUT, drop_thr, drop_scale), (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch<256>(ARGS);
    case 384: return (int)launch<384>(ARGS);
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
