// Fused int8 (a8w8) MLP residual branch for Hopper (sm_90a):
//
//     y = [x +] fc2_q( rowquant( gelu_erf( fc1_q( rowquant( LN(x) ) ) ) ) )
//
// x is [rows, C] in bf16; w1 [H, C] and w2 [C, H] are int8 in (out, in)
// layout, K contiguous (H = 4C in the model), each with a float32 scale
// per output row; LayerNorm scale/bias, b1 and b2 are float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_mlp_int8_kernel, driven by fused_mlp_residual_int8. It runs once
// in every ScaleBlock of the int8 serving path.
//
// Rounding points are the TPU kernel's: the float32 LN output quantized
// per row; h = gelu((float)acc * row scale * s1 + b1) in float32; h
// quantized per row over the whole hidden row, from float32 (never
// rounded to bf16); y = (float)acc * row scale * s2 + b2 [+ x] in float32,
// cast once. GELU uses CUDA's erff (max error 2 ulp); the TPU kernel uses
// the Abramowitz-Stegun polynomial (max abs error 1.5e-7) and the plain
// version torch.erf.
//
// Design. One block of 8 warps takes 48 rows and quantizes their LN once
// into shared memory (int8 [48, C]). The hidden row's scale needs the
// amax of all H post-GELU values of the row before any of them is
// quantized, and a [48, H] float32 hidden (590 KB at H = 3072) fits in no
// SM. So the block walks the hidden width twice, in chunks of 128:
//   pass 1: fc1 for the chunk (int8 x int8 -> int32, mma.sync m16n8k32,
//     each warp 16 hidden columns), dequantize, bias, GELU, and keep each
//     row's running amax in registers; at its end the amax is reduced over
//     the lanes and warps into one scale per row;
//   pass 2: fc1 again for the chunk (the int32 sums are exact, and the
//     dequantization and GELU are the same instructions, so h is bit for
//     bit the value pass 1 saw), quantized with the row's scale into an
//     int8 [48, 128] chunk in shared memory, and the chunk's fc2 partial
//     product added into an int32 [48, C] accumulator in registers (each
//     warp 48 rows x C/8 columns).
// That is 1.5x the products of one pass (fc1 twice, fc2 once), at the
// int8 rate, and needs no scratch in device memory; the alternatives were
// a float32 h tile in shared memory for 16 rows (192 KB, so each block
// re-reads both weights for a third of the rows) or a float32 h round
// trip through device memory (231 MB each way at 18816 rows). The int32
// fc2 sums are exact and independent of order. Weights stream through
// shared memory in slabs (w1: 128 rows x 256 bytes of K; w2: C rows x 64
// bytes of the hidden) with cp.async, double-buffered. A ragged last
// block masks its missing rows; x is never padded in device memory.
//
// What bounds it on this card. The products, 4*rows*C*H int8 operations
// (178 G at 18816 rows, 0.090 ms at the int8 peak), against 58 MB of
// activations (0.017 ms). This kernel adds half again as many products,
// re-reads w1 twice and w2 once per block from L2 (7.1 MB at C=768), and
// runs mma.sync, which reaches only part of what wgmma can.

#include "tile_ops.cuh"

namespace {

constexpr int RT = 48;             // rows per block
constexpr int MT = RT / 16;        // m16 row tiles
constexpr int HC = 128;            // hidden chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int K1 = 256;            // w1 slab: HC rows x K1 bytes of K
constexpr int K1_LD = K1 + 16;
constexpr int K2 = 64;             // w2 slab: C rows x K2 bytes of hidden
constexpr int K2_LD = K2 + 16;
constexpr int HQ_LD = HC + 16;     // int8 hidden chunk

template <int C_>
struct Shape {
  static constexpr int C = C_;
  static constexpr int NJ = C / 8 / WARPS;        // fc2 n8 tiles per warp
  static constexpr int LQ_LD = C + 16;
  static constexpr int SL1 = C / K1;              // w1 slabs per chunk
  static constexpr int SL2 = HC / K2;             // w2 slabs per chunk
  static constexpr int STAGE = (HC * K1_LD > C * K2_LD) ? HC * K1_LD
                                                        : C * K2_LD;
  static constexpr size_t SMEM = RT * LQ_LD + RT * HQ_LD +
                                 4 * (2 * RT + WARPS * RT) + 2 * STAGE;
};

// Slab s of the weight stream: pass 1 is n_chunks x SL1 w1 slabs; pass 2
// n_chunks x (SL1 w1 slabs, then SL2 w2 slabs).
struct Slab {
  int pass, chunk, j;   // j < SL1: w1 slab j; else w2 slab j - SL1
};

template <int C>
__device__ __forceinline__ Slab slab_of(int s, int n_chunks) {
  typedef Shape<C> Sh;
  if (s < n_chunks * Sh::SL1) return {1, s / Sh::SL1, s % Sh::SL1};
  s -= n_chunks * Sh::SL1;
  constexpr int per = Sh::SL1 + Sh::SL2;
  return {2, s / per, s % per};
}

template <int C>
__device__ __forceinline__ void load_slab(int8_t* dst, Slab sl,
                                          const int8_t* w1, const int8_t* w2,
                                          int hidden) {
  typedef Shape<C> Sh;
  if (sl.j < Sh::SL1) {
    constexpr int SEGS = K1 / 16;
    const int r0 = sl.chunk * HC, k0 = sl.j * K1;
    for (int i = threadIdx.x; i < HC * SEGS; i += THREADS) {
      const int row = i / SEGS, seg = i % SEGS;
      cp_async16(dst + row * K1_LD + seg * 16,
                 w1 + (long)(r0 + row) * C + k0 + seg * 16);
    }
  } else {
    constexpr int SEGS = K2 / 16;
    const int k0 = sl.chunk * HC + (sl.j - Sh::SL1) * K2;
    for (int i = threadIdx.x; i < C * SEGS; i += THREADS) {
      const int row = i / SEGS, seg = i % SEGS;
      cp_async16(dst + row * K2_LD + seg * 16,
                 w2 + (long)row * hidden + k0 + seg * 16);
    }
  }
}

// h = gelu_erf((float)acc * row scale * s1 + b1), float32, in the TPU
// kernel's order: 0.5 * h * (1 + erf(h / sqrt 2)). Both passes run these
// same instructions, so pass 2 sees the values pass 1 took the amax of.
__device__ __forceinline__ float hidden_of(int acc, float rs, float cs,
                                           float b) {
  const float z = dequant(acc, rs, cs, b);
  return __fmul_rn(__fmul_rn(0.5f, z),
                   __fadd_rn(1.f, erff(__fmul_rn(z, 0.70710678118654752f))));
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_int8_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ lns,
                      const float* __restrict__ lnb,
                      const int8_t* __restrict__ w1,
                      const float* __restrict__ s1,
                      const float* __restrict__ b1,
                      const int8_t* __restrict__ w2,
                      const float* __restrict__ s2,
                      const float* __restrict__ b2, bf16* __restrict__ out,
                      int rows, int hidden, float eps, int use_residual) {
  typedef Shape<C> Sh;
  constexpr int NJ = Sh::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sLQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sHQ = sLQ + RT * Sh::LQ_LD;
  float* sLS = reinterpret_cast<float*>(sHQ + RT * HQ_LD);
  float* sHS = sLS + RT;
  float* sAmax = sHS + RT;                      // [WARPS][RT]
  int8_t* stage0 = reinterpret_cast<int8_t*>(sAmax + WARPS * RT);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair
  const long row0 = (long)blockIdx.x * RT;
  const int R = (int)min((long)RT, rows - row0);  // live rows of this block

  const int n_chunks = hidden / HC;
  const int total = n_chunks * (2 * Sh::SL1 + Sh::SL2);
  load_slab<C>(stage0, slab_of<C>(0, n_chunks), w1, w2, hidden);
  cp_async_commit();

  // ---- 1. LayerNorm of the block's rows, quantized per row ----
  lnq_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, true, sLQ, Sh::LQ_LD,
                         sLS);

  // fc1: warp owns hidden columns [16*warp, 16*warp + 16) of the chunk;
  // fc2: warp owns output columns [warp * C/8, (warp + 1) * C/8)
  int h1[MT][2][4];
  int acc[MT][NJ][4];
  float amax[MT][2];     // pass 1: rows 16m + g + 8hr
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    amax[m][0] = amax[m][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0;
  }

  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_slab<C>(stage0 + ((s + 1) & 1) * Sh::STAGE,
                   slab_of<C>(s + 1, n_chunks), w1, w2, hidden);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* slab = stage0 + (s & 1) * Sh::STAGE;
    const Slab sl = slab_of<C>(s, n_chunks);

    if (s == n_chunks * Sh::SL1) {
      // ---- pass 1 done: each row's amax over lanes and warps -> scale ---
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float a = amax[m][hr];
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
          if (t == 0) sAmax[warp * RT + m * 16 + g + 8 * hr] = a;
        }
      __syncthreads();
      if (threadIdx.x < RT) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a = fmaxf(a, sAmax[w * RT + threadIdx.x]);
        sHS[threadIdx.x] = row_scale(a);
      }
      __syncthreads();
    }

    if (sl.j < Sh::SL1) {
      // ---- 2. fc1 partial over this slab's K1 bytes of K ----
      if (sl.j == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) h1[m][n][q] = 0;
      }
#pragma unroll
      for (int kk = 0; kk < K1; kk += 32) {
        unsigned b[4];
        ldsm_b8x2(b, slab + (warp * 16) * K1_LD + kk, K1_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a8(a, sLQ + m * 16 * Sh::LQ_LD + sl.j * K1 + kk, Sh::LQ_LD,
                  lane);
          mma16832(h1[m][0], a, b[0], b[1]);
          mma16832(h1[m][1], a, b[2], b[3]);
        }
      }
      if (sl.j == Sh::SL1 - 1) {
        // dequantize, bias, GELU: pass 1 takes the amax, pass 2 quantizes
        // the chunk with the row's scale into sHQ
        const int c0 = sl.chunk * HC;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = warp * 16 + n * 8 + 2 * t;
            const float cs0 = s1[c0 + col], cs1 = s1[c0 + col + 1];
            const float bb0 = b1[c0 + col], bb1 = b1[c0 + col + 1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = m * 16 + g + 8 * hr;
              const float a0 = hidden_of(h1[m][n][2 * hr], sLS[row], cs0,
                                         bb0);
              const float a1 = hidden_of(h1[m][n][2 * hr + 1], sLS[row], cs1,
                                         bb1);
              if (sl.pass == 1) {
                amax[m][hr] = fmaxf(amax[m][hr], fmaxf(fabsf(a0), fabsf(a1)));
              } else {
                const float hs = sHS[row];
                *reinterpret_cast<char2*>(sHQ + row * HQ_LD + col) =
                    make_char2(quant8(a0, hs), quant8(a1, hs));
              }
            }
          }
      }
    } else {
      // ---- 3. acc += hq[:, K2 slice] @ w2 slab^T (int32) ----
      const int kh = (sl.j - Sh::SL1) * K2;
#pragma unroll
      for (int kk = 0; kk < K2; kk += 32) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_a8(a[m], sHQ + m * 16 * HQ_LD + kh + kk, HQ_LD, lane);
#pragma unroll
        for (int n = 0; n < NJ; n += 2) {
          unsigned b[4];
          ldsm_b8x2(b, slab + (warp * (C / 8) + n * 8) * K2_LD + kk, K2_LD,
                    lane);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma16832(acc[m][n], a[m], b[0], b[1]);
            mma16832(acc[m][n + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- 4. epilogue: dequantize + b2 [+ x], one cast, live rows only ----
  store_rows_dq<C, MT, NJ>(acc, warp * (C / 8), sHS, s2, b2, x, out, row0, R,
                           use_residual);
}

template <int C>
cudaError_t launch(const bf16* x, const float* lns, const float* lnb,
                   const int8_t* w1, const float* s1, const float* b1,
                   const int8_t* w2, const float* s2, const float* b2,
                   bf16* out, int rows, int hidden, float eps,
                   int use_residual, cudaStream_t stream) {
  constexpr size_t smem = Shape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_int8_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + RT - 1) / RT;
  fused_mlp_int8_kernel<C><<<blocks, THREADS, smem, stream>>>(
      x, lns, lnb, w1, s1, b1, w2, s2, b2, out, rows, hidden, eps,
      use_residual);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: C in {256, 512, 768}, hidden a positive
// multiple of 128, every pointer 32-byte aligned.
int launch_fused_mlp_residual_int8(const void* x, const void* lns,
                                   const void* lnb, const void* w1,
                                   const void* s1, const void* b1,
                                   const void* w2, const void* s2,
                                   const void* b2, void* out, int rows, int C,
                                   int hidden, float eps, int use_residual,
                                   void* stream) {
  if (hidden <= 0 || hidden % HC != 0) return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const int8_t*)w1, \
      (const float*)s1, (const float*)b1, (const int8_t*)w2,               \
      (const float*)s2, (const float*)b2, (bf16*)out, rows, hidden, eps,   \
      use_residual, (cudaStream_t)stream
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
