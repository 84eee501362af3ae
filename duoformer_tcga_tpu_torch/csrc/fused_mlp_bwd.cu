// The recompute-from-x backward of the fused MLP residual branch for Hopper
// (sm_90a). The forward (csrc/fused_mlp_residual.cu) is
//
//     y = x + fc2( gelu_erf( fc1( LN(x) ) ) ).
//
// Given x and the upstream gradient g (both [rows, C] bf16), w1 [C, H] and
// w2 [H, C] (bf16, (in, out) layout) and the float32 LN scale/bias and b1,
// this kernel recomputes LN and fc1 on chip and writes
//     dx [rows, C] bf16   the input cotangent: the LN backward of dln, + g
//     ln [rows, C] bf16   the LN output            (for dW1 = ln^T dz)
//     h  [rows, H] bf16   gelu(z), z = ln w1 + b1  (for dW2 = h^T g)
//     dz [rows, H] bf16   (g w2^T) * gelu'(z)      (for dW1 and db1)
// and the float32 column sums dlns = sum(dln * xhat), dlnb = sum(dln). The
// weight gradients are large products the caller runs outside, as the JAX
// package leaves them to XLA.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_mlp_bwd_kernel, driven by _fused_mlp_bwd_impl: the MLP backward
// when the forward saved no hidden (DUOFORMER_MLP_SAVE_HIDDEN=0 with
// DUOFORMER_PALLAS_MLP_BWD=1; in the port mlp_save_hidden=False), once in
// every ScaleBlock of the memory-lean training step.
//
// Rounding points are the TPU kernel's: LN with float32 statistics, ln in
// bf16; z = ln w1 + b1 in float32; h = bf16(z * Phi(z)) from the float32
// z (the save-hidden route takes it from the bf16 z); dh = g w2^T in
// float32; dz = bf16(dh * (Phi(z) + z * phi(z))); dln = dz w1^T from the
// bf16 dz, in float32; the LN backward in float32 and dx = bf16(dxf + g).
// Phi uses CUDA's erff (max error 2 ulp) where the TPU kernel uses the
// Abramowitz-Stegun polynomial (1.5e-7), as the forward kernel does.
//
// Design. One block of 8 warps takes RT = 32 rows. It normalises them once
// into shared memory (keeping each row's mean and 1/std) and copies their
// g beside them, then walks the hidden width in chunks of 128. For each
// chunk it streams three runs of 128 x 128 weight slabs through a
// double-buffered cp.async ring: w1 rows x the chunk's columns for z
// (each warp 32 rows x 16 hidden columns), w2's chunk rows for dh (the
// same warp tile; ldmatrix without .trans gives w2^T), then, after the
// chunk's h and dz are written and dz is in shared memory, w1 again for
// dln += dz w1[:, chunk]^T into a float32 [32, C] accumulator held in
// registers across chunks (each warp 16 of every 128 columns), as the
// first attention backward held its dln.
// Neither z nor dh leaves the chip. After the last chunk the block
// finishes the LN backward (row sums across the 8 warps through shared
// memory), writes dx and one float32 partial row [2C] of the column sums;
// a second, small kernel adds the blocks' partials in block order, without
// atomics. A ragged last block masks its missing rows (zeros in sLN and
// sG, never written).
//
// What bounds it on this card. 6*rows*C*H flops (fc1, dh, dln) against
// 2*rows*(4C + 2H) bytes of activations in and out: bound by the
// operations (0.539 ms at 37632 rows). This kernel is far from that: each
// block streams w1 twice and w2 once from L2 (14 MB at C=768) in slabs with
// two barriers each, on mma.sync; wgmma with TMA-fed slabs, more rows a
// block and multicast across a cluster are the next steps.

#include "tile_ops.cuh"

namespace {

constexpr int RT = 32;             // rows per block
constexpr int MT = RT / 16;        // m16 row tiles
constexpr int HC = 128;            // hidden chunk
constexpr int KS = 128;            // slab: 128 x 128
constexpr int SL_LD = KS + 8;
constexpr int DZ_LD = HC + 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGE = KS * SL_LD;
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

template <int C_>
struct Shape {
  static constexpr int C = C_;
  static constexpr int NS = C / KS;        // slabs per run (3 at C = 384)
  static_assert(C % KS == 0, "the 128 x 128 slabs must tile C");
  static constexpr int PER_CHUNK = 3 * NS;
  static constexpr int LN_LD = C + 8;
  static constexpr size_t SMEM =
      sizeof(bf16) * (2 * RT * LN_LD + RT * DZ_LD + 2 * STAGE) +
      sizeof(float) * 2 * RT;
};

// Slab j of a chunk's stream: run 0 (z) and run 2 (dln) take w1 rows
// [s*KS, s*KS + KS) x the chunk's columns; run 1 (dh) takes w2's chunk rows
// x columns [s*KS, s*KS + KS).
template <int C>
__device__ __forceinline__ void load_slab(bf16* dst, int chunk, int j,
                                          const bf16* w1, const bf16* w2,
                                          int hidden) {
  typedef Shape<C> Sh;
  const int run = j / Sh::NS, s = j % Sh::NS;
  const bf16* src;
  long ld;
  if (run == 1) {
    src = w2 + (long)chunk * HC * C + s * KS;
    ld = C;
  } else {
    src = w1 + (long)s * KS * hidden + chunk * HC;
    ld = hidden;
  }
  for (int i = threadIdx.x; i < KS * (KS / 8); i += THREADS) {
    const int row = i / (KS / 8), seg = i % (KS / 8);
    cp_async16(dst + row * SL_LD + seg * 8, src + row * ld + seg * 8);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const float* __restrict__ lns,
                     const float* __restrict__ lnb,
                     const bf16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const bf16* __restrict__ w2, bf16* __restrict__ dx,
                     bf16* __restrict__ ln_out, bf16* __restrict__ h_out,
                     bf16* __restrict__ dz_out, float* __restrict__ part,
                     int rows, int hidden, float eps) {
  typedef Shape<C> Sh;
  constexpr int NS = Sh::NS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLN = reinterpret_cast<bf16*>(smem);
  bf16* sG = sLN + RT * Sh::LN_LD;
  bf16* sDZ = sG + RT * Sh::LN_LD;
  bf16* stage0 = sDZ + RT * DZ_LD;
  float* sStat = reinterpret_cast<float*>(stage0 + 2 * STAGE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const long row0 = (long)blockIdx.x * RT;
  const int R = (int)min((long)RT, rows - row0);  // live rows of this block
  float* bpart = part + (long)blockIdx.x * 2 * C;

  const int total = (hidden / HC) * Sh::PER_CHUNK;
  int s = 0;                                 // slab counter
  load_slab<C>(stage0, 0, 0, w1, w2, hidden);
  cp_async_commit();
  auto next_slab = [&]() -> const bf16* {
    if (s + 1 < total)
      load_slab<C>(stage0 + ((s + 1) & 1) * STAGE, (s + 1) / Sh::PER_CHUNK,
                   (s + 1) % Sh::PER_CHUNK, w1, w2, hidden);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    return stage0 + (s & 1) * STAGE;
  };

  // ---- LayerNorm of the block's rows (ln to device memory) and their g ----
  ln_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, true, sLN, Sh::LN_LD,
                        sStat);
  for (int i = threadIdx.x; i < RT * (C / 8); i += THREADS) {
    const int r = i / (C / 8), seg = i % (C / 8);
    *reinterpret_cast<uint4*>(sG + r * Sh::LN_LD + seg * 8) =
        r < R ? *reinterpret_cast<const uint4*>(g + (row0 + r) * C + seg * 8)
              : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * (C / 8); i += THREADS) {
    const int r = i / (C / 8), seg = i % (C / 8);
    *reinterpret_cast<uint4*>(ln_out + (row0 + r) * C + seg * 8) =
        *reinterpret_cast<const uint4*>(sLN + r * Sh::LN_LD + seg * 8);
  }

  float acc[MT][2 * NS][4];                  // dln: warp owns columns
#pragma unroll                               // s*128 + warp*16 + [0, 16)
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * NS; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int chunk = 0; chunk < hidden / HC; ++chunk) {
    // ---- 1. z = ln w1[:, chunk] (warp: hidden columns warp*16 ..) ----
    float zacc[MT][2][4], dacc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) zacc[m][n][q] = dacc[m][n][q] = 0.f;
    for (int k = 0; k < NS; ++k, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned b[4];
        ldsm_b2(b, slab + kk * SL_LD + warp * 16, SL_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sLN + m * 16 * Sh::LN_LD + k * KS + kk, Sh::LN_LD, lane);
          mma16816(zacc[m][0], a, b[0], b[1]);
          mma16816(zacc[m][1], a, b[2], b[3]);
        }
      }
      __syncthreads();
    }
    // ---- 2. dh = g w2[chunk rows, :]^T (the same warp tile) ----
    for (int k = 0; k < NS; ++k, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned b[4];
        ldsm_bt2(b, slab + warp * 16 * SL_LD + kk, SL_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sG + m * 16 * Sh::LN_LD + k * KS + kk, Sh::LN_LD, lane);
          mma16816(dacc[m][0], a, b[0], b[1]);
          mma16816(dacc[m][1], a, b[2], b[3]);
        }
      }
      __syncthreads();
    }
    // ---- 3. h = bf16(gelu(z)), dz = bf16(dh gelu'(z)): to device memory
    // (live rows) and dz to sDZ ----
    const int c0 = chunk * HC;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = warp * 16 + n * 8 + 2 * t;
      const float bb[2] = {b1[c0 + col], b1[c0 + col + 1]};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m * 16 + gq + 8 * hr;
          float hv[2], dv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = zacc[m][n][2 * hr + e] + bb[e];
            const float phi = 0.5f * (1.f + erff(z * SQRT1_2));
            hv[e] = z * phi;
            dv[e] = dacc[m][n][2 * hr + e] *
                    (phi + z * (INV_SQRT_2PI * expf(-0.5f * z * z)));
          }
          const __nv_bfloat162 dz2 = __floats2bfloat162_rn(dv[0], dv[1]);
          *reinterpret_cast<__nv_bfloat162*>(sDZ + row * DZ_LD + col) = dz2;
          if (row < R) {
            const long off = (row0 + row) * hidden + c0 + col;
            *reinterpret_cast<__nv_bfloat162*>(h_out + off) =
                __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(dz_out + off) = dz2;
          }
        }
    }
    // (the barrier of the next slab orders these sDZ writes before run 3)
    // ---- 4. dln += dz w1[:, chunk]^T: slab s gives columns s*128 ..
    // (unrolled: acc's index must be known at compile time to stay in
    // registers) ----
#pragma unroll
    for (int k = 0; k < NS; ++k, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < HC; kk += 16) {
        unsigned b[4];
        ldsm_bt2(b, slab + warp * 16 * SL_LD + kk, SL_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sDZ + m * 16 * DZ_LD + kk, DZ_LD, lane);
          mma16816(acc[m][2 * k], a, b[0], b[1]);
          mma16816(acc[m][2 * k + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();
    }
  }

  // ---- 5. LN backward, dx = bf16(dxf + g), the block's column sums ----
  float mean[MT][2], istd[MT][2], m1[MT][2], m2[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m * 16 + gq + 8 * hr;
      mean[m][hr] = row < R ? sStat[2 * row] : 0.f;
      istd[m][hr] = row < R ? sStat[2 * row + 1] : 0.f;
    }
  // row sums of dxh = dln * lns and of dxh * xhat over the warp's columns,
  // then over the 8 warps through shared memory (the free stage ring)
  float* red = reinterpret_cast<float*>(stage0);     // [WARPS][RT][2]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m * 16 + gq + 8 * hr;
      float s1 = 0.f, s2 = 0.f;
      if (row < R) {
#pragma unroll
        for (int q = 0; q < 2 * NS; ++q) {
          const int col = (q / 2) * KS + warp * 16 + (q % 2) * 8 + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  x + (row0 + row) * C + col));
          const float xh0 = (xv.x - mean[m][hr]) * istd[m][hr];
          const float xh1 = (xv.y - mean[m][hr]) * istd[m][hr];
          const float d0 = acc[m][q][2 * hr] * lns[col];
          const float d1 = acc[m][q][2 * hr + 1] * lns[col + 1];
          s1 += d0 + d1;
          s2 += d0 * xh0 + d1 * xh1;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (t == 0) {
        red[(warp * RT + row) * 2] = s1;
        red[(warp * RT + row) * 2 + 1] = s2;
      }
    }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m * 16 + gq + 8 * hr;
      float s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < WARPS; ++w) {
        s1 += red[(w * RT + row) * 2];
        s2 += red[(w * RT + row) * 2 + 1];
      }
      m1[m][hr] = s1 / C;
      m2[m][hr] = s2 / C;
    }
#pragma unroll
  for (int q = 0; q < 2 * NS; ++q) {
    const int col = (q / 2) * KS + warp * 16 + (q % 2) * 8 + 2 * t;
    float cs[2][2] = {};                           // dln*xhat, dln
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + gq + 8 * hr;
        if (row >= R) continue;
        const long off = (row0 + row) * C + col;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off));
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                sG + row * Sh::LN_LD + col));
        const float xs[2] = {xv.x, xv.y}, gs[2] = {gv.x, gv.y};
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = acc[m][q][2 * hr + e];
          const float xh = (xs[e] - mean[m][hr]) * istd[m][hr];
          const float dxh = dl * lns[col + e];
          out[e] = istd[m][hr] * (dxh - m1[m][hr] - xh * m2[m][hr]) + gs[e];
          cs[0][e] += dl * xh;
          cs[1][e] += dl;
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + off) =
            __floats2bfloat162_rn(out[0], out[1]);
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cs[i][e] += __shfl_xor_sync(0xffffffffu, cs[i][e], o);
    if (gq == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bpart[col + e] = cs[0][e];
        bpart[C + col + e] = cs[1][e];
      }
  }
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

template <int C>
cudaError_t launch(const bf16* x, const bf16* g, const float* lns,
                   const float* lnb, const bf16* w1, const float* b1,
                   const bf16* w2, bf16* dx, bf16* ln, bf16* h, bf16* dz,
                   float* sums, float* part, int rows, int hidden, float eps,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + RT - 1) / RT;
  fused_mlp_bwd_kernel<C><<<blocks, THREADS, smem, stream>>>(
      x, g, lns, lnb, w1, b1, w2, dx, ln, h, dz, part, rows, hidden, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(2 * C + 255) / 256, 256, 0, stream>>>(
      part, blocks, 2 * C, sums);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the first cudaGetLastError() of the two launches (0 on success).
// Arguments are checked by the Python wrapper: rows >= 1, C in {256, 384,
// 512, 768}, hidden a positive multiple of 128, every pointer 32-byte
// aligned.
// sums is float32 [2C]: dlns | dlnb. part is a float32 workspace of
// ceil(rows / 32) * 2C.
int launch_fused_mlp_bwd(const void* x, const void* g, const void* lns,
                         const void* lnb, const void* w1, const void* b1,
                         const void* w2, void* dx, void* ln, void* h,
                         void* dz, void* sums, void* part, int rows, int C,
                         int hidden, float eps, void* stream) {
  if (rows < 1 || hidden <= 0 || hidden % HC != 0)
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,    \
      (const bf16*)w1, (const float*)b1, (const bf16*)w2, (bf16*)dx,       \
      (bf16*)ln, (bf16*)h, (bf16*)dz, (float*)sums, (float*)part, rows,    \
      hidden, eps, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch<256>(ARGS);
    case 384: return (int)launch<384>(ARGS);
    case 512: return (int)launch<512>(ARGS);
    case 768: return (int)launch<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

int mlp_bwd_blocks(int rows) { return (rows + RT - 1) / RT; }

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
