// Fused int8 (a8w8) attention residual branch for segments of 65 to 86
// tokens, for Hopper (sm_90a), in two launches:
//
//     o = block-diagonal softmax attention( qkv_q( rowquant( [LN](x) ) ) )
//     y = [x +] proj_q( rowquant(o) )
//
// x is [n_seg, S, C] in bf16, 65 <= S <= 86; each segment attends only
// within itself. Weights are int8 in (out, in) layout, K contiguous: wqkv
// [3C, C] (rows q | k | v, head h at h*64), wproj [C, C], each with a
// float32 scale per output row; LayerNorm scale/bias and both biases are
// float32. o is [n_seg * S, C] in bf16, every head's output in its
// columns.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_int8_kernel, driven by fused_attention_residual_int8, at
// S+1 = 86 tokens a segment (its "<=86-token segments"): the full form in
// every ScaleBlock of the 4-scale release DuoFormer served in int8, and
// the bare form (use_ln = use_residual = 0). The S <= 64 forms stay in
// csrc/fused_attention_residual_int8.cu.
//
// Rounding points are the TPU kernel's: the LN output (float32, or x) is
// quantized per row; qkv = (float)acc * row scale * column scale + bias
// in float32 and cast to bf16; the softmax probabilities cast to bf16;
// each head's output cast to bf16 (o in device memory between the
// launches moves no rounding point); the whole o row [C] quantized with
// one scale; y = (float)acc * row scale * column scale + bias [+ x] in
// float32, cast once. Row quantization is amax / 127 with IEEE division
// and roundf (ties away from zero, as jax.lax.round).
//
// Why two launches. A segment sits whole in a block of RT = 96 rows (86
// rounded up to m16 tiles). The S <= 64 kernel's single-launch design
// keeps every head's o in shared memory until the row scale over all C
// is known: int8 LN codes (74 KB) + the o tile [96, 776] bf16 (149 KB) +
// the head's q | k | v (38 KB) + the scores, about 320 KB against the
// 227 KB a block may have. So o goes to device memory and the proj, whose
// row quantization needs the whole row, to a second kernel:
//
// Core. One block of 8 warps per segment quantizes its 96 LN rows (rows
// past S are zeros of scale 1) once into shared memory (int8 [96, 784],
// 75 KB), then walks the heads: the head's q | k | v [96, 192] as int8 x
// int8 -> int32 (mma.sync m16n8k32, each warp 24 of the columns) over
// cp.async slabs of the head's 192 weight rows x 128 bytes of K
// (double-buffered, 2 x 27 KB), dequantized with the bias into a bf16
// tile (38 KB): 169 KB. Then warps 0-5 each take one m16 query strip
// (csrc/strip_attention.cuh: scores and probabilities in registers) and
// store the head's bf16 output to o.
//
// Proj. One block of 8 warps per 128 rows of y. It reads its rows of o
// once (one warp a row, 4 rows in flight: the amax over C, then the
// codes; IEEE division per element, so once matters) into shared memory
// (int8 [128, 784], 100 KB, with the row scales), then takes the output
// columns 128 at a time: wproj's 128 output rows streamed in slabs of 128
// bytes of K through a 3-stage cp.async ring (54 KB), 8 warps of 32 x 64
// int32 accumulators (m16n8k32), and the epilogue of the column tile,
// dequantized with the bias [+ x] in float32 and cast once.
//
// What bounds it on this card. The products bound the work: 8 R C^2 int8
// operations and 4 R S C bf16 flops (0.72 ms at 4 scales, B = 64, at the
// int8 and bf16 peaks) against 4 R C bytes of x and y plus 4 R C bytes of
// o between the launches (0.25 ms at 3.35 TB/s). These kernels are far
// from that: every core block re-reads wqkv (1.8 MB) from L2, each slab
// costs two block-wide barriers, two of the 8 warps idle in the
// attention, every proj block re-reads wproj (0.6 MB) from L2 and stalls
// on its epilogue between column tiles, and mma.sync reaches only part of
// what wgmma can.

#include "strip_attention.cuh"

namespace {

constexpr int D = 64;              // head width
constexpr int RT = 96;             // rows per core block: one segment
constexpr int MT = RT / 16;        // m16 row tiles (query strips)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;  // one head's bf16 q | k | v, padded
constexpr int QN = 3 * D / 8 / WARPS;   // qkv n8 tiles per warp (3)
constexpr int KQ = 128;            // wqkv slab: 192 rows x KQ bytes of K
constexpr int KQ_LD = KQ + 16;
constexpr int QSTAGE = 3 * D * KQ_LD;

template <int C_>
struct CoreShape {
  static constexpr int C = C_;
  static constexpr int H = C / D;
  static constexpr int QSLABS = C / KQ;   // wqkv slabs per head
  static constexpr int LQ_LD = C + 16;    // int8 LN codes
  static constexpr int LQ_BYTES = RT * LQ_LD;
  static constexpr int QKV_BYTES = RT * QKV_LD * 2;
  static constexpr size_t SMEM =
      LQ_BYTES + RT * 4 + QKV_BYTES + 2 * QSTAGE;
};

// wqkv slab j of head h: the head's 192 rows (q, k, v), KQ bytes of K.
template <int C>
__device__ __forceinline__ void load_qslab(int8_t* dst, int h, int j,
                                           const int8_t* wqkv) {
  constexpr int SEGS = KQ / 16;
  for (int i = threadIdx.x; i < 3 * D * SEGS; i += THREADS) {
    const int row = i / SEGS, seg = i % SEGS;
    const int part = row / D, rr = row % D;
    cp_async16(dst + row * KQ_LD + seg * 16,
               wqkv + (long)(part * C + h * D + rr) * C + j * KQ + seg * 16);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attention_core_int8_s86_kernel(const bf16* __restrict__ x,
                               const float* __restrict__ lns,
                               const float* __restrict__ lnb,
                               const int8_t* __restrict__ wqkv,
                               const float* __restrict__ sqkv,
                               const float* __restrict__ bqkv,
                               bf16* __restrict__ o, int S, float scale,
                               float eps, int use_ln) {
  typedef CoreShape<C> Sh;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sLQ = reinterpret_cast<int8_t*>(smem);
  float* sLS = reinterpret_cast<float*>(smem + Sh::LQ_BYTES);
  bf16* sQKV = reinterpret_cast<bf16*>(smem + Sh::LQ_BYTES + RT * 4);
  int8_t* qstage0 = reinterpret_cast<int8_t*>(
      smem + Sh::LQ_BYTES + RT * 4 + Sh::QKV_BYTES);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair
  const long row0 = (long)blockIdx.x * S;  // the block's segment

  constexpr int total = Sh::H * Sh::QSLABS;
  load_qslab<C>(qstage0, 0, 0, wqkv);
  cp_async_commit();

  // ---- 1. LayerNorm (or x) of the segment, quantized per row ----
  lnq_rows<C, RT, WARPS>(x, row0, S, lns, lnb, eps, use_ln, sLQ, Sh::LQ_LD,
                         sLS);

  // qkv: warp owns columns [24*warp, 24*warp + 24) of q | k | v, all rows
  int qacc[MT][QN][4];
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_qslab<C>(qstage0 + ((s + 1) & 1) * QSTAGE, (s + 1) / Sh::QSLABS,
                    (s + 1) % Sh::QSLABS, wqkv);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* slab = qstage0 + (s & 1) * QSTAGE;
    const int h = s / Sh::QSLABS, j = s % Sh::QSLABS;

    // ---- 2. q | k | v of head h, KQ bytes of K at a time (int32) ----
    if (j == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < QN; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) qacc[m][n][q] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < KQ; kk += 32) {
      unsigned b01[4], b2[2];
      ldsm_b8x2(b01, slab + (warp * 24) * KQ_LD + kk, KQ_LD, lane);
      ldsm_b8x1(b2, slab + (warp * 24 + 16) * KQ_LD + kk, KQ_LD, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m * 16 >= S) continue;   // a tile of padding rows only
        unsigned a[4];
        ldsm_a8(a, sLQ + m * 16 * Sh::LQ_LD + j * KQ + kk, Sh::LQ_LD, lane);
        mma16832(qacc[m][0], a, b01[0], b01[1]);
        mma16832(qacc[m][1], a, b01[2], b01[3]);
        mma16832(qacc[m][2], a, b2[0], b2[1]);
      }
    }
    if (j == Sh::QSLABS - 1) {
      // dequantize + bias, to bf16
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        const int col = warp * 24 + n * 8 + 2 * t;   // within q | k | v
        const int gcol = (col / D) * C + h * D + col % D;
        const float cs0 = sqkv[gcol], cs1 = sqkv[gcol + 1];
        const float bb0 = bqkv[gcol], bb1 = bqkv[gcol + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = m * 16 + g + 8 * hr;
            *reinterpret_cast<__nv_bfloat162*>(sQKV + row * QKV_LD + col) =
                __floats2bfloat162_rn(
                    dequant(qacc[m][n][2 * hr], sLS[row], cs0, bb0),
                    dequant(qacc[m][n][2 * hr + 1], sLS[row], cs1, bb1));
          }
      }
      __syncthreads();
      // ---- 3. attention of head h: one query strip a warp ----
      if (warp < MT && warp * 16 < S) {
        strip_attention<RT>(sQKV, QKV_LD, warp, S, scale, lane);
        store_strip(sQKV, QKV_LD, warp, S, o, row0, C, h * D, lane);
      }
    }
    __syncthreads();
  }
}

// ---- the proj: y = dequant(rowquant(o) wproj^T) + bproj [+ x] ----

constexpr int BM = 128, BN = 128, BK = 128, STAGES = 3;
constexpr int RPW = 4;             // rows a warp quantizes at once
constexpr int B_LD = BK + 16;
constexpr int B_STAGE = BN * B_LD;

template <int C>
struct ProjShape {
  static constexpr int A_LD = C + 16;     // int8 codes of o's rows
  static constexpr int A_BYTES = BM * A_LD;
  static constexpr size_t SMEM = A_BYTES + BM * 4 + STAGES * B_STAGE;
};

// Slab s of wproj: column tile s / KT (BN output rows), bytes of K of
// slab s % KT.
template <int C>
__device__ __forceinline__ void load_pslab(int8_t* dst, int s,
                                           const int8_t* wproj) {
  constexpr int KT = C / BK;
  const int r0 = (s / KT) * BN, k0 = (s % KT) * BK;
  for (int i = threadIdx.x; i < BN * (BK / 16); i += THREADS) {
    const int row = i / (BK / 16), seg = i % (BK / 16);
    cp_async16(dst + row * B_LD + seg * 16,
               wproj + (long)(r0 + row) * C + k0 + seg * 16);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attention_proj_int8_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ x,
                           const int8_t* __restrict__ wproj,
                           const float* __restrict__ sproj,
                           const float* __restrict__ bproj,
                           bf16* __restrict__ out, int R, int use_residual) {
  typedef ProjShape<C> Sh;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  float* sAS = reinterpret_cast<float*>(smem + Sh::A_BYTES);
  int8_t* sB = reinterpret_cast<int8_t*>(smem + Sh::A_BYTES + BM * 4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int KT = C / BK;                 // K slabs per column tile
  constexpr int total = (C / BN) * KT;
  const long rbase = (long)blockIdx.x * BM;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows x 64 cols

  load_pslab<C>(sB, 0, wproj);
  cp_async_commit();
  load_pslab<C>(sB + B_STAGE, 1, wproj);
  cp_async_commit();

  // ---- 1. the tile's rows of o quantized over all C, once (one warp a
  // row, RPW rows at once so that their loads are in flight together;
  // rows past R are zeros of scale 1) ----
  {
    constexpr int NT = C / 64;
    for (int r0 = warp * RPW; r0 < BM; r0 += WARPS * RPW) {
      float2 v[RPW][NT];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const long row = rbase + r0 + u < R ? rbase + r0 + u : (long)R - 1;
        const __nv_bfloat162* src =
            reinterpret_cast<const __nv_bfloat162*>(o + row * C);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          v[u][i] = __bfloat1622float2(src[lane + 32 * i]);
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const bool live = rbase + r0 + u < R;
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          amax = fmaxf(amax, fmaxf(fabsf(v[u][i].x), fabsf(v[u][i].y)));
        const float sc = live ? row_scale(warp_max(amax)) : 1.f;
        int8_t* dst = sA + (r0 + u) * Sh::A_LD;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          *reinterpret_cast<char2*>(dst + 2 * (lane + 32 * i)) =
              live ? make_char2(quant8(v[u][i].x, sc), quant8(v[u][i].y, sc))
                   : make_char2(0, 0);
        if (lane == 0) sAS[r0 + u] = sc;
      }
    }
  }

  // ---- 2. each column tile in turn: the int8 product over its K
  // slabs, then its epilogue ----
  int acc[2][8][4];
  for (int s = 0; s < total; ++s) {
    cp_async_wait_one();
    __syncthreads();
    if (s + 2 < total)
      load_pslab<C>(sB + ((s + 2) % STAGES) * B_STAGE, s + 2, wproj);
    cp_async_commit();
    const int8_t* b_s = sB + (s % STAGES) * B_STAGE;
    const int kt = s % KT;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][n][q] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_a8(a[mi], sA + (wm * 32 + mi * 16) * Sh::A_LD + kt * BK + kk,
                Sh::A_LD, lane);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned b[4];
        ldsm_b8x2(b, b_s + (wn * 64 + nj * 16) * B_LD + kk, B_LD, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16832(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16832(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (kt != KT - 1) continue;
    // ---- 3. epilogue of column tile s / KT: dequantize + bproj [+ x]
    // in float32, one cast ----
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = (s / KT) * BN + wn * 64 + n * 8 + 2 * t;
      const float cs0 = sproj[col], cs1 = sproj[col + 1];
      const float bb0 = bproj[col], bb1 = bproj[col + 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rl = wm * 32 + mi * 16 + g + 8 * hr;
          const long row = rbase + rl;
          if (row >= R) continue;
          float y0 = dequant(acc[mi][n][2 * hr], sAS[rl], cs0, bb0);
          float y1 = dequant(acc[mi][n][2 * hr + 1], sAS[rl], cs1, bb1);
          const long off = row * C + col;
          if (use_residual) {
            const float2 r2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + off));
            y0 += r2.x;
            y1 += r2.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + off) =
              __floats2bfloat162_rn(y0, y1);
        }
    }
  }
}

template <int C>
cudaError_t launch_core(const bf16* x, const float* lns, const float* lnb,
                        const int8_t* wqkv, const float* sqkv,
                        const float* bqkv, bf16* o, int n_seg, int S,
                        float scale, float eps, int use_ln,
                        cudaStream_t stream) {
  constexpr size_t smem = CoreShape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_int8_s86_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_core_int8_s86_kernel<C><<<n_seg, THREADS, smem, stream>>>(
      x, lns, lnb, wqkv, sqkv, bqkv, o, S, scale, eps, use_ln);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_proj(const bf16* o, const bf16* x, const int8_t* wproj,
                        const float* sproj, const float* bproj, bf16* out,
                        int rows, int use_residual, cudaStream_t stream) {
  constexpr size_t smem = ProjShape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attention_proj_int8_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long blocks = (rows + BM - 1) / BM;
  attention_proj_int8_kernel<C><<<(unsigned)blocks, THREADS, smem, stream>>>(
      o, x, wproj, sproj, bproj, out, rows, use_residual);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The core: o [n_seg * S, C] from x [n_seg, S, C]. Returns the launch's
// cudaGetLastError() (0 on success). Arguments are checked by the Python
// wrapper: S in 65..86 (the kernel takes 1..96), C = 64 * num_heads with C
// in {256, 512, 768}, every pointer 32-byte aligned.
int launch_attention_core_int8_s86(const void* x, const void* lns,
                                   const void* lnb, const void* wqkv,
                                   const void* sqkv, const void* bqkv,
                                   void* o, int n_seg, int S, int C,
                                   int num_heads, float scale, float eps,
                                   int use_ln, void* stream) {
  if (S < 1 || S > RT || C != num_heads * D) return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const int8_t*)wqkv, \
      (const float*)sqkv, (const float*)bqkv, (bf16*)o, n_seg, S, scale,    \
      eps, use_ln, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_core<256>(ARGS);
    case 512: return (int)launch_core<512>(ARGS);
    case 768: return (int)launch_core<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The proj: out [rows, C] = dequant(rowquant(o) wproj^T) + bproj [+ x].
int launch_attention_proj_int8(const void* o, const void* x,
                               const void* wproj, const void* sproj,
                               const void* bproj, void* out, int rows, int C,
                               int use_residual, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
#define ARGS                                                            \
  (const bf16*)o, (const bf16*)x, (const int8_t*)wproj,                 \
      (const float*)sproj, (const float*)bproj, (bf16*)out, rows,       \
      use_residual, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_proj<256>(ARGS);
    case 512: return (int)launch_proj<512>(ARGS);
    case 768: return (int)launch_proj<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
