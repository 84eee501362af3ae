// Fused attention residual branch for segments of 65 to 86 tokens, for
// Hopper (sm_90a), in two launches:
//
//     o = block-diagonal softmax attention( qkv( [LN](x) ) )   (core)
//     y = [x +] proj(o)                                        (proj)
//
// x is [n_seg, S, C] in bf16, 65 <= S <= 86; each segment attends only
// within itself. Weights are bf16 in (in, out) layout: wqkv [C, 3C]
// (columns q | k | v, head h at h*64), wproj [C, C]; LayerNorm scale/bias
// and both biases are float32. o is [n_seg * S, C] in bf16, every head's
// output in its columns.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_block_kernel
// (inert instantiation, driven by _fused_block_impl) at S+1 = 86 tokens a
// segment (_segments_per_tile: one segment a 128-row tile): the full form
// (LN + residual) in every ScaleBlock of the 4-scale release DuoFormer
// (fea_dim 86) and the bare form (use_ln = use_residual = 0). The S <= 64
// forms stay in csrc/fused_attention_residual.cu.
//
// The reg instantiation at 65..86 tokens (fused_attention_residual_reg,
// pallas_attention.py:1202), as runtime arguments: the core drops each
// head's float32 probabilities before their bf16 cast (site 4h at the
// global token indices segment * S + t, :378-383; csrc/strip_attention
// .cuh), and the proj's epilogue takes bias, then the proj dropout at the
// global row and column, then gamma, then the residual, accumulated in
// float32 and cast once (:428-439). The 4-scale release DuoFormer with
// LayerScale and dropout runs it in every ScaleBlock: the core with the
// attention dropout in training, the proj with gamma (Q9: its dropout is
// 0 there; the flag is held by kernel cases alone).
//
// Rounding points are the TPU kernel's: LN output cast to bf16, qkv cast
// after its bias, softmax probabilities cast to bf16, each head's output
// cast to bf16 (so writing o to device memory between the two launches
// moves no rounding point), and proj + bias + residual accumulated in
// float32 and cast once.
//
// Why two launches. A segment must sit whole in one block (its keys span
// all its rows), so a block holds RT = 96 rows (86 rounded up to m16
// tiles). The S <= 64 kernel's single-launch design then needs a float32
// [96, 768] proj accumulator over 256 threads (288 registers a thread,
// limit 255) and 259 KB of shared memory before any weight slab (limit
// 227 KB). So the proj moves to a second kernel and the scores to
// registers:
//
// Core. One block of 8 warps per segment. It normalises its 96 rows (the
// 10 past S are zeros) once into shared memory (96 x 776 bf16, 149 KB),
// then walks the heads: the head's q | k | v [96, 192] (each warp 24 of
// the columns, 72 float32 accumulators a thread) over wqkv slabs of KQ =
// 48 rows (32 when 48 does not divide C) streamed with cp.async,
// double-buffered (2 x 19 KB), cast with its bias into a bf16 tile (96 x
// 200, 38 KB): 221 KB at C = 768. Then warps 0-5 each take one m16 query
// strip (csrc/strip_attention.cuh): scores [16, 96] in 48 float32
// registers, softmax over the quad, P.V from the registers, the head's
// bf16 output over the strip's q, stored to o with 16-byte stores. LN, qkv
// and the scores never touch device memory.
//
// Proj. A plain tiled product y = o wproj + bproj [+ x]: 128 x 128 output
// tiles, 8 warps of 32 x 64 (64 float32 accumulators a thread), K in
// slabs of 64 through a 3-stage cp.async ring (105 KB; two blocks an SM),
// one barrier a slab; the epilogue adds the bias and the residual in
// float32 and casts once. Blocks of one row tile are consecutive, so o's
// rows are read from device memory once and from L2 for the other column
// tiles.
//
// What bounds it on this card. The work is compute bound: 8 R C^2 + 4 R S
// C flops (1.34 TFLOP at 4 scales, B = 64: 1.36 ms at the bf16 peak)
// against 4 R C bytes of x and y, plus 4 R C bytes of o written and read
// back between the launches (0.83 GB, 0.25 ms at 3.35 TB/s). These kernels
// are far from that roof: every core block re-reads wqkv (3.5 MB) from L2,
// each slab costs two block-wide barriers, two of the 8 warps idle in the
// attention, and mma.sync reaches only part of what wgmma can. wgmma with
// TMA-fed slabs, and the proj fused back once its accumulator can live in
// a second block of a cluster, are the next steps.

#include "strip_attention.cuh"

namespace {

constexpr int D = 64;              // head width
constexpr int RT = 96;             // rows per core block: one segment
constexpr int MT = RT / 16;        // m16 row tiles (query strips)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;  // one head's q | k | v, padded
constexpr int QN = 3 * D / 8 / WARPS;   // qkv n8 tiles per warp (3)

template <int C_>
struct CoreShape {
  static constexpr int C = C_;
  static constexpr int H = C / D;
  static constexpr int KQ = C % 48 == 0 ? 48 : 32;   // wqkv slab rows
  static constexpr int QSLABS = C / KQ;
  static constexpr int LN_LD = C + 8;
  static constexpr int STAGE = KQ * QKV_LD;
  static constexpr size_t SMEM =
      sizeof(bf16) * (RT * LN_LD + RT * QKV_LD + 2 * STAGE);
};

// wqkv slab j of head h: rows [j*KQ, (j+1)*KQ), the head's 192 columns.
template <int C>
__device__ __forceinline__ void load_qslab(bf16* dst, int h, int j,
                                           const bf16* wqkv) {
  typedef CoreShape<C> Sh;
  const int k0 = j * Sh::KQ;
  for (int i = threadIdx.x; i < Sh::KQ * 3 * (D / 8); i += THREADS) {
    const int row = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
    const int part = rem / (D / 8), seg = rem % (D / 8);
    cp_async16(dst + row * QKV_LD + part * D + seg * 8,
               wqkv + (long)(k0 + row) * (3 * C) + part * C + h * D +
                   seg * 8);
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
attention_core_s86_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ lns,
                          const float* __restrict__ lnb,
                          const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv,
                          bf16* __restrict__ o, int S, float scale,
                          float eps, int use_ln, Drop adrop) {
  typedef CoreShape<C> Sh;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLN = reinterpret_cast<bf16*>(smem);
  bf16* sQKV = sLN + RT * Sh::LN_LD;
  bf16* stage0 = sQKV + RT * QKV_LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair
  const long row0 = (long)blockIdx.x * S;  // the block's segment
  // the dropout counters' global token index of row 0
  const uint32_t tok0 = (uint32_t)blockIdx.x * (uint32_t)S;

  constexpr int total = Sh::H * Sh::QSLABS;
  load_qslab<C>(stage0, 0, 0, wqkv);
  cp_async_commit();

  // ---- 1. LayerNorm (or a plain copy) of the segment into sLN; rows at
  // or past S are zeros ----
  ln_rows<C, RT, WARPS>(x, row0, S, lns, lnb, eps, use_ln, sLN, Sh::LN_LD);

  // qkv: warp owns columns [24*warp, 24*warp + 24) of q | k | v, all rows
  float qacc[MT][QN][4];
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_qslab<C>(stage0 + ((s + 1) & 1) * Sh::STAGE,
                    (s + 1) / Sh::QSLABS, (s + 1) % Sh::QSLABS, wqkv);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* slab = stage0 + (s & 1) * Sh::STAGE;
    const int h = s / Sh::QSLABS, j = s % Sh::QSLABS;

    // ---- 2. q | k | v of head h, KQ rows of K at a time ----
    if (j == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < QN; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) qacc[m][n][q] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < Sh::KQ; kk += 16) {
      unsigned b01[4], b2[2];
      ldsm_b2(b01, slab + kk * QKV_LD + warp * 24, QKV_LD, lane);
      ldsm_b1(b2, slab + kk * QKV_LD + warp * 24 + 16, QKV_LD, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m * 16 >= S) continue;   // a tile of padding rows only
        unsigned a[4];
        ldsm_a(a, sLN + m * 16 * Sh::LN_LD + j * Sh::KQ + kk, Sh::LN_LD,
               lane);
        mma16816(qacc[m][0], a, b01[0], b01[1]);
        mma16816(qacc[m][1], a, b01[2], b01[3]);
        mma16816(qacc[m][2], a, b2[0], b2[1]);
      }
    }
    if (j == Sh::QSLABS - 1) {
      // + bias, to bf16
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        const int col = warp * 24 + n * 8 + 2 * t;   // within q | k | v
        const int gcol = (col / D) * C + h * D + col % D;
        const float bb0 = bqkv[gcol], bb1 = bqkv[gcol + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = m * 16 + g + 8 * hr;
            *reinterpret_cast<__nv_bfloat162*>(sQKV + row * QKV_LD + col) =
                __floats2bfloat162_rn(qacc[m][n][2 * hr] + bb0,
                                      qacc[m][n][2 * hr + 1] + bb1);
          }
      }
      __syncthreads();
      // ---- 3. attention of head h: one query strip a warp ----
      if (warp < MT && warp * 16 < S) {
        Drop hdrop = adrop;                // head h's site
        hdrop.seed_plus = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
        strip_attention<RT>(sQKV, QKV_LD, warp, S, scale, lane, hdrop, tok0);
        store_strip(sQKV, QKV_LD, warp, S, o, row0, C, h * D, lane);
      }
    }
    __syncthreads();
  }
}

// ---- the proj: y = [x +] gamma * drop(o wproj + bproj) ----

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr size_t PROJ_SMEM = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);

// K slab kt of the block's row tile of o (rows past R read row R - 1,
// whose products are never stored) and of wproj's column tile.
__device__ __forceinline__ void load_proj_slab(bf16* sA, bf16* sB, int kt,
                                               const bf16* o,
                                               const bf16* wproj,
                                               long rbase, int R, int cbase,
                                               int C) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
    const int row = i / (BK / 8), seg = i % (BK / 8);
    const long r = rbase + row < R ? rbase + row : (long)R - 1;
    cp_async16(sA + row * A_LD + seg * 8, o + r * C + kt * BK + seg * 8);
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
    const int row = i / (BN / 8), seg = i % (BN / 8);
    cp_async16(sB + row * B_LD + seg * 8,
               wproj + (long)(kt * BK + row) * C + cbase + seg * 8);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
attention_proj_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ x,
                      const bf16* __restrict__ wproj,
                      const float* __restrict__ bproj,
                      bf16* __restrict__ out, int R, int C,
                      int use_residual, const float* __restrict__ gamma,
                      Drop pdrop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = C / BN;
  const long rbase = (long)(blockIdx.x / ntiles) * BM;
  const int cbase = (blockIdx.x % ntiles) * BN;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows x 64 cols
  const int KT = C / BK;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][n][q] = 0.f;

  load_proj_slab(sA, sB, 0, o, wproj, rbase, R, cbase, C);
  cp_async_commit();
  load_proj_slab(sA + A_STAGE, sB + B_STAGE, 1, o, wproj, rbase, R, cbase,
                 C);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_one();
    __syncthreads();
    if (kt + 2 < KT) {
      const int st = (kt + 2) % STAGES;
      load_proj_slab(sA + st * A_STAGE, sB + st * B_STAGE, kt + 2, o, wproj,
                     rbase, R, cbase, C);
    }
    cp_async_commit();
    const bf16* a_s = sA + (kt % STAGES) * A_STAGE;
    const bf16* b_s = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_a(a[mi], a_s + (wm * 32 + mi * 16) * A_LD + kk, A_LD, lane);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned b[4];
        ldsm_b2(b, b_s + kk * B_LD + wn * 64 + nj * 16, B_LD, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // ---- epilogue: + bproj (, proj dropout at the global row and column,
  // * gamma) [+ x] in float32, one cast, live rows only ----
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = cbase + wn * 64 + n * 8 + 2 * t;
    const float bb0 = bproj[col], bb1 = bproj[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long row = rbase + wm * 32 + mi * 16 + g + 8 * hr;
        if (row >= R) continue;
        float y0 = acc[mi][n][2 * hr] + bb0, y1 = acc[mi][n][2 * hr + 1] + bb1;
        const long off = row * C + col;
        if (pdrop.on) {
          y0 = pdrop.apply(y0, (uint32_t)row, col);
          y1 = pdrop.apply(y1, (uint32_t)row, col + 1);
        }
        if (gamma != nullptr) {
          y0 = __fmul_rn(y0, gamma[col]);
          y1 = __fmul_rn(y1, gamma[col + 1]);
        }
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

template <int C>
cudaError_t launch_core(const bf16* x, const float* lns, const float* lnb,
                        const bf16* wqkv, const float* bqkv, bf16* o,
                        int n_seg, int S, float scale, float eps, int use_ln,
                        Drop adrop, cudaStream_t stream) {
  constexpr size_t smem = CoreShape<C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_s86_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_core_s86_kernel<C><<<n_seg, THREADS, smem, stream>>>(
      x, lns, lnb, wqkv, bqkv, o, S, scale, eps, use_ln, adrop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The core: o [n_seg * S, C] from x [n_seg, S, C]. Returns the launch's
// cudaGetLastError() (0 on success). Arguments are checked by the Python
// wrapper: S in 65..86 (the kernel takes 1..96), C = 64 * num_heads with C
// in {256, 512, 768}, every pointer 32-byte aligned. seed, attn_thr,
// attn_scale: the reg form's attention dropout (attn_thr < 0: off).
int launch_attention_core_s86(const void* x, const void* lns,
                              const void* lnb, const void* wqkv,
                              const void* bqkv, void* o, int n_seg, int S,
                              int C, int num_heads, float scale, float eps,
                              int use_ln, int seed, int attn_thr,
                              float attn_scale, void* stream) {
  if (S < 1 || S > RT || C != num_heads * D) return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const bf16*)wqkv, \
      (const float*)bqkv, (bf16*)o, n_seg, S, scale, eps, use_ln,          \
      make_drop(seed, SITE_ATTN, attn_thr, attn_scale), (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_core<256>(ARGS);
    case 512: return (int)launch_core<512>(ARGS);
    case 768: return (int)launch_core<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The proj: out [rows, C] = [x +] gamma * drop(o wproj + bproj). C a
// multiple of 128. gamma float32 [C] or null; seed, proj_thr, proj_scale:
// the reg form's proj dropout (proj_thr < 0: off).
int launch_attention_proj(const void* o, const void* x, const void* wproj,
                          const void* bproj, void* out, int rows, int C,
                          int use_residual, const void* gamma, int seed,
                          int proj_thr, float proj_scale, void* stream) {
  if (rows < 1 || C % BN != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PROJ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((rows + BM - 1) / BM) * (C / BN);
  attention_proj_kernel<<<(unsigned)blocks, THREADS, PROJ_SMEM,
                          (cudaStream_t)stream>>>(
      (const bf16*)o, (const bf16*)x, (const bf16*)wproj,
      (const float*)bproj, (bf16*)out, rows, C, use_residual,
      (const float*)gamma, make_drop(seed, SITE_PROJ, proj_thr, proj_scale));
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
