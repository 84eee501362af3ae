// Fused attention residual branch for Hopper (sm_90a):
//
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) )
//
// x is [n_seg, S, C] in bf16; each segment of S tokens attends only within
// itself. Weights are bf16 in (in, out) layout: wqkv [C, 3C] (columns
// q | k | v, head h at h*64), wproj [C, C]. LayerNorm scale/bias and both
// biases are float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_block_kernel,
// driven by _fused_block_impl, in both its instantiations. The inert one:
// the full form (LN + residual) in every release ScaleBlock at S=6, and
// the bare form (use_ln = use_residual = 0) in every PatchBlock at S=50.
// The reg one (fused_attention_residual_reg, pallas_attention.py:1202), as
// runtime arguments of the same kernel: dropout of the softmax
// probabilities (each head's own site, at the global token indices, after
// the float32 softmax and before the bf16 cast for P.V), dropout of the
// proj output at the global row and column, and a LayerScale gamma, in
// that order before the residual (pallas_attention.py:372-384, 426-439);
// the masks come from csrc/dropout_hash.cuh. The legacy family runs it in
// every block: full form S=6 with gamma (and in training both dropouts),
// bare form S=50 in its two region passes (attention dropout in training).
//
// Rounding points are the TPU kernel's: LN output cast to bf16, qkv cast
// after its bias, softmax probabilities cast to bf16, each head's output
// cast to bf16, and proj + bias + residual accumulated in float32 and cast
// once.
//
// Design. One block of 8 warps takes RT / S whole segments, RT = 48 rows
// for S <= 48 (8 segments at S=6, no padding) and 64 rows up to S = 64 (one
// segment at S=50); a ragged last block masks its missing rows itself, and
// nothing is padded in device memory. The block normalises its rows once
// into shared memory, then walks the heads: that head's q | k | v
// [RT, 192] (each warp 24 of the columns), the scores within each segment,
// the softmax and P.V, and the head's output times its 64 rows of wproj
// added into a float32 [RT, C] accumulator held in registers (each warp:
// RT rows x C/8 columns). LN, qkv, the attention output and the proj input
// never touch device memory, and the 230 KB per-segment qkv of S=50 that
// the TPU kept in VMEM is never resident at once. Weights stream through
// shared memory in slabs (wqkv: 128 rows x the head's 192 columns and
// wproj: 32 rows x C beside 48 rows; 64 and 16 rows beside 64) with
// cp.async, double-buffered, so each weight byte crosses L2 once per
// block. The products are mma.sync m16n8k16 (bf16 in, float32 accumulate)
// on operands loaded with ldmatrix.
//
// What bounds it on this card. The work is compute bound (about 2*rows*C*4C
// flops against 2*rows*C*2 bytes of activations), but this kernel is far
// from the tensor-core roof: every block re-reads wqkv and wproj (4.7 MB
// at C=768) from L2, each slab costs two block-wide barriers, and
// mma.sync reaches only part of what wgmma can. At S=50 there is one block
// per segment, so below 132 segments (batch 132) some SMs stay idle. The
// scores run over the whole RT x RT tile though the segments are 6 wide at
// S=6. wgmma with TMA-fed slabs and multicast of slabs over a cluster are
// the next steps.

#include "tile_ops.cuh"

namespace {

constexpr int D = 64;              // head width
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;  // one head's q | k | v, padded
constexpr int O_LD = D + 8;        // bf16 head output
constexpr int QN = 3 * D / 8 / WARPS;   // qkv n8 tiles per warp (3)

// RT rows per block; C = 64 * heads.
template <int RT, int C_>
struct Shape {
  static constexpr int C = C_;
  static constexpr int H = C / D;
  static constexpr int MT = RT / 16;     // m16 row tiles
  static constexpr int NJ = C / 8 / WARPS;   // proj n8 tiles per warp
  // C = 384 (ViT-S, 6 heads): 6 tiles, 48 columns a warp; wqkv slabs
  // tile C as 3 x 128 (RT = 48) or 6 x 64 rows
  static_assert(NJ % 2 == 0, "proj takes its n8 tiles in pairs");
  static_assert(C % (RT == 48 ? 128 : 64) == 0, "wqkv slabs must tile C");
  // wqkv slab: KQ rows x 3*D columns; wproj slab: KP rows x C columns
  static constexpr int KQ = RT == 48 ? 128 : 64;
  static constexpr int KP = RT == 48 ? 32 : 16;
  static constexpr int LN_LD = C + 8;
  static constexpr int S_LD = RT + 4;    // float32 scores
  static constexpr int P_LD = RT + 8;    // bf16 probabilities
  static constexpr int WP_LD = C + 8;
  static constexpr int QSLABS = C / KQ;
  static constexpr int PER_HEAD = QSLABS + D / KP;
  static constexpr int STAGE = (KQ * QKV_LD > KP * WP_LD) ? KQ * QKV_LD
                                                          : KP * WP_LD;
  static constexpr size_t SMEM =
      sizeof(bf16) * (RT * LN_LD + RT * QKV_LD + RT * P_LD + RT * O_LD +
                      2 * STAGE) +
      sizeof(float) * RT * S_LD;
};

// Slab j of head h's weight stream: QSLABS wqkv slabs, then D / KP wproj
// slabs.
template <int RT, int C>
__device__ __forceinline__ void load_slab(bf16* dst, int h, int j,
                                          const bf16* wqkv,
                                          const bf16* wproj) {
  typedef Shape<RT, C> Sh;
  if (j < Sh::QSLABS) {
    const int k0 = j * Sh::KQ;
    for (int i = threadIdx.x; i < Sh::KQ * 3 * (D / 8); i += THREADS) {
      const int row = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
      const int part = rem / (D / 8), seg = rem % (D / 8);
      cp_async16(dst + row * QKV_LD + part * D + seg * 8,
                 wqkv + (long)(k0 + row) * (3 * C) + part * C + h * D +
                     seg * 8);
    }
  } else {
    const int r0 = h * D + (j - Sh::QSLABS) * Sh::KP;
    for (int i = threadIdx.x; i < Sh::KP * (C / 8); i += THREADS) {
      const int row = i / (C / 8), seg = i % (C / 8);
      cp_async16(dst + row * Sh::WP_LD + seg * 8,
                 wproj + (long)(r0 + row) * C + seg * 8);
    }
  }
}

template <int RT, int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_attention_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ lns,
                       const float* __restrict__ lnb,
                       const bf16* __restrict__ wqkv,
                       const float* __restrict__ bqkv,
                       const bf16* __restrict__ wproj,
                       const float* __restrict__ bproj,
                       bf16* __restrict__ out,
                       int n_seg, int S, float scale, float eps, int use_ln,
                       int use_residual, const float* __restrict__ gamma,
                       Drop adrop, Drop pdrop) {
  typedef Shape<RT, C> Sh;
  constexpr int MT = Sh::MT;
  constexpr int NJ = Sh::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLN = reinterpret_cast<bf16*>(smem);
  bf16* sQKV = sLN + RT * Sh::LN_LD;
  bf16* sP = sQKV + RT * QKV_LD;
  bf16* sO = sP + RT * Sh::P_LD;
  bf16* stage0 = sO + RT * O_LD;
  float* sS = reinterpret_cast<float*>(stage0 + 2 * Sh::STAGE);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair

  const int G = RT / S;                      // segments per block
  const int seg0 = blockIdx.x * G;
  const int R = min(G, n_seg - seg0) * S;    // live rows of this block
  const long row0 = (long)seg0 * S;

  constexpr int total = Sh::H * Sh::PER_HEAD;
  load_slab<RT, C>(stage0, 0, 0, wqkv, wproj);
  cp_async_commit();

  // ---- 1. LayerNorm (or a plain copy) of the block's rows into sLN ----
  ln_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, use_ln, sLN, Sh::LN_LD);

  // qkv: warp owns columns [24*warp, 24*warp + 24) of q | k | v, all rows;
  // proj: warp owns output columns [warp*C/8, (warp+1)*C/8), all rows
  float qacc[MT][QN][4];
  float acc[MT][NJ][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_slab<RT, C>(stage0 + ((s + 1) & 1) * Sh::STAGE,
                       (s + 1) / Sh::PER_HEAD, (s + 1) % Sh::PER_HEAD,
                       wqkv, wproj);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* slab = stage0 + (s & 1) * Sh::STAGE;
    const int h = s / Sh::PER_HEAD, j = s % Sh::PER_HEAD;

    if (j < Sh::QSLABS) {
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
        // ---- 3. scores q k^T over the RT x RT tile (float32) ----
        for (int task = warp; task < MT * MT; task += WARPS) {
          const int mt = task % MT, nt = task / MT;   // nt: 16 key columns
          float c[2][4] = {};
#pragma unroll
          for (int k0 = 0; k0 < D; k0 += 16) {
            unsigned a[4], b[4];
            ldsm_a(a, sQKV + mt * 16 * QKV_LD + k0, QKV_LD, lane);
            ldsm_bt2(b, sQKV + nt * 16 * QKV_LD + D + k0, QKV_LD, lane);
            mma16816(c[0], a, b[0], b[1]);
            mma16816(c[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float* d = sS + (mt * 16 + g + 8 * hr) * Sh::S_LD + nt * 16 +
                         n * 8 + 2 * t;
              d[0] = c[n][2 * hr];
              d[1] = c[n][2 * hr + 1];
            }
        }
        __syncthreads();
        // ---- 4. softmax within each row's segment; zeros elsewhere;
        // dropout of head h's probabilities (reg form) ----
        const uint32_t hseed = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
        for (int r = warp; r < RT; r += WARPS) {
          const int c0 = (r / S) * S;
          const bool live = r < R;
          float e[2] = {0.f, 0.f}, sv[2];
          bool in[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = lane + 32 * u;
            in[u] = live && c >= c0 && c < c0 + S;
            sv[u] = in[u] ? sS[r * Sh::S_LD + c] * scale : -CUDART_INF_F;
          }
          float inv = 0.f;
          if (live) {
            const float mx = warp_max(fmaxf(sv[0], sv[1]));
#pragma unroll
            for (int u = 0; u < 2; ++u) e[u] = in[u] ? expf(sv[u] - mx) : 0.f;
            inv = 1.f / warp_sum(e[0] + e[1]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int c = lane + 32 * u;
            if (c < RT) {
              float pv = e[u] * inv;
              if (adrop.on)
                pv = keep_mask(hseed, (uint32_t)(row0 + r),
                               (uint32_t)(row0 + c), adrop.thr)
                         ? pv * adrop.scale
                         : 0.f;
              sP[r * Sh::P_LD + c] = __float2bfloat16(pv);
            }
          }
        }
        __syncthreads();
        // ---- 5. head output P V, cast to bf16 ----
        for (int task = warp; task < MT * (D / 16); task += WARPS) {
          const int mt = task % MT, nt = task / MT;   // nt: 16 head columns
          float c[2][4] = {};
#pragma unroll
          for (int k0 = 0; k0 < RT; k0 += 16) {
            unsigned a[4], b[4];
            ldsm_a(a, sP + mt * 16 * Sh::P_LD + k0, Sh::P_LD, lane);
            ldsm_b2(b, sQKV + k0 * QKV_LD + 2 * D + nt * 16, QKV_LD, lane);
            mma16816(c[0], a, b[0], b[1]);
            mma16816(c[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              *reinterpret_cast<__nv_bfloat162*>(
                  sO + (mt * 16 + g + 8 * hr) * O_LD + nt * 16 + n * 8 +
                  2 * t) = __floats2bfloat162_rn(c[n][2 * hr],
                                                 c[n][2 * hr + 1]);
        }
      }
    } else {
      // ---- 6. acc += O_h[:, KP slice] @ wproj slab ----
      const int ko = (j - Sh::QSLABS) * Sh::KP;
#pragma unroll
      for (int kk = 0; kk < Sh::KP; kk += 16) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_a(a[m], sO + m * 16 * O_LD + ko + kk, O_LD, lane);
#pragma unroll
        for (int n = 0; n < NJ; n += 2) {
          unsigned b[4];
          ldsm_b2(b, slab + kk * Sh::WP_LD + warp * (C / 8) + n * 8,
                  Sh::WP_LD, lane);
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

  // ---- 7. epilogue: + bproj (, proj dropout, * gamma) [+ x], one cast,
  // live rows only ----
  store_rows<C, MT, NJ>(acc, warp * (C / 8), bproj, x, out, row0, R,
                        use_residual, gamma, pdrop);
}

// Rows per block for seg_len S.
int rows_per_block(int S) { return S <= 48 ? 48 : 64; }

template <int RT, int C>
cudaError_t launch(const bf16* x, const float* lns, const float* lnb,
                   const bf16* wqkv, const float* bqkv, const bf16* wproj,
                   const float* bproj, bf16* out, int n_seg, int S,
                   float scale, float eps, int use_ln, int use_residual,
                   const float* gamma, Drop adrop, Drop pdrop,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<RT, C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<RT, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = RT / S;
  const int blocks = (n_seg + G - 1) / G;
  fused_attention_kernel<RT, C><<<blocks, THREADS, smem, stream>>>(
      x, lns, lnb, wqkv, bqkv, wproj, bproj, out, n_seg, S, scale, eps,
      use_ln, use_residual, gamma, adrop, pdrop);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_rows(const bf16* x, const float* lns, const float* lnb,
                        const bf16* wqkv, const float* bqkv,
                        const bf16* wproj, const float* bproj, bf16* out,
                        int n_seg, int S, float scale, float eps, int use_ln,
                        int use_residual, const float* gamma, Drop adrop,
                        Drop pdrop, cudaStream_t stream) {
  if (rows_per_block(S) == 48)
    return launch<48, C>(x, lns, lnb, wqkv, bqkv, wproj, bproj, out, n_seg,
                         S, scale, eps, use_ln, use_residual, gamma, adrop,
                         pdrop, stream);
  return launch<64, C>(x, lns, lnb, wqkv, bqkv, wproj, bproj, out, n_seg, S,
                       scale, eps, use_ln, use_residual, gamma, adrop, pdrop,
                       stream);
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: S in 1..64, C = 64 * num_heads with C in
// {256, 384, 512, 768}, every pointer 32-byte aligned. The reg form: gamma
// float32 [C] or null; seed the int32 dropout seed; attn_thr / proj_thr
// the keep thresholds of the two sites (< 0: that dropout is off) and
// attn_scale / proj_scale their keep scales.
int launch_fused_attention_residual(const void* x, const void* lns,
                                    const void* lnb, const void* wqkv,
                                    const void* bqkv, const void* wproj,
                                    const void* bproj, void* out, int n_seg,
                                    int S, int C, int num_heads, float scale,
                                    float eps, int use_ln, int use_residual,
                                    const void* gamma, int seed, int attn_thr,
                                    float attn_scale, int proj_thr,
                                    float proj_scale, void* stream) {
  if (S < 1 || S > 64 || C != num_heads * D) return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const bf16*)wqkv, \
      (const float*)bqkv, (const bf16*)wproj, (const float*)bproj,        \
      (bf16*)out, n_seg, S, scale, eps, use_ln, use_residual,              \
      (const float*)gamma, make_drop(seed, SITE_ATTN, attn_thr, attn_scale), \
      make_drop(seed, SITE_PROJ, proj_thr, proj_scale), (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_rows<256>(ARGS);
    case 384: return (int)launch_rows<384>(ARGS);
    case 512: return (int)launch_rows<512>(ARGS);
    case 768: return (int)launch_rows<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
