// Fused int8 (a8w8) attention residual branch for Hopper (sm_90a):
//
//     y = [x +] proj_q( rowquant( block-diagonal softmax attention(
//             qkv_q( rowquant( [LN](x) ) ) ) ) )
//
// x is [n_seg, S, C] in bf16; each segment of S tokens attends only within
// itself. Weights are int8 in (out, in) layout, K contiguous: wqkv [3C, C]
// (rows q | k | v, head h at h*64), wproj [C, C], each with a float32
// scale per output row; LayerNorm scale/bias and both biases are float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_int8_kernel, driven by fused_attention_residual_int8. Two
// forms run on the int8 serving path: the full form (LN + residual) in
// every ScaleBlock at S=6, and the bare form (use_ln = use_residual = 0)
// in every PatchBlock at S=50.
//
// Rounding points are the TPU kernel's: the LN output (float32, or x) is
// quantized per row; qkv = (float)acc * row scale * column scale + bias
// in float32 and cast to bf16; the softmax probabilities cast to bf16;
// each head's output cast to bf16; the whole o row [C] quantized with one
// scale; y = (float)acc * row scale * column scale + bias [+ x] in
// float32, cast once. Row quantization is amax / 127 with IEEE division
// and roundf (ties away from zero, as jax.lax.round).
//
// Design. One block of 8 warps takes RT / S whole segments, RT = 48 rows
// for S <= 48 (8 segments at S=6) and 64 rows up to S = 64 (one segment at
// S=50); a ragged last block masks its missing rows itself. The block
// quantizes its LN rows once into shared memory (int8 [RT, C]), then walks
// the heads: the head's q | k | v [RT, 192] as int8 x int8 -> int32
// (mma.sync m16n8k32, each warp 24 of the columns) over cp.async slabs of
// the head's 192 weight rows, dequantized with the bias into bf16; the
// scores, softmax and P.V in bf16 m16n8k16 as in the bf16 kernel; the
// head's bf16 output into a [RT, C] tile of every head's o. The proj
// cannot start per head, as the bf16 kernel's does: o is quantized over
// all C columns with one scale per row. So after the last head the block
// takes each row's amax of o, quantizes it into the buffer the LN codes
// held, and only then streams wproj (its slabs overlay the o tile, the
// qkv tile and the qkv slabs, all dead by then) for the int8 proj; at
// RT = 64 in two passes of C/2 output columns, to keep the int32
// accumulator in registers. LN, qkv, o and their codes never touch device
// memory.
//
// What bounds it on this card. The products (2*rows*C*4C int8 operations
// and 4*rows*S*C bf16 flops) bound the work: at S=6, B=64 about 0.045 ms
// at the int8 peak against 58 MB of activations at 0.017 ms. This kernel
// is far from that: every block re-reads wqkv and wproj (2.4 MB at C=768)
// from L2, each slab costs two block-wide barriers, the proj waits for all
// heads with no overlap, and mma.sync reaches only part of what wgmma can.
// At S=50 there is one block per segment, so below 132 segments (batch 132)
// some SMs stay idle. wgmma with TMA-fed slabs are the next steps.

#include "tile_ops.cuh"

namespace {

constexpr int D = 64;              // head width
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;  // one head's bf16 q | k | v, padded
constexpr int QN = 3 * D / 8 / WARPS;   // qkv n8 tiles per warp (3)
constexpr int KP = 64;             // wproj slab: CP rows x KP bytes of K
constexpr int KP_LD = KP + 16;

// RT rows per block; C = 64 * heads.
template <int RT, int C_>
struct Shape {
  static constexpr int C = C_;
  static constexpr int H = C / D;
  static constexpr int MT = RT / 16;     // m16 row tiles
  static constexpr int KQ = RT == 48 ? 128 : 64;   // wqkv slab K bytes
  static constexpr int KQ_LD = KQ + 16;
  static constexpr int NP = RT == 48 ? 1 : 2;      // proj column passes
  static constexpr int CP = C / NP;      // output columns per pass
  static constexpr int NJ = CP / 8 / WARPS;        // proj n8 tiles / warp
  static constexpr int LQ_LD = C + 16;   // int8 codes (LN, then o)
  static constexpr int O_LD = C + 8;     // bf16 o of every head
  static constexpr int S_LD = RT + 4;    // float32 scores; bf16 p aliased
  static constexpr int QSLABS = C / KQ;  // wqkv slabs per head
  static constexpr int PSLABS = C / KP;  // wproj slabs per pass
  static constexpr int QSTAGE = 3 * D * KQ_LD;
  static constexpr int PSTAGE = CP * KP_LD;
  static constexpr int LQ_BYTES = RT * LQ_LD;
  static constexpr int SC_BYTES = 2 * RT * 4;      // LN and o row scales
  static constexpr int O_BYTES = RT * O_LD * 2;
  static constexpr int QKV_BYTES = RT * QKV_LD * 2;
  static constexpr int S_BYTES = RT * S_LD * 4;
  // the attention phase's region; the proj's two slabs overlay it
  static constexpr int A_BYTES = O_BYTES + QKV_BYTES + S_BYTES + 2 * QSTAGE;
  static constexpr int REGION =
      A_BYTES > 2 * PSTAGE ? A_BYTES : 2 * PSTAGE;
  static constexpr size_t SMEM = LQ_BYTES + SC_BYTES + REGION;
};

// wqkv slab j of head h: the head's 192 rows (q, k, v), KQ bytes of K.
template <int RT, int C>
__device__ __forceinline__ void load_qslab(int8_t* dst, int h, int j,
                                           const int8_t* wqkv) {
  typedef Shape<RT, C> Sh;
  constexpr int SEGS = Sh::KQ / 16;
  for (int i = threadIdx.x; i < 3 * D * SEGS; i += THREADS) {
    const int row = i / SEGS, seg = i % SEGS;
    const int part = row / D, rr = row % D;
    cp_async16(dst + row * Sh::KQ_LD + seg * 16,
               wqkv + (long)(part * C + h * D + rr) * C + j * Sh::KQ +
                   seg * 16);
  }
}

// wproj slab t: pass t / PSLABS (CP output rows), K bytes of slab t % PSLABS.
template <int RT, int C>
__device__ __forceinline__ void load_pslab(int8_t* dst, int t,
                                           const int8_t* wproj) {
  typedef Shape<RT, C> Sh;
  constexpr int SEGS = KP / 16;
  const int r0 = (t / Sh::PSLABS) * Sh::CP, k0 = (t % Sh::PSLABS) * KP;
  for (int i = threadIdx.x; i < Sh::CP * SEGS; i += THREADS) {
    const int row = i / SEGS, seg = i % SEGS;
    cp_async16(dst + row * KP_LD + seg * 16,
               wproj + (long)(r0 + row) * C + k0 + seg * 16);
  }
}

template <int RT, int C>
__global__ void __launch_bounds__(THREADS, 1)
fused_attention_int8_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ lns,
                            const float* __restrict__ lnb,
                            const int8_t* __restrict__ wqkv,
                            const float* __restrict__ sqkv,
                            const float* __restrict__ bqkv,
                            const int8_t* __restrict__ wproj,
                            const float* __restrict__ sproj,
                            const float* __restrict__ bproj,
                            bf16* __restrict__ out, int n_seg, int S,
                            float scale, float eps, int use_ln,
                            int use_residual) {
  typedef Shape<RT, C> Sh;
  constexpr int MT = Sh::MT;
  constexpr int NJ = Sh::NJ;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sLQ = reinterpret_cast<int8_t*>(smem);     // LN codes, then o's
  float* sLS = reinterpret_cast<float*>(smem + Sh::LQ_BYTES);
  float* sOS = sLS + RT;
  unsigned char* region = smem + Sh::LQ_BYTES + Sh::SC_BYTES;
  bf16* sO = reinterpret_cast<bf16*>(region);
  bf16* sQKV = reinterpret_cast<bf16*>(region + Sh::O_BYTES);
  float* sS = reinterpret_cast<float*>(region + Sh::O_BYTES + Sh::QKV_BYTES);
  bf16* sP = reinterpret_cast<bf16*>(sS);    // row r inside score row r
  constexpr int P_LD = 2 * Sh::S_LD;
  int8_t* qstage0 = reinterpret_cast<int8_t*>(
      region + Sh::O_BYTES + Sh::QKV_BYTES + Sh::S_BYTES);
  int8_t* pstage0 = reinterpret_cast<int8_t*>(region);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair

  const int G = RT / S;                      // segments per block
  const int seg0 = blockIdx.x * G;
  const int R = min(G, n_seg - seg0) * S;    // live rows of this block
  const long row0 = (long)seg0 * S;

  constexpr int total = Sh::H * Sh::QSLABS;
  load_qslab<RT, C>(qstage0, 0, 0, wqkv);
  cp_async_commit();

  // ---- 1. LayerNorm (or x) of the block's rows, quantized per row ----
  lnq_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, use_ln, sLQ, Sh::LQ_LD,
                         sLS);

  // qkv: warp owns columns [24*warp, 24*warp + 24) of q | k | v, all rows
  int qacc[MT][QN][4];
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total)
      load_qslab<RT, C>(qstage0 + ((s + 1) & 1) * Sh::QSTAGE,
                        (s + 1) / Sh::QSLABS, (s + 1) % Sh::QSLABS, wqkv);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* slab = qstage0 + (s & 1) * Sh::QSTAGE;
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
    for (int kk = 0; kk < Sh::KQ; kk += 32) {
      unsigned b01[4], b2[2];
      ldsm_b8x2(b01, slab + (warp * 24) * Sh::KQ_LD + kk, Sh::KQ_LD, lane);
      ldsm_b8x1(b2, slab + (warp * 24 + 16) * Sh::KQ_LD + kk, Sh::KQ_LD,
                lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned a[4];
        ldsm_a8(a, sLQ + m * 16 * Sh::LQ_LD + j * Sh::KQ + kk, Sh::LQ_LD,
                lane);
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
      // ---- 4. softmax within each row's segment; zeros elsewhere. Row
      // r's bf16 p overwrites the first half of its own score row, so the
      // warp reads the whole row before it writes (__syncwarp) ----
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
        float sum = 1.f;
        if (live) {
          const float mx = warp_max(fmaxf(sv[0], sv[1]));
#pragma unroll
          for (int u = 0; u < 2; ++u) e[u] = in[u] ? expf(sv[u] - mx) : 0.f;
          sum = warp_sum(e[0] + e[1]);
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          if (c < RT) sP[r * P_LD + c] = __float2bfloat16(e[u] / sum);
        }
      }
      __syncthreads();
      // ---- 5. head output P V, cast to bf16, into o's columns of head h
      for (int task = warp; task < MT * (D / 16); task += WARPS) {
        const int mt = task % MT, nt = task / MT;   // nt: 16 head columns
        float c[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < RT; k0 += 16) {
          unsigned a[4], b[4];
          ldsm_a(a, sP + mt * 16 * P_LD + k0, P_LD, lane);
          ldsm_b2(b, sQKV + k0 * QKV_LD + 2 * D + nt * 16, QKV_LD, lane);
          mma16816(c[0], a, b[0], b[1]);
          mma16816(c[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<__nv_bfloat162*>(
                sO + (mt * 16 + g + 8 * hr) * Sh::O_LD + h * D + nt * 16 +
                n * 8 + 2 * t) = __floats2bfloat162_rn(c[n][2 * hr],
                                                       c[n][2 * hr + 1]);
      }
    }
    __syncthreads();
  }

  // ---- 6. o [RT, C] quantized per row over all heads, into sLQ ----
  {
    constexpr int NT = C / 64;
    for (int r = warp; r < RT; r += WARPS) {
      const __nv_bfloat162* src =
          reinterpret_cast<const __nv_bfloat162*>(sO + r * Sh::O_LD);
      float2 v[NT];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        v[i] = __bfloat1622float2(src[lane + 32 * i]);
        amax = fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));
      }
      const float sc = row_scale(warp_max(amax));
      int8_t* dst = sLQ + r * Sh::LQ_LD;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        *reinterpret_cast<char2*>(dst + 2 * (lane + 32 * i)) =
            make_char2(quant8(v[i].x, sc), quant8(v[i].y, sc));
      if (lane == 0) sOS[r] = sc;
    }
  }
  __syncthreads();

  // ---- 7. proj (int8) in NP passes of CP columns; epilogue per pass ----
  // proj: warp owns output columns [warp * CP/8, (warp + 1) * CP/8) of the
  // pass, all rows
  constexpr int ptotal = Sh::NP * Sh::PSLABS;
  int acc[MT][NJ][4];
  load_pslab<RT, C>(pstage0, 0, wproj);
  cp_async_commit();
  for (int s = 0; s < ptotal; ++s) {
    if (s + 1 < ptotal)
      load_pslab<RT, C>(pstage0 + ((s + 1) & 1) * Sh::PSTAGE, s + 1, wproj);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* slab = pstage0 + (s & 1) * Sh::PSTAGE;
    const int ks = s % Sh::PSLABS;
    if (ks == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][n][q] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < KP; kk += 32) {
      unsigned a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_a8(a[m], sLQ + m * 16 * Sh::LQ_LD + ks * KP + kk, Sh::LQ_LD,
                lane);
#pragma unroll
      for (int n = 0; n < NJ; n += 2) {
        unsigned b[4];
        ldsm_b8x2(b, slab + (warp * (Sh::CP / 8) + n * 8) * KP_LD + kk,
                  KP_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16832(acc[m][n], a[m], b[0], b[1]);
          mma16832(acc[m][n + 1], a[m], b[2], b[3]);
        }
      }
    }
    if (ks == Sh::PSLABS - 1)
      store_rows_dq<C, MT, NJ>(
          acc, (s / Sh::PSLABS) * Sh::CP + warp * (Sh::CP / 8), sOS, sproj,
          bproj, x, out, row0, R, use_residual);
    __syncthreads();
  }
}

// Rows per block for seg_len S.
int rows_per_block(int S) { return S <= 48 ? 48 : 64; }

template <int RT, int C>
cudaError_t launch(const bf16* x, const float* lns, const float* lnb,
                   const int8_t* wqkv, const float* sqkv, const float* bqkv,
                   const int8_t* wproj, const float* sproj,
                   const float* bproj, bf16* out, int n_seg, int S,
                   float scale, float eps, int use_ln, int use_residual,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<RT, C>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_int8_kernel<RT, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = RT / S;
  const int blocks = (n_seg + G - 1) / G;
  fused_attention_int8_kernel<RT, C><<<blocks, THREADS, smem, stream>>>(
      x, lns, lnb, wqkv, sqkv, bqkv, wproj, sproj, bproj, out, n_seg, S,
      scale, eps, use_ln, use_residual);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_rows(const bf16* x, const float* lns, const float* lnb,
                        const int8_t* wqkv, const float* sqkv,
                        const float* bqkv, const int8_t* wproj,
                        const float* sproj, const float* bproj, bf16* out,
                        int n_seg, int S, float scale, float eps, int use_ln,
                        int use_residual, cudaStream_t stream) {
  if (rows_per_block(S) == 48)
    return launch<48, C>(x, lns, lnb, wqkv, sqkv, bqkv, wproj, sproj, bproj,
                         out, n_seg, S, scale, eps, use_ln, use_residual,
                         stream);
  return launch<64, C>(x, lns, lnb, wqkv, sqkv, bqkv, wproj, sproj, bproj,
                       out, n_seg, S, scale, eps, use_ln, use_residual,
                       stream);
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: S in 1..64, C = 64 * num_heads with C in
// {256, 512, 768}, every pointer 32-byte aligned.
int launch_fused_attention_residual_int8(
    const void* x, const void* lns, const void* lnb, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, void* out, int n_seg, int S, int C, int num_heads,
    float scale, float eps, int use_ln, int use_residual, void* stream) {
  if (S < 1 || S > 64 || C != num_heads * D) return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const int8_t*)wqkv, \
      (const float*)sqkv, (const float*)bqkv, (const int8_t*)wproj,          \
      (const float*)sproj, (const float*)bproj, (bf16*)out, n_seg, S, scale, \
      eps, use_ln, use_residual, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_rows<256>(ARGS);
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
