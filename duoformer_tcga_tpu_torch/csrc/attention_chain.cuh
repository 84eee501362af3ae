// The launches the long-segment attention chains share (sm_90a): the
// attention branch's backward at 65..86 tokens a segment
// (csrc/fused_attention_residual_bwd_s86.cu) and the forward and backward at
// 87..197 (csrc/attention_long.cu) run as chains of simple launches over
// chunks of segments, because a segment of that length cannot keep its LN
// tile, its qkv and a float32 row accumulator in one block (see those
// files). This header holds the launches that do not depend on the
// segment length:
//   gemm_kernel          out = A B (+ bias), B as it stands or transposed,
//                        bf16 (cast once) or float32 out;
//   wgrad_kernel         the dw form's out += A^T B, in place;
// the per-chunk scratch, and attention_bwd_chain, the backward's chain
// around an attention-core launch that the including file supplies. The
// rounding points are the TPU kernel's (pallas_attention.py:791-918), as
// set out in csrc/fused_attention_residual_bwd_s86.cu. The chain takes the
// reg form's flags (LayerScale gamma, the attention and proj dropout; the
// 65..86-token chain only): per chunk geff and gm (csrc/reg_grad.cuh)
// feed dattn and the dw form's dwA, the core regenerates the attention
// masks, and dbproj sums the proj-masked g.

#pragma once

#include "chain_rows.cuh"
#include "reg_grad.cuh"

namespace {

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// 2, 3, 5. out [R, N] = A [R, K] . B (+ bias), float32 sums, out bf16 (cast
// once) or float32. B is [K, N] row-major (BT = false) or the transpose of
// a row-major [N, K] matrix (BT = true). 128 x 128 output tiles, 8 warps of
// 32 x 64, K in slabs of 64 through a 3-stage cp.async ring (two blocks an
// SM); K a multiple of 64, at least 128; N a multiple of 128.
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int GEMM_THREADS = 256;
constexpr int A_LD = BK + 8;           // A slab [BM][BK]
constexpr int B_LD = BN + 8;           // B slab [BK][BN]
constexpr int BT_LD = BK + 8;          // B slab [BN][BK] (BT)
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD > BN * BT_LD ? BK * B_LD : BN * BT_LD;
constexpr size_t GEMM_SMEM = sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);

// Slab kt of the block's row tile of A (rows past R read row R - 1, whose
// products are never stored) and of B's column tile.
template <bool BT>
__device__ __forceinline__ void load_gemm_slab(bf16* sA, bf16* sB, int kt,
                                               const bf16* A, const bf16* B,
                                               long rbase, int R, int cbase,
                                               int K, int N) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += GEMM_THREADS) {
    const int row = i / (BK / 8), c8 = i % (BK / 8);
    const long r = rbase + row < R ? rbase + row : (long)R - 1;
    cp_async16(sA + row * A_LD + c8 * 8, A + r * K + kt * BK + c8 * 8);
  }
  if (BT) {
    for (int i = threadIdx.x; i < BN * (BK / 8); i += GEMM_THREADS) {
      const int n = i / (BK / 8), c8 = i % (BK / 8);
      cp_async16(sB + n * BT_LD + c8 * 8,
                 B + (long)(cbase + n) * K + kt * BK + c8 * 8);
    }
  } else {
    for (int i = threadIdx.x; i < BK * (BN / 8); i += GEMM_THREADS) {
      const int k = i / (BN / 8), c8 = i % (BN / 8);
      cp_async16(sB + k * B_LD + c8 * 8,
                 B + (long)(kt * BK + k) * N + cbase + c8 * 8);
    }
  }
}

template <bool BT, bool F32OUT>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, void* __restrict__ out, int R,
            int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = N / BN;
  const long rbase = (long)(blockIdx.x / ntiles) * BM;
  const int cbase = (blockIdx.x % ntiles) * BN;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows x 64 cols
  const int KT = K / BK;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][n][q] = 0.f;

  load_gemm_slab<BT>(sA, sB, 0, A, B, rbase, R, cbase, K, N);
  cp_async_commit();
  load_gemm_slab<BT>(sA + A_STAGE, sB + B_STAGE, 1, A, B, rbase, R, cbase, K,
                     N);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_one();
    __syncthreads();
    if (kt + 2 < KT) {
      const int st = (kt + 2) % STAGES;
      load_gemm_slab<BT>(sA + st * A_STAGE, sB + st * B_STAGE, kt + 2, A, B,
                         rbase, R, cbase, K, N);
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
        if (BT)
          ldsm_bt2(b, b_s + (wn * 64 + nj * 16) * BT_LD + kk, BT_LD, lane);
        else
          ldsm_b2(b, b_s + kk * B_LD + wn * 64 + nj * 16, B_LD, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // ---- epilogue: (+ bias) in float32, one cast or float32, live rows ----
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = cbase + wn * 64 + n * 8 + 2 * t;
    const float bb0 = bias != nullptr ? bias[col] : 0.f;
    const float bb1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long row = rbase + wm * 32 + mi * 16 + g + 8 * hr;
        if (row >= R) continue;
        const float y0 = acc[mi][n][2 * hr] + bb0;
        const float y1 = acc[mi][n][2 * hr + 1] + bb1;
        const long off = row * N + col;
        if (F32OUT)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
              make_float2(y0, y1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
              __floats2bfloat162_rn(y0, y1);
      }
  }
}

// ---------------------------------------------------------------------------
// 4. The attention backward of one (segment, head).
// ---------------------------------------------------------------------------

// A warp's [16, 64] accumulator tile (rows 16 * strip + g (+ 8), columns
// col0 + 8n + 2t (+ 1)) to out [*, ld] at row row0 + ..., bf16, rows below
// S only; red_row (when given) receives the column sums of the rounded
// values over those rows (lanes of g == 0 hold them after the shuffles),
// or adds them to what it holds with accumulate.
__device__ __forceinline__ void store_strip_acc(
    const float (&acc)[8][4], bf16* __restrict__ out, long row0, int strip,
    int S, int ld, int col0, float* red_row, int lane,
    bool accumulate = false) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = strip * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    const __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    const int col = col0 + n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r0) * ld + col) = v0;
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r1) * ld + col) = v1;
    if (red_row != nullptr) {
      const float2 f0 = r0 < S ? __bfloat1622float2(v0) : make_float2(0.f, 0.f);
      const float2 f1 = r1 < S ? __bfloat1622float2(v1) : make_float2(0.f, 0.f);
      float s0 = f0.x + f1.x, s1 = f0.y + f1.y;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        const float a0 = accumulate ? red_row[n * 8 + 2 * t] : 0.f;
        const float a1 = accumulate ? red_row[n * 8 + 2 * t + 1] : 0.f;
        red_row[n * 8 + 2 * t] = a0 + s0;
        red_row[n * 8 + 2 * t + 1] = a1 + s1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 7. The dw form's products: out [M, N] += A^T B over K rows, A [K, M] and
// B [K, N] row-major bf16, float32 sums added to out in place. Two problems
// in one grid (dwqkv, then dwA), 128 x 128 output tiles, K in slabs of 32
// rows through a 3-stage ring; rows past K read as zeros.
// ---------------------------------------------------------------------------

constexpr int WK = 32;
constexpr int WA_LD = BM + 8, WB_LD = BN + 8;
constexpr int WA_STAGE = WK * WA_LD, WB_STAGE = WK * WB_LD;
constexpr size_t WGRAD_SMEM = sizeof(bf16) * STAGES * (WA_STAGE + WB_STAGE);

struct WgradProblem {
  const bf16* A;
  const bf16* B;
  float* out;
  int M, N;
};

__device__ __forceinline__ void load_wgrad_slab(bf16* sA, bf16* sB, int k0,
                                                const WgradProblem& P,
                                                int mbase, int nbase,
                                                int K) {
  for (int i = threadIdx.x; i < WK * (BM / 8); i += GEMM_THREADS) {
    const int k = i / (BM / 8), c8 = i % (BM / 8);
    bf16* d = sA + k * WA_LD + c8 * 8;
    if (k0 + k < K)
      cp_async16(d, P.A + (long)(k0 + k) * P.M + mbase + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < WK * (BN / 8); i += GEMM_THREADS) {
    const int k = i / (BN / 8), c8 = i % (BN / 8);
    bf16* d = sB + k * WB_LD + c8 * 8;
    if (k0 + k < K)
      cp_async16(d, P.B + (long)(k0 + k) * P.N + nbase + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(GEMM_THREADS, 2)
wgrad_kernel(WgradProblem P0, WgradProblem P1, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * WA_STAGE;
  const int tiles0 = (P0.M / BM) * (P0.N / BN);
  const bool second = (int)blockIdx.x >= tiles0;
  const WgradProblem& P = second ? P1 : P0;
  const int tile = second ? blockIdx.x - tiles0 : blockIdx.x;
  const int ntiles = P.N / BN;
  const int mbase = (tile / ntiles) * BM, nbase = (tile % ntiles) * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 x 64
  const int KT = (K + WK - 1) / WK;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][n][q] = 0.f;

  load_wgrad_slab(sA, sB, 0, P, mbase, nbase, K);
  cp_async_commit();
  if (KT > 1) load_wgrad_slab(sA + WA_STAGE, sB + WB_STAGE, WK, P, mbase,
                              nbase, K);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_one();
    __syncthreads();
    if (kt + 2 < KT) {
      const int st = (kt + 2) % STAGES;
      load_wgrad_slab(sA + st * WA_STAGE, sB + st * WB_STAGE, (kt + 2) * WK,
                      P, mbase, nbase, K);
    }
    cp_async_commit();
    const bf16* a_s = sA + (kt % STAGES) * WA_STAGE;
    const bf16* b_s = sB + (kt % STAGES) * WB_STAGE;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_at(a[mi], a_s + kk * WA_LD + wm * 32 + mi * 16, WA_LD, lane);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned b[4];
        ldsm_b2(b, b_s + kk * WB_LD + wn * 64 + nj * 16, WB_LD, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = nbase + wn * 64 + n * 8 + 2 * t;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long row = mbase + wm * 32 + mi * 16 + g + 8 * hr;
        float2* o = reinterpret_cast<float2*>(P.out + row * P.N + col);
        const float2 v = *o;
        *o = make_float2(v.x + acc[mi][n][2 * hr], v.y + acc[mi][n][2 * hr + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// Scratch and the backward's chain of launches
// ---------------------------------------------------------------------------

// The per-chunk scratch of the backward, carved from one buffer (each piece
// 256-byte aligned), for chunks of at most chunk_segs segments; dattn has
// spare_rows rows past the chunk's last segment (never read). geff: the
// reg form's geff (gamma given or the proj dropout on); gm_rows: the dw
// form's gm (the proj dropout on; dw=False writes the caller's). With base
// null only the size is computed.
struct Scratch {
  bf16 *qkv, *dattn, *ln, *attn, *dqkv, *geff, *gm;
  float *dln, *stats, *part_q, *part_r, *chunk_sums;
  size_t bytes;

  Scratch(char* base, int n_seg, int S, int C, bool dw, bool use_ln,
          int chunk_segs, int spare_rows, bool geff_rows = false,
          bool gm_rows = false) {
    const int segs = n_seg < chunk_segs ? n_seg : chunk_segs;
    const long rows = (long)segs * S;
    const int nchunks = (n_seg + chunk_segs - 1) / chunk_segs;
    size_t off = 0;
    auto take = [&](size_t n) -> char* {
      char* p = base == nullptr ? nullptr : base + off;
      off += (n + 255) / 256 * 256;
      return p;
    };
    qkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
    dattn = reinterpret_cast<bf16*>(take(2 * (rows + spare_rows) * C));
    dln = reinterpret_cast<float*>(take(4 * rows * C));
    stats = reinterpret_cast<float*>(take(4 * 2 * rows));
    part_q = reinterpret_cast<float*>(take(4 * (long)segs * 3 * C));
    part_r = reinterpret_cast<float*>(
        take(4 * ((rows + RP_ROWS - 1) / RP_ROWS) * 3 * C));
    chunk_sums = reinterpret_cast<float*>(take(4 * (long)nchunks * 6 * C));
    ln = attn = dqkv = geff = gm = nullptr;
    if (dw) {
      if (use_ln) ln = reinterpret_cast<bf16*>(take(2 * rows * C));
      attn = reinterpret_cast<bf16*>(take(2 * rows * C));
      dqkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
      if (gm_rows) gm = reinterpret_cast<bf16*>(take(2 * rows * C));
    }
    if (geff_rows) geff = reinterpret_cast<bf16*>(take(2 * rows * C));
    bytes = off;
  }
};

template <bool BT, bool F32OUT>
cudaError_t gemm(const bf16* A, const bf16* B, const float* bias, void* out,
                 int R, int K, int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<BT, F32OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const long blocks = (long)((R + BM - 1) / BM) * (N / BN);
  gemm_kernel<BT, F32OUT><<<(unsigned)blocks, GEMM_THREADS, GEMM_SMEM,
                            stream>>>(A, B, bias, out, R, K, N);
  return cudaGetLastError();
}

// The attention branch's backward over chunks of chunk_segs segments (the
// outputs and the dw form as launch_attention_bwd_s86 documents them):
// per chunk LN, qkv = bf16(ln wqkv + bqkv), in the reg form geff and gm,
// dattn = bf16(geff wproj^T) (g where the form is inert), the attention
// core, dln = dqkv wqkv^T in float32, the LN backward by rows, the dw
// form's products (dwA from gm, or g: the caller applies gamma), and the
// chunk's fixed-order sums; then the chunks' sums in order. core(qkv,
// dattn, attn, dqkv, part_q, segments, row0, adrop, stream) launches the
// attention core of one chunk: from its qkv [rows, 3C] and dattn [rows,
// C], attn [rows, C] and dqkv [rows, 3C] out and each segment's column
// sums of dq | dk | dv as one row of part_q [segments, 3C]; row0 is the
// chunk's first global row, where the attention dropout adrop (when on)
// counts its tokens from.
template <int C, class Core>
cudaError_t attention_bwd_chain(
    const bf16* x, const bf16* g, const float* lns, const float* lnb,
    const bf16* wqkv, const float* bqkv, const bf16* wproj, bf16* dx,
    bf16* ln, bf16* attn, bf16* dqkv, float* sums, float* dwqkv, float* dwA,
    char* scratch, int n_seg, int S, int chunk_segs, int spare_rows,
    float eps, int use_ln, int use_residual, Core core, ChainReg reg,
    cudaStream_t stream) {
  const bool dw = dwqkv != nullptr;
  const bool geff = reg.gamma != nullptr || reg.pdrop.on;
  const Scratch sc(scratch, n_seg, S, C, dw, use_ln, chunk_segs, spare_rows,
                   geff, dw && reg.pdrop.on);
  CHAIN_CHECK(cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WGRAD_SMEM));
  const int nchunks = (n_seg + chunk_segs - 1) / chunk_segs;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s0 = ci * chunk_segs;
    const int ns = n_seg - s0 < chunk_segs ? n_seg - s0 : chunk_segs;
    const int rows = ns * S;
    const long r0 = (long)s0 * S;
    const bf16* xc = x + r0 * C;
    const bf16* gc = g + r0 * C;
    bf16* lnc = use_ln ? (dw ? sc.ln : ln + r0 * C) : nullptr;
    const bf16* ain = use_ln ? lnc : xc;  // the bare form's ln is x
    bf16* attnc = dw ? sc.attn : attn + r0 * C;
    bf16* dqkvc = dw ? sc.dqkv : dqkv + r0 * 3 * C;
    // the cotangent proj's transpose takes (geff in the reg form), and
    // dwA's (gm with the proj dropout on, else g: no gamma)
    const bf16* gsrc = gc;
    bf16* gmc = reg.pdrop.on ? (dw ? sc.gm : reg.gm + r0 * C) : nullptr;
    if (geff) {
      CHAIN_CHECK(launch_geff(gc, reg.gamma, reg.pdrop, sc.geff, gmc,
                              (long)rows * C, C, r0, stream));
      gsrc = sc.geff;
    }
    const bf16* gacc = gmc != nullptr ? gmc : gc;
    if (use_ln) {
      ln_stats_kernel<C><<<(rows + 7) / 8, 256, 0, stream>>>(
          xc, lns, lnb, eps, lnc, sc.stats, rows);
      CHAIN_CHECK(cudaGetLastError());
    }
    CHAIN_CHECK((gemm<false, false>(ain, wqkv, bqkv, sc.qkv, rows, C, 3 * C,
                                    stream)));
    CHAIN_CHECK((gemm<true, false>(gsrc, wproj, nullptr, sc.dattn, rows, C,
                                   C, stream)));
    CHAIN_CHECK(core(sc.qkv, sc.dattn, attnc, dqkvc, sc.part_q, ns, r0,
                     reg.adrop, stream));
    CHAIN_CHECK((gemm<true, true>(dqkvc, wqkv, nullptr, sc.dln, rows, 3 * C,
                                  C, stream)));
    const int rb = (rows + RP_ROWS - 1) / RP_ROWS;
    ln_bwd_rows_kernel<C><<<rb, 256, 0, stream>>>(
        sc.dln, xc, gc, lns, sc.stats, dx + r0 * C, sc.part_r, rows, use_ln,
        use_residual, reg.pdrop, r0);
    CHAIN_CHECK(cudaGetLastError());
    if (dw) {
      const WgradProblem p0{ain, dqkvc, dwqkv, C, 3 * C};
      const WgradProblem p1{attnc, gacc, dwA, C, C};
      const int tiles = (C / BM) * (3 * C / BN) + (C / BM) * (C / BN);
      wgrad_kernel<<<tiles, GEMM_THREADS, WGRAD_SMEM, stream>>>(p0, p1, rows);
      CHAIN_CHECK(cudaGetLastError());
    }
    float* row = sc.chunk_sums + (long)ci * 6 * C;
    // dlns | dlnb | dbqkv | dbproj: part_r's dlns, dlnb and dbproj columns
    // around part_q's dbqkv
    CHAIN_CHECK(sum_rows(sc.part_q, ns, 3 * C, row + 2 * C, 3 * C, nullptr,
                         stream));
    CHAIN_CHECK(sum_rows(sc.part_r, rb, 3 * C, row, 2 * C, row + 5 * C,
                         stream));
  }
  return sum_rows(sc.chunk_sums, nchunks, 6 * C, sums, 6 * C, nullptr,
                  stream);
}

}  // namespace
