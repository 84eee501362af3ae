// Backward of the fused attention residual branch for segments of 65 to 86
// tokens, for Hopper (sm_90a).
//
// The forward (csrc/fused_attention_residual_s86.cu) is
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) ).
// Given x and the upstream gradient g (both [n_seg, S, C] bf16, 65 <= S <=
// 86), this backward gives what the S <= 64 kernel gives
// (csrc/fused_attention_residual_bwd.cu):
//     dx   [n_seg, S, C] bf16   the input cotangent (LN backward, + g)
//     ln   [rows, C]     bf16   the LN output (full form only: the bare
//                               form's ln is x itself)
//     attn [rows, C]     bf16   the attention output, proj's input
//     dqkv [rows, 3C]    bf16   the cotangent of qkv (q | k | v columns)
// and the float32 column sums dlns = sum(dln * xhat), dlnb = sum(dln),
// dbqkv = sum(dqkv), dbproj = sum(g), summed in a fixed order (no atomics).
// dw=False leaves the weight gradients dwqkv = ln^T dqkv and dwproj =
// attn^T g to the caller, as the JAX package leaves them to XLA. The dw
// form writes no row-space tensor to the caller: it forms
//     dwqkv [C, 3C] += ln^T dqkv,   dwA [C, C] += attn^T g   (float32)
// itself, from bounded scratch (below).
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_bwd_kernel with dw=False and with dw=True, driven by
// _fused_block_bwd_impl, at S+1 = 86 tokens a segment: every ScaleBlock of
// the 4-scale release DuoFormer in training (full form), and the bare form
// (use_ln = use_residual = 0). S <= 64 stays in
// csrc/fused_attention_residual_bwd.cu.
//
// Rounding points are the TPU kernel's (pallas_attention.py:791-918): ln
// in bf16; qkv in bf16 after its bias; p in float32 for the softmax
// Jacobian and in bf16 for P.V and dv; each head's output o in bf16; each
// head's slice of dattn = g wproj^T in bf16; ds * scale in bf16; dq, dk, dv
// in bf16; dln = dqkv wqkv^T accumulated in float32 from the bf16 dqkv; the
// LN backward in float32 and dx rounded once. dbqkv sums the rounded dqkv.
//
// Design. A segment's keys span all its rows, so its attention must sit
// whole in one block: RT = 96 rows (86 rounded up to m16 tiles). The S <=
// 64 kernel's one-launch design would then need a float32 [96, C] dln
// accumulator (288 registers a thread at C = 768) beside a 149 KB LN tile,
// the qkv tile and the weight slabs: over the 227 KB a block may hold. So
// the backward runs as a chain of launches over chunks of CHUNK_SEGS
// segments, each launch simple:
//   1. ln_kernel: ln = bf16(LN(x)) and each row's mean and 1/std (full
//      form; the bare form reads x);
//   2. gemm_kernel: qkv = bf16(ln wqkv + bqkv), the forward's qkv;
//   3. gemm_kernel: dattn = bf16(g wproj^T), every head's slice of it;
//   4. attention_bwd_core_kernel, one block per (segment, head): q | k | v
//      and do = dattn[:, head] into shared memory (rows past S zeros);
//      6 warps, one m16 query strip each, recompute the scores, softmax
//      and o in registers (csrc/strip_attention.cuh's layout), write o to
//      attn, then dp = do v^T, the row sums rowsum(dp p), ds and dq = ds k;
//      then one m16 key strip each, p^T and dp^T again from the saved row
//      statistics, dv = p^T do and dk = ds^T q. dq, dk, dv to dqkv; the
//      block's column sums of the rounded dq | dk | dv as one partial row;
//   5. gemm_kernel: dln = dqkv wqkv^T in float32;
//   6. ln_bwd_rows_kernel: the LN backward (row sums of dln * lns and of
//      dln * lns * xhat over whole rows), + g, dx rounded once, and the
//      block's column sums of dln * xhat, dln and g as a partial row;
//   7. dw form only: wgrad_kernel, dwqkv += ln^T dqkv and dwA += attn^T g
//      over the chunk's rows, one block per 128 x 128 output tile,
//      accumulating in place (the chunks run in stream order, so the sums
//      are reproducible);
//   8. sum_rows_kernel: the partial rows of the chunk in order, then the
//      chunks' rows in order.
// qkv, dattn and dln live in per-chunk scratch; dw=False writes ln, attn
// and dqkv straight into the caller's outputs, the dw form into per-chunk
// scratch, so its extra device memory is bounded by the chunk (about 384 MB
// at C = 768, S = 86) whatever the batch.
//
// Padding. Rows S..95 of a core block are zeros in q | k | v and in do.
// Keys past S are masked out of the scores; a padding query row has do = 0,
// so its dp, its row sum and its ds are 0 and it adds nothing to any dk or
// dv. No row past S is stored or summed.
//
// Layouts. wqkv [C, 3C] and wproj [C, C] come as the forward takes them,
// the JAX package's (in, out) layout: gemm_kernel reads B either as it
// stands ([K, N], the qkv product) or as the transpose of a row-major [N,
// K] matrix (dattn = g wproj^T, dln = dqkv wqkv^T), with ldmatrix .trans
// or without.
//
// What bounds it on this card. About 2 R C (3C + C + 3C) flops of products
// for qkv, dattn and dln, 12 R S C for the attention, and the dw form's 8 R
// C^2 more, against 2 R C (3 + 1 + 1 + 3 + 1) bytes of activations in and
// out: compute bound (at R = 539,392 rows, C = 768: 4.88 TFLOP, 4.94 ms at
// the bf16 peak). This chain is far from that: qkv, dattn and dln go
// through device memory (about 6 R C bytes more each way), the products
// run on mma.sync from cp.async slabs, and the dw products take 144 blocks
// per chunk. wgmma with TMA-fed slabs and the qkv recompute and dln
// product back on chip once a cluster's blocks can share the LN tile are
// the next steps.

#include "strip_attention.cuh"

namespace {

constexpr int D = 64;                  // head width
constexpr int RT = 96;                 // rows of a core block: one segment
constexpr int MT = RT / 16;            // m16 strips (queries or keys)
constexpr int NT = RT / 8;             // n8 tiles of a strip's scores
constexpr int CORE_WARPS = MT;         // one warp a strip
constexpr int CORE_THREADS = CORE_WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;      // the head's q | k | v
constexpr int DO_LD = D + 8;           // its do
constexpr size_t CORE_SMEM =
    sizeof(bf16) * (RT * QKV_LD + RT * DO_LD) +
    sizeof(float) * (3 * RT + 3 * CORE_WARPS * D);
constexpr int CHUNK_SEGS = 264;        // segments a chunk (2 x 132 SMs)

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// 1. LayerNorm rows: ln = bf16(LN(x)), stats[2r] = mean, stats[2r + 1] =
// 1/sqrt(var + eps) (float32, two-pass variance: ln_rows' arithmetic). One
// warp a row.
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(256)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
          const float* __restrict__ lnb, float eps, bf16* __restrict__ ln,
          float* __restrict__ stats, int rows) {
  constexpr int NP = C / 64;           // bf16 pairs a lane
  const int lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const __nv_bfloat162* src =
      reinterpret_cast<const __nv_bfloat162*>(x + r * C);
  float2 v[NP];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    v[i] = __bfloat1622float2(src[lane + 32 * i]);
    sum += v[i].x + v[i].y;
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float a = v[i].x - mean, b = v[i].y - mean;
    sq += a * a + b * b;
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  if (lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = inv;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ln + r * C);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = 2 * (lane + 32 * i);
    dst[lane + 32 * i] = __floats2bfloat162_rn(
        (v[i].x - mean) * inv * lns[c] + lnb[c],
        (v[i].y - mean) * inv * lns[c + 1] + lnb[c + 1]);
  }
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

// A warp's [16, D] accumulator tile (rows 16 * strip + g (+ 8), columns
// col0 + 8n + 2t (+ 1)) to out [*, ld] at row row0 + ..., bf16, rows below
// S only; red_row (when given) receives the column sums of the rounded
// values over those rows (lanes of g == 0 hold them after the shuffles).
__device__ __forceinline__ void store_strip_acc(
    const float (&acc)[D / 8][4], bf16* __restrict__ out, long row0,
    int strip, int S, int ld, int col0, float* red_row, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = strip * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
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
        red_row[n * 8 + 2 * t] = s0;
        red_row[n * 8 + 2 * t + 1] = s1;
      }
    }
  }
}

// One block per (segment, head): blockIdx.x = segment * H + head. qkv [rows,
// 3C] and dattn [rows, C] of the chunk in; attn [rows, C] and dqkv [rows,
// 3C] out; part [segments, 3C] the block's column sums of dq | dk | dv at
// its head's columns. Warp w takes query strip w, then key strip w.
__global__ void __launch_bounds__(CORE_THREADS, 2)
attention_bwd_core_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ dattn,
                          bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                          float* __restrict__ part, int H, int S,
                          float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQKV = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQKV + RT * QKV_LD;
  float* sMax = reinterpret_cast<float*>(sDO + RT * DO_LD);  // scaled max
  float* sSum = sMax + RT;                                    // sum of exp
  float* sRs = sSum + RT;                                     // sum(dp p)
  float* red = sRs + RT;                 // [3][CORE_WARPS][D]: dq, dk, dv

  const int C = H * D;
  const int seg = blockIdx.x / H, h = blockIdx.x % H;
  const long row0 = (long)seg * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair

  // ---- the head's q | k | v and do; rows at or past S are zeros ----
  for (int i = threadIdx.x; i < RT * 3 * (D / 8); i += CORE_THREADS) {
    const int r = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
    const int pp = rem / (D / 8), c8 = rem % (D / 8);
    bf16* d = sQKV + r * QKV_LD + pp * D + c8 * 8;
    if (r < S)
      cp_async16(d, qkv + (row0 + r) * (3 * C) + pp * C + h * D + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < RT * (D / 8); i += CORE_THREADS) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    bf16* d = sDO + r * DO_LD + c8 * 8;
    if (r < S)
      cp_async16(d, dattn + (row0 + r) * C + h * D + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ---- the query strip: p, o, dp, rowsum(dp p), ds, dq ----
  {
    const int m = warp;
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      unsigned a[4];
      ldsm_a(a, sQKV + m * 16 * QKV_LD + k0, QKV_LD, lane);
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        unsigned b[4];
        ldsm_bt2(b, sQKV + nt * 16 * QKV_LD + D + k0, QKV_LD, lane);
        mma16816(p[2 * nt], a, b[0], b[1]);
        mma16816(p[2 * nt + 1], a, b[2], b[3]);
      }
    }
    // softmax over the live keys of rows g (q = 0, 1) and g + 8 (q = 2, 3)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 8 * j + 2 * t + (q & 1);
        p[j][q] = col < S ? __fmul_rn(p[j][q], scale) : -CUDART_INF_F;
        mx[q >> 1] = fmaxf(mx[q >> 1], p[j][q]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = 8 * j + 2 * t + (q & 1);
        p[j][q] = col < S ? expf(__fsub_rn(p[j][q], mx[q >> 1])) : 0.f;
        sum[q >> 1] += p[j][q];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[j][q] = p[j][q] / sum[q >> 1];

    // o = bf16(p) v, to attn
    {
      float o[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) o[n][q] = 0.f;
#pragma unroll
      for (int kb = 0; kb < MT; ++kb) {
        unsigned a[4];
        a[0] = pack_bf16(p[2 * kb][0], p[2 * kb][1]);
        a[1] = pack_bf16(p[2 * kb][2], p[2 * kb][3]);
        a[2] = pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]);
        a[3] = pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3]);
#pragma unroll
        for (int nt = 0; nt < D / 16; ++nt) {
          unsigned b[4];
          ldsm_b2(b, sQKV + kb * 16 * QKV_LD + 2 * D + nt * 16, QKV_LD, lane);
          mma16816(o[2 * nt], a, b[0], b[1]);
          mma16816(o[2 * nt + 1], a, b[2], b[3]);
        }
      }
      store_strip_acc(o, attn, row0, m, S, C, h * D, nullptr, lane);
    }

    // dp = do v^T (float32)
    float dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dp[j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      unsigned a[4];
      ldsm_a(a, sDO + m * 16 * DO_LD + k0, DO_LD, lane);
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        unsigned b[4];
        ldsm_bt2(b, sQKV + nt * 16 * QKV_LD + 2 * D + k0, QKV_LD, lane);
        mma16816(dp[2 * nt], a, b[0], b[1]);
        mma16816(dp[2 * nt + 1], a, b[2], b[3]);
      }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) rs[q >> 1] += dp[j][q] * p[j][q];
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + g + 8 * hr;
        sMax[row] = mx[hr];
        sSum[row] = sum[hr];
        sRs[row] = rs[hr];
      }
    // ds = p (dp - rowsum(dp p)) * scale, bf16, as A fragments
    unsigned ds[MT][4];
#pragma unroll
    for (int kb = 0; kb < MT; ++kb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kb + half;
        ds[kb][2 * half] = pack_bf16(p[j][0] * (dp[j][0] - rs[0]) * scale,
                                     p[j][1] * (dp[j][1] - rs[0]) * scale);
        ds[kb][2 * half + 1] =
            pack_bf16(p[j][2] * (dp[j][2] - rs[1]) * scale,
                      p[j][3] * (dp[j][3] - rs[1]) * scale);
      }
    // dq = ds k
    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) dq[n][q] = 0.f;
#pragma unroll
    for (int kb = 0; kb < MT; ++kb)
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        unsigned b[4];
        ldsm_b2(b, sQKV + kb * 16 * QKV_LD + D + nt * 16, QKV_LD, lane);
        mma16816(dq[2 * nt], ds[kb], b[0], b[1]);
        mma16816(dq[2 * nt + 1], ds[kb], b[2], b[3]);
      }
    store_strip_acc(dq, dqkv, row0, m, S, 3 * C, h * D,
                    red + (0 * CORE_WARPS + warp) * D, lane);
  }
  __syncthreads();                       // the row statistics are complete

  // ---- the key strip: p^T, dv = p^T do, dp^T, ds^T, dk = ds^T q ----
  {
    const int kst = warp;
    // pt[j][q]: key kst * 16 + g (+ 8 for q >= 2), query 8j + 2t + (q & 1)
    float pt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) pt[j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      unsigned a[4];
      ldsm_a(a, sQKV + kst * 16 * QKV_LD + D + k0, QKV_LD, lane);
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        unsigned b[4];
        ldsm_bt2(b, sQKV + nt * 16 * QKV_LD + k0, QKV_LD, lane);
        mma16816(pt[2 * nt], a, b[0], b[1]);
        mma16816(pt[2 * nt + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = kst * 16 + g + 8 * (q >> 1);
        const int qi = 8 * j + 2 * t + (q & 1);
        pt[j][q] = key < S ? expf(__fsub_rn(__fmul_rn(pt[j][q], scale),
                                            sMax[qi])) / sSum[qi]
                           : 0.f;
      }
    // dv = bf16(p)^T do
    {
      float dv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[n][q] = 0.f;
#pragma unroll
      for (int kb = 0; kb < MT; ++kb) {
        unsigned a[4];
        a[0] = pack_bf16(pt[2 * kb][0], pt[2 * kb][1]);
        a[1] = pack_bf16(pt[2 * kb][2], pt[2 * kb][3]);
        a[2] = pack_bf16(pt[2 * kb + 1][0], pt[2 * kb + 1][1]);
        a[3] = pack_bf16(pt[2 * kb + 1][2], pt[2 * kb + 1][3]);
#pragma unroll
        for (int nt = 0; nt < D / 16; ++nt) {
          unsigned b[4];
          ldsm_b2(b, sDO + kb * 16 * DO_LD + nt * 16, DO_LD, lane);
          mma16816(dv[2 * nt], a, b[0], b[1]);
          mma16816(dv[2 * nt + 1], a, b[2], b[3]);
        }
      }
      store_strip_acc(dv, dqkv, row0, kst, S, 3 * C, 2 * C + h * D,
                      red + (2 * CORE_WARPS + warp) * D, lane);
    }
    // dp^T = v do^T, then ds^T = p^T (dp^T - rowsum(dp p)) * scale
    unsigned dst[MT][4];
    {
      float dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) dpt[j][q] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        unsigned a[4];
        ldsm_a(a, sQKV + kst * 16 * QKV_LD + 2 * D + k0, QKV_LD, lane);
#pragma unroll
        for (int nt = 0; nt < MT; ++nt) {
          unsigned b[4];
          ldsm_bt2(b, sDO + nt * 16 * DO_LD + k0, DO_LD, lane);
          mma16816(dpt[2 * nt], a, b[0], b[1]);
          mma16816(dpt[2 * nt + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kb = 0; kb < MT; ++kb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kb + half;
          const float r0 = sRs[8 * j + 2 * t], r1 = sRs[8 * j + 2 * t + 1];
          dst[kb][2 * half] =
              pack_bf16(pt[j][0] * (dpt[j][0] - r0) * scale,
                        pt[j][1] * (dpt[j][1] - r1) * scale);
          dst[kb][2 * half + 1] =
              pack_bf16(pt[j][2] * (dpt[j][2] - r0) * scale,
                        pt[j][3] * (dpt[j][3] - r1) * scale);
        }
    }
    // dk = ds^T q
    float dk[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) dk[n][q] = 0.f;
#pragma unroll
    for (int kb = 0; kb < MT; ++kb)
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        unsigned b[4];
        ldsm_b2(b, sQKV + kb * 16 * QKV_LD + nt * 16, QKV_LD, lane);
        mma16816(dk[2 * nt], dst[kb], b[0], b[1]);
        mma16816(dk[2 * nt + 1], dst[kb], b[2], b[3]);
      }
    store_strip_acc(dk, dqkv, row0, kst, S, 3 * C, C + h * D,
                    red + (1 * CORE_WARPS + warp) * D, lane);
  }
  __syncthreads();

  // ---- the block's column sums of dq | dk | dv, warps in order ----
  for (int c = threadIdx.x; c < 3 * D; c += CORE_THREADS) {
    const int which = c / D, col = c % D;
    float s = 0.f;
    for (int w = 0; w < CORE_WARPS; ++w)
      s += red[(which * CORE_WARPS + w) * D + col];
    part[(long)seg * (3 * C) + which * C + h * D + col] = s;
  }
}

// ---------------------------------------------------------------------------
// 6. The LN backward by rows: dx = 1/std (dxh - mean(dxh) - xhat
// mean(dxh xhat)) [+ g], dxh = dln * lns (full form), or dln [+ g] (bare);
// rounded once. part [blocks, 3C]: the block's column sums of dln * xhat,
// dln (zeros in the bare form) and g.
// ---------------------------------------------------------------------------

constexpr int RP_ROWS = 32;

template <int C>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const float* __restrict__ dln, const bf16* __restrict__ x,
                   const bf16* __restrict__ g, const float* __restrict__ lns,
                   const float* __restrict__ stats, bf16* __restrict__ dx,
                   float* __restrict__ part, int rows, int use_ln,
                   int use_residual) {
  __shared__ float sRow[RP_ROWS][4];     // mean, 1/std, m1, m2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r0 = (long)blockIdx.x * RP_ROWS;
  const int R = (int)min((long)RP_ROWS, rows - r0);
  if (use_ln) {
    for (int r = warp; r < R; r += 8) {
      const long base = (r0 + r) * C;
      const float mean = stats[2 * (r0 + r)], istd = stats[2 * (r0 + r) + 1];
      float s1 = 0.f, s2 = 0.f;
      for (int c = 2 * lane; c < C; c += 64) {
        const float2 d = *reinterpret_cast<const float2*>(dln + base + c);
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + base + c));
        const float d0 = d.x * lns[c], d1 = d.y * lns[c + 1];
        s1 += d0 + d1;
        s2 += d0 * ((xv.x - mean) * istd) + d1 * ((xv.y - mean) * istd);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        sRow[r][0] = mean;
        sRow[r][1] = istd;
        sRow[r][2] = s1 / C;
        sRow[r][3] = s2 / C;
      }
    }
  }
  __syncthreads();
  float* bpart = part + (long)blockIdx.x * 3 * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * 256) {
    float cs[3][2] = {};                   // dln * xhat, dln, g
    for (int r = 0; r < R; ++r) {
      const long off = (r0 + r) * C + c;
      const float2 d = *reinterpret_cast<const float2*>(dln + off);
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + off));
      const float dl[2] = {d.x, d.y}, gg[2] = {gv.x, gv.y};
      float out[2];
      if (use_ln) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off));
        const float xs[2] = {xv.x, xv.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = (xs[e] - sRow[r][0]) * sRow[r][1];
          const float dxh = dl[e] * lns[c + e];
          out[e] = sRow[r][1] * (dxh - sRow[r][2] - xh * sRow[r][3]);
          cs[0][e] += dl[e] * xh;
          cs[1][e] += dl[e];
        }
      } else {
        out[0] = dl[0];
        out[1] = dl[1];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (use_residual) out[e] += gg[e];
        cs[2][e] += gg[e];
      }
      *reinterpret_cast<__nv_bfloat162*>(dx + off) =
          __floats2bfloat162_rn(out[0], out[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bpart[c + e] = cs[0][e];
      bpart[C + c + e] = cs[1][e];
      bpart[2 * C + c + e] = cs[2][e];
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
// 8. out[j] = sum over b < nb of part[b * width + j], in order of b; column
// j goes to out_lo[j] below split, else to out_hi[j - split].
// ---------------------------------------------------------------------------

__global__ void sum_rows_kernel(const float* __restrict__ part, int nb,
                                int width, float* __restrict__ out_lo,
                                int split, float* __restrict__ out_hi) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[(long)b * width + j];
  if (j < split)
    out_lo[j] = s;
  else
    out_hi[j - split] = s;
}

// ---------------------------------------------------------------------------
// Scratch and the chain of launches
// ---------------------------------------------------------------------------

// The per-chunk scratch, carved from one buffer (each piece 256-byte
// aligned). With base null only the size is computed.
struct Scratch {
  bf16 *qkv, *dattn, *ln, *attn, *dqkv;
  float *dln, *stats, *part_q, *part_r, *chunk_sums;
  size_t bytes;

  Scratch(char* base, int n_seg, int S, int C, bool dw, bool use_ln) {
    const int segs = n_seg < CHUNK_SEGS ? n_seg : CHUNK_SEGS;
    const long rows = (long)segs * S;
    const int nchunks = (n_seg + CHUNK_SEGS - 1) / CHUNK_SEGS;
    size_t off = 0;
    auto take = [&](size_t n) -> char* {
      char* p = base == nullptr ? nullptr : base + off;
      off += (n + 255) / 256 * 256;
      return p;
    };
    qkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
    // RT spare rows past the chunk's last segment (never read)
    dattn = reinterpret_cast<bf16*>(take(2 * (rows + RT) * C));
    dln = reinterpret_cast<float*>(take(4 * rows * C));
    stats = reinterpret_cast<float*>(take(4 * 2 * rows));
    part_q = reinterpret_cast<float*>(take(4 * (long)segs * 3 * C));
    part_r = reinterpret_cast<float*>(
        take(4 * ((rows + RP_ROWS - 1) / RP_ROWS) * 3 * C));
    chunk_sums = reinterpret_cast<float*>(take(4 * (long)nchunks * 6 * C));
    ln = attn = dqkv = nullptr;
    if (dw) {
      if (use_ln) ln = reinterpret_cast<bf16*>(take(2 * rows * C));
      attn = reinterpret_cast<bf16*>(take(2 * rows * C));
      dqkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
    }
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

cudaError_t sum_rows(const float* part, int nb, int width, float* out_lo,
                     int split, float* out_hi, cudaStream_t stream) {
  sum_rows_kernel<<<(width + 255) / 256, 256, 0, stream>>>(
      part, nb, width, out_lo, split, out_hi);
  return cudaGetLastError();
}

#define CHECK(expr)                         \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

template <int C>
cudaError_t launch(const bf16* x, const bf16* g, const float* lns,
                   const float* lnb, const bf16* wqkv, const float* bqkv,
                   const bf16* wproj, bf16* dx, bf16* ln, bf16* attn,
                   bf16* dqkv, float* sums, float* dwqkv, float* dwA,
                   char* scratch, int n_seg, int S, float scale, float eps,
                   int use_ln, int use_residual, cudaStream_t stream) {
  constexpr int H = C / D;
  const bool dw = dwqkv != nullptr;
  const Scratch sc(scratch, n_seg, S, C, dw, use_ln);
  CHECK(cudaFuncSetAttribute(attention_bwd_core_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)CORE_SMEM));
  CHECK(cudaFuncSetAttribute(wgrad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WGRAD_SMEM));
  const int nchunks = (n_seg + CHUNK_SEGS - 1) / CHUNK_SEGS;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s0 = ci * CHUNK_SEGS;
    const int ns = n_seg - s0 < CHUNK_SEGS ? n_seg - s0 : CHUNK_SEGS;
    const int rows = ns * S;
    const long r0 = (long)s0 * S;
    const bf16* xc = x + r0 * C;
    const bf16* gc = g + r0 * C;
    bf16* lnc = use_ln ? (dw ? sc.ln : ln + r0 * C) : nullptr;
    const bf16* ain = use_ln ? lnc : xc;  // the bare form's ln is x
    bf16* attnc = dw ? sc.attn : attn + r0 * C;
    bf16* dqkvc = dw ? sc.dqkv : dqkv + r0 * 3 * C;
    if (use_ln) {
      ln_kernel<C><<<(rows + 7) / 8, 256, 0, stream>>>(xc, lns, lnb, eps, lnc,
                                                        sc.stats, rows);
      CHECK(cudaGetLastError());
    }
    CHECK((gemm<false, false>(ain, wqkv, bqkv, sc.qkv, rows, C, 3 * C,
                              stream)));
    CHECK((gemm<true, false>(gc, wproj, nullptr, sc.dattn, rows, C, C,
                             stream)));
    attention_bwd_core_kernel<<<ns * H, CORE_THREADS, CORE_SMEM, stream>>>(
        sc.qkv, sc.dattn, attnc, dqkvc, sc.part_q, H, S, scale);
    CHECK(cudaGetLastError());
    CHECK((gemm<true, true>(dqkvc, wqkv, nullptr, sc.dln, rows, 3 * C, C,
                            stream)));
    const int rb = (rows + RP_ROWS - 1) / RP_ROWS;
    ln_bwd_rows_kernel<C><<<rb, 256, 0, stream>>>(
        sc.dln, xc, gc, lns, sc.stats, dx + r0 * C, sc.part_r, rows, use_ln,
        use_residual);
    CHECK(cudaGetLastError());
    if (dw) {
      const WgradProblem p0{ain, dqkvc, dwqkv, C, 3 * C};
      const WgradProblem p1{attnc, gc, dwA, C, C};
      const int tiles = (C / BM) * (3 * C / BN) + (C / BM) * (C / BN);
      wgrad_kernel<<<tiles, GEMM_THREADS, WGRAD_SMEM, stream>>>(p0, p1, rows);
      CHECK(cudaGetLastError());
    }
    float* row = sc.chunk_sums + (long)ci * 6 * C;
    // dlns | dlnb | dbqkv | dbproj: part_r's dlns, dlnb and dbproj columns
    // around part_q's dbqkv
    CHECK(sum_rows(sc.part_q, ns, 3 * C, row + 2 * C, 3 * C, nullptr,
                   stream));
    CHECK(sum_rows(sc.part_r, rb, 3 * C, row, 2 * C, row + 5 * C, stream));
  }
  return sum_rows(sc.chunk_sums, nchunks, 6 * C, sums, 6 * C, nullptr,
                  stream);
}

#undef CHECK

}  // namespace

extern "C" {

// The bytes of scratch launch_attention_bwd_s86 needs.
long long attention_bwd_s86_scratch_bytes(int n_seg, int S, int C, int dw,
                                          int use_ln) {
  return (long long)Scratch(nullptr, n_seg, S, C, dw != 0, use_ln != 0).bytes;
}

// Returns the first cudaGetLastError() of the chain (0 on success).
// Arguments are checked by the Python wrapper: S in 65..86 (the kernels
// take 1..96), C = 64 * num_heads with C in {256, 512, 768}, n_seg >= 1,
// every pointer 32-byte aligned. ln is null in the bare form; sums is
// float32 [6C]: dlns | dlnb | dbqkv (3C) | dbproj. The dw form: dwqkv
// float32 [C, 3C] and dwA float32 [C, C], zeroed by the caller, both given
// (else both null); ln, attn and dqkv are then null. scratch: a device
// buffer of attention_bwd_s86_scratch_bytes(n_seg, S, C, dw, use_ln),
// 256-byte aligned.
int launch_attention_bwd_s86(const void* x, const void* g, const void* lns,
                             const void* lnb, const void* wqkv,
                             const void* bqkv, const void* wproj, void* dx,
                             void* ln, void* attn, void* dqkv, void* sums,
                             void* dwqkv, void* dwA, void* scratch,
                             int n_seg, int S, int C, int num_heads,
                             float scale, float eps, int use_ln,
                             int use_residual, void* stream) {
  const bool dw = dwqkv != nullptr;
  if (S < 1 || S > RT || C != num_heads * D || n_seg < 1 ||
      (dwqkv == nullptr) != (dwA == nullptr) ||
      (!dw && (attn == nullptr || dqkv == nullptr ||
               (use_ln && ln == nullptr))))
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,     \
      (const bf16*)wqkv, (const float*)bqkv, (const bf16*)wproj, (bf16*)dx, \
      (bf16*)ln, (bf16*)attn, (bf16*)dqkv, (float*)sums, (float*)dwqkv,     \
      (float*)dwA, (char*)scratch, n_seg, S, scale, eps, use_ln,            \
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
