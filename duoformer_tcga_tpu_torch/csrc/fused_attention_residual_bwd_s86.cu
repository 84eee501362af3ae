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
// The reg instantiation (_far_reg_bwd, pallas_attention.py:809-822,
// 848-870, 885-905), as runtime arguments of the same chain, for the
// 4-scale release DuoFormer with LayerScale and dropout: per chunk,
// geff_kernel (csrc/reg_grad.cuh) forms geff = bf16(bf16(g * proj mask /
// keep) * gamma), which dattn takes instead of g, and gm = bf16(g * proj
// mask / keep) (the ninth output with dw=False, per-chunk scratch in the
// dw form, whose dwA = attn^T gm, or attn^T g without the proj dropout:
// the caller applies gamma); the core regenerates the forward's attention
// mask of each (segment, head) at the global token indices, drops the
// bf16 p for o and for dv = p^T do, drops and rescales dp, and takes the
// softmax Jacobian with the undropped float32 p; dbproj sums the float32
// proj-masked g without gamma; the residual adds raw g.
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
// segments, each launch simple (all but the core in
// csrc/attention_chain.cuh, which the 87..197-token chain of
// csrc/attention_long.cu shares):
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

#include "attention_chain.cuh"
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

// ---------------------------------------------------------------------------
// 4. The attention backward of one (segment, head).
// ---------------------------------------------------------------------------

// The keep bits of the attention mask over a warp's strip tile [16, RT]:
// bit 4j + q for the accumulator element [j][q], which sits at strip row
// r0 + g (+ 8 for q >= 2) and tile column 8j + 2t (+ 1). The mask is taken
// at (query, key) in global token indices, tok0 + the segment's row: the
// strip's rows are queries (keys with TRANSPOSED), its columns keys
// (queries).
template <bool TRANSPOSED>
__device__ __forceinline__ unsigned long long strip_keep_bits(
    const Drop& d, uint32_t tok0, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  unsigned long long bits = 0ull;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r = tok0 + r0 + g + 8 * (q >> 1);
      const uint32_t c = tok0 + 8 * j + 2 * t + (q & 1);
      if (keep_mask(d.seed_plus, TRANSPOSED ? c : r, TRANSPOSED ? r : c,
                    d.thr))
        bits |= 1ull << (4 * j + q);
    }
  return bits;
}

// v[j][q] dropped with the keep bits of strip_keep_bits, when d is on.
__device__ __forceinline__ float kept(float v, unsigned long long bits,
                                      int bit, const Drop& d) {
  return !d.on ? v : ((bits >> bit) & 1ull) ? v * d.scale : 0.f;
}

__device__ __forceinline__ void drop_bits(float (&v)[NT][4],
                                          unsigned long long bits,
                                          const Drop& d) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) v[j][q] = kept(v[j][q], bits, 4 * j + q, d);
}

// One block per (segment, head): blockIdx.x = segment * H + head. qkv [rows,
// 3C] and dattn [rows, C] of the chunk in; attn [rows, C] and dqkv [rows,
// 3C] out; part [segments, 3C] the block's column sums of dq | dk | dv at
// its head's columns. Warp w takes query strip w, then key strip w. grow0:
// the chunk's first global row; adrop: the reg form's attention dropout
// (its head salt added here; off in the inert form).
__global__ void __launch_bounds__(CORE_THREADS, 2)
attention_bwd_core_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ dattn,
                          bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                          float* __restrict__ part, int H, int S,
                          float scale, long grow0, Drop adrop) {
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
  Drop hdrop = adrop;                      // head h's site
  hdrop.seed_plus = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
  const uint32_t tok0 = (uint32_t)(grow0 + row0);   // the mask's counters

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
    // the forward's mask of the strip (reg form)
    const unsigned long long km =
        hdrop.on ? strip_keep_bits<false>(hdrop, tok0, m * 16, lane) : 0ull;

    // o = bf16(drop(p)) v, to attn
    {
      float o[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) o[n][q] = 0.f;
#pragma unroll
      for (int kb = 0; kb < MT; ++kb) {
        unsigned a[4];
        const int b0 = 8 * kb;   // keep bit of p[2kb][0]
        a[0] = pack_bf16(kept(p[2 * kb][0], km, b0, hdrop),
                         kept(p[2 * kb][1], km, b0 + 1, hdrop));
        a[1] = pack_bf16(kept(p[2 * kb][2], km, b0 + 2, hdrop),
                         kept(p[2 * kb][3], km, b0 + 3, hdrop));
        a[2] = pack_bf16(kept(p[2 * kb + 1][0], km, b0 + 4, hdrop),
                         kept(p[2 * kb + 1][1], km, b0 + 5, hdrop));
        a[3] = pack_bf16(kept(p[2 * kb + 1][2], km, b0 + 6, hdrop),
                         kept(p[2 * kb + 1][3], km, b0 + 7, hdrop));
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
    drop_bits(dp, km, hdrop);   // dp dropped and rescaled (reg form)
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
    const unsigned long long kmt =
        hdrop.on ? strip_keep_bits<true>(hdrop, tok0, kst * 16, lane) : 0ull;
    // dv = bf16(drop(p))^T do
    {
      float dv[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[n][q] = 0.f;
#pragma unroll
      for (int kb = 0; kb < MT; ++kb) {
        unsigned a[4];
        const int b0 = 8 * kb;
        a[0] = pack_bf16(kept(pt[2 * kb][0], kmt, b0, hdrop),
                         kept(pt[2 * kb][1], kmt, b0 + 1, hdrop));
        a[1] = pack_bf16(kept(pt[2 * kb][2], kmt, b0 + 2, hdrop),
                         kept(pt[2 * kb][3], kmt, b0 + 3, hdrop));
        a[2] = pack_bf16(kept(pt[2 * kb + 1][0], kmt, b0 + 4, hdrop),
                         kept(pt[2 * kb + 1][1], kmt, b0 + 5, hdrop));
        a[3] = pack_bf16(kept(pt[2 * kb + 1][2], kmt, b0 + 6, hdrop),
                         kept(pt[2 * kb + 1][3], kmt, b0 + 7, hdrop));
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
      drop_bits(dpt, kmt, hdrop);
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

// The attention core of one chunk (the chain's core launch).
struct S86Core {
  int H, S;
  float scale;
  cudaError_t operator()(const bf16* qkv, const bf16* dattn, bf16* attn,
                         bf16* dqkv, float* part, int ns, long grow0,
                         Drop adrop, cudaStream_t stream) const {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_core_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CORE_SMEM);
    if (err != cudaSuccess) return err;
    attention_bwd_core_kernel<<<ns * H, CORE_THREADS, CORE_SMEM, stream>>>(
        qkv, dattn, attn, dqkv, part, H, S, scale, grow0, adrop);
    return cudaGetLastError();
  }
};

template <int C>
cudaError_t launch(const bf16* x, const bf16* g, const float* lns,
                   const float* lnb, const bf16* wqkv, const float* bqkv,
                   const bf16* wproj, bf16* dx, bf16* ln, bf16* attn,
                   bf16* dqkv, float* sums, float* dwqkv, float* dwA,
                   char* scratch, int n_seg, int S, float scale, float eps,
                   int use_ln, int use_residual, ChainReg reg,
                   cudaStream_t stream) {
  return attention_bwd_chain<C>(x, g, lns, lnb, wqkv, bqkv, wproj, dx, ln,
                                attn, dqkv, sums, dwqkv, dwA, scratch, n_seg,
                                S, CHUNK_SEGS, RT, eps, use_ln, use_residual,
                                S86Core{C / D, S, scale}, reg, stream);
}

}  // namespace

extern "C" {

// The bytes of scratch launch_attention_bwd_s86 needs; geff: gamma given
// or the proj dropout on; proj_drop: the proj dropout on.
long long attention_bwd_s86_scratch_bytes(int n_seg, int S, int C, int dw,
                                          int use_ln, int geff,
                                          int proj_drop) {
  return (long long)Scratch(nullptr, n_seg, S, C, dw != 0, use_ln != 0,
                            CHUNK_SEGS, RT, geff != 0,
                            dw != 0 && proj_drop != 0).bytes;
}

// Returns the first cudaGetLastError() of the chain (0 on success).
// Arguments are checked by the Python wrapper: S in 65..86 (the kernels
// take 1..96), C = 64 * num_heads with C in {256, 512, 768}, n_seg >= 1,
// every pointer 32-byte aligned. ln is null in the bare form; sums is
// float32 [6C]: dlns | dlnb | dbqkv (3C) | dbproj (with the proj dropout
// on, the sum of the float32 proj-masked g). The dw form: dwqkv float32
// [C, 3C] and dwA float32 [C, C], zeroed by the caller, both given (else
// both null); ln, attn, dqkv and gm are then null. The reg form: gamma
// float32 [C] or null; gm bf16 [rows, C], written when the proj dropout is
// on with dw=False (else null); seed, the thresholds (< 0: off) and keep
// scales of the two dropout sites, as the forward took them. scratch: a
// device buffer of attention_bwd_s86_scratch_bytes(n_seg, S, C, dw,
// use_ln, gamma or the proj dropout, the proj dropout), 256-byte aligned.
int launch_attention_bwd_s86(const void* x, const void* g, const void* lns,
                             const void* lnb, const void* wqkv,
                             const void* bqkv, const void* wproj, void* dx,
                             void* ln, void* attn, void* dqkv, void* sums,
                             void* dwqkv, void* dwA, void* scratch,
                             int n_seg, int S, int C, int num_heads,
                             float scale, float eps, int use_ln,
                             int use_residual, const void* gamma, void* gm,
                             int seed, int attn_thr, float attn_scale,
                             int proj_thr, float proj_scale, void* stream) {
  const bool dw = dwqkv != nullptr;
  const ChainReg reg{(const float*)gamma,
                     make_drop(seed, SITE_ATTN, attn_thr, attn_scale),
                     make_drop(seed, SITE_PROJ, proj_thr, proj_scale),
                     (bf16*)gm};
  if (S < 1 || S > RT || C != num_heads * D || n_seg < 1 ||
      (dwqkv == nullptr) != (dwA == nullptr) ||
      (!dw && (attn == nullptr || dqkv == nullptr ||
               (use_ln && ln == nullptr))) ||
      (!dw && reg.pdrop.on) != (gm != nullptr))
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,     \
      (const bf16*)wqkv, (const float*)bqkv, (const bf16*)wproj, (bf16*)dx, \
      (bf16*)ln, (bf16*)attn, (bf16*)dqkv, (float*)sums, (float*)dwqkv,     \
      (float*)dwA, (char*)scratch, n_seg, S, scale, eps, use_ln,            \
      use_residual, reg, (cudaStream_t)stream
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
