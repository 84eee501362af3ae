// The attention branch for segments of 87 to 197 tokens, forward and
// backward, and the block-diagonal attention op from 65 tokens, for Hopper
// (sm_90a).
//
// The branch is
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) )
// over x [n_seg, S, C] in bf16; each segment attends only within itself.
// Weights are bf16 in (in, out) layout: wqkv [C, 3C] (columns q | k | v,
// head h at h*64), wproj [C, C]; LayerNorm scale/bias and biases float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py
//   * _kernel (#10, driven by _block_attention_impl): the block-diagonal
//     attention op, o = softmax(q k^T * scale) v within each segment, at
//     65 <= S <= 197 (S <= 64 stays in csrc/block_diag_attention.cu);
//   * _fused_block_kernel (#1, inert, driven by _fused_block_impl) at 87 <=
//     S <= 197: every block of the ViT-B/16 baseline (models/vit.py,
//     S = 197 = 196 patches + CLS, one segment a 128-row tile in
//     _segments_per_tile), full form (LN + residual) and bare form;
//   * _fused_block_bwd_kernel (#4, inert, dw=False and dw=True, driven by
//     _fused_block_bwd_impl) at the same lengths.
// The proj of the forward is csrc/fused_attention_residual_s86.cu's
// attention_proj launch, which takes any row count.
//
// Rounding points are the TPU kernel's: ln in bf16; qkv in bf16 after its
// bias; scores in float32 times scale; the softmax exp(s - rowmax) /
// rowsum in float32; the normalised p cast to bf16 for P.V (and for dv),
// p in float32 in the softmax Jacobian; P.V accumulated in float32 and
// each head's output cast once; in the backward each head's slice of
// dattn = g wproj^T in bf16, ds * scale, dq, dk, dv in bf16, dln in
// float32 and dx rounded once. (FlashAttention's online softmax casts the
// unnormalised exp and divides afterwards: another rounding point, not
// used here.)
//
// Design. A segment's keys span all its rows, so one segment's attention
// sits in one block: RTL = 208 rows (197 rounded up to m16 strips, 13 of
// them). A strip's scores over 208 keys would take 104 float32 registers a
// thread, and the backward needs dp beside them: over the 255-register
// limit with the accumulators. So the cores walk the keys in tiles of KT =
// 64, and recompute the scores where a later pass needs them:
//   forward core: one block of 8 warps per (segment, head), its q | k | v
//     [208, 192] in shared memory (83 KB, two blocks an SM); each warp takes
//     query strips w, w + 8: a pass for the row max, a pass for the row
//     sum of exp(s - max), and a pass forming the normalised p, cast to
//     bf16, times v;
//   backward core: one block of 8 warps per (segment, head), q | k | v and
//     do in shared memory (122 KB). Query strips: the row max and sum as
//     in the forward; a pass for o (to attn), dp = do v^T and rowsum(dp p);
//     a pass for ds = p (dp - rowsum) * scale and dq = ds k. Then key
//     strips: p^T and dp^T again from the saved row statistics, dv = p^T do
//     and dk = ds^T q.
// Padding rows S..207 of a block are zeros in q | k | v and in do. Keys at
// or past S are masked out of the scores; a padding query row has do = 0,
// so its dp, its row sum and its ds are 0 and it adds nothing to dk or dv;
// no row past S is stored or summed.
// A segment of 197 rows cannot keep its LN tile in a block (208 x 776 bf16
// is 323 KB against 227 KB), so ln and qkv pass through device memory:
// the forward runs over chunks of segments (at most CHUNK_ROWS rows) as
// ln_kernel, the tiled qkv product and the core; the backward is
// csrc/attention_chain.cuh's chain around the backward core. Writing ln
// and qkv moves no rounding point. Chunks bound the scratch: the dw form's
// at S = 197 is about 380 MB at C = 768, whatever the batch.
//
// What bounds it on this card. The forward branch does 8 R C^2 + 4 R S C
// flops (at n_seg 128, S = 197: 0.134 TFLOP, 0.136 ms at the bf16 peak)
// against 4 R C bytes of x and y: compute bound; the core alone moves 8 R
// C bytes for 4 R S C flops, bound by its bytes. The backward: 14 R C^2 +
// 12 R S C flops, 8 R C^2 more in the dw form. These kernels are far from
// that roof: mma.sync from cp.async slabs, ln and qkv through device
// memory, the scores computed three times in the forward and four in the
// backward's query pass, and 13 strips over 8 warps. wgmma and a cluster
// sharing a segment's LN tile are the next steps.

#include "attention_chain.cuh"
#include "strip_attention.cuh"

namespace {

constexpr int D = 64;                  // head width
constexpr int RTL = 208;               // rows of a core block: one segment
constexpr int KT = 64;                 // keys (or queries) a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;      // the head's q | k | v
constexpr int DO_LD = D + 8;           // its do
constexpr size_t FWD_SMEM = sizeof(bf16) * RTL * QKV_LD;
constexpr size_t BWD_SMEM =
    sizeof(bf16) * (RTL * QKV_LD + RTL * DO_LD) +
    sizeof(float) * (3 * RTL + 3 * WARPS * D);
constexpr int CHUNK_ROWS = 22704;      // rows a chunk at most (264 x 86)

// Segments a chunk: as many as CHUNK_ROWS rows hold, spread evenly over
// the chunks.
int chunk_segs(int n_seg, int S) {
  const int most = CHUNK_ROWS / S > 0 ? CHUNK_ROWS / S : 1;
  const int nchunks = (n_seg + most - 1) / most;
  return nchunks > 0 ? (n_seg + nchunks - 1) / nchunks : 1;
}

// The head's q | k | v [S16, 192] of one segment into sQKV (rows at or past
// S zeros); with do, also its do [S16, 64] into sDO.
__device__ __forceinline__ void load_head(bf16* sQKV, bf16* sDO,
                                          const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ dattn,
                                          long row0, int S, int S16, int C,
                                          int h) {
  for (int i = threadIdx.x; i < S16 * 3 * (D / 8); i += THREADS) {
    const int r = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
    const int pp = rem / (D / 8), c8 = rem % (D / 8);
    bf16* d = sQKV + r * QKV_LD + pp * D + c8 * 8;
    if (r < S)
      cp_async16(d, qkv + (row0 + r) * (3 * C) + pp * C + h * D + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
  if (sDO == nullptr) return;
  for (int i = threadIdx.x; i < S16 * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    bf16* d = sDO + r * DO_LD + c8 * 8;
    if (r < S)
      cp_async16(d, dattn + (row0 + r) * C + h * D + c8 * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// s [16, 16 * nsub] = A B^T in float32 for a strip of A (16 rows at a,
// row-major, lda, 64 columns) and a tile of B (rows at b, ldb, 64
// columns): s[j][q] is row g (q < 2) or g + 8, column 8j + 2t + (q & 1) of
// the tile; n16 blocks at or past nsub stay 0.
__device__ __forceinline__ void tile_products(float (&s)[8][4], const bf16* a,
                                              int lda, const bf16* b,
                                              int ldb, int nsub, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    unsigned af[4];
    ldsm_a(af, a + k0, lda, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < nsub) {
        unsigned bf[4];
        ldsm_bt2(bf, b + nt * 16 * ldb + k0, ldb, lane);
        mma16816(s[2 * nt], af, bf[0], bf[1]);
        mma16816(s[2 * nt + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// acc [16, 64] += bf16(p) B for p [16, 16 * nsub] in the tile_products
// layout and B's rows at b (row-major, ldb, 64 columns): p cast to bf16 as
// the A fragments.
__device__ __forceinline__ void tile_accumulate(float (&acc)[8][4],
                                                const float (&p)[8][4],
                                                const bf16* b, int ldb,
                                                int nsub, int lane) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    if (kb < nsub) {
      unsigned a[4];
      a[0] = pack_bf16(p[2 * kb][0], p[2 * kb][1]);
      a[1] = pack_bf16(p[2 * kb][2], p[2 * kb][3]);
      a[2] = pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]);
      a[3] = pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3]);
#pragma unroll
      for (int nt = 0; nt < D / 16; ++nt) {
        unsigned bf[4];
        ldsm_b2(bf, b + kb * 16 * ldb + nt * 16, ldb, lane);
        mma16816(acc[2 * nt], a, bf[0], bf[1]);
        mma16816(acc[2 * nt + 1], a, bf[2], bf[3]);
      }
    }
  }
}

// Keys at or past S (the block's padding rows) are masked out.
__device__ __forceinline__ bool live_key(int key, int S) { return key < S; }

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
}

// The scores of query strip m against key tile kt, scaled: q k^T * scale in
// float32 (no contraction into the later subtraction).
__device__ __forceinline__ void strip_scores(float (&s)[8][4],
                                             const bf16* sQKV, int m, int kt,
                                             int nsub, float scale,
                                             int lane) {
  tile_products(s, sQKV + m * 16 * QKV_LD, QKV_LD,
                sQKV + kt * KT * QKV_LD + D, QKV_LD, nsub, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[j][q] = __fmul_rn(s[j][q], scale);
}

// The row max and the row sum of exp(s - max) of query strip m over the
// live keys: index 0 for row g of the strip, 1 for row g + 8 (every lane
// of a quad holds its rows' values).
__device__ __forceinline__ void strip_stats(const bf16* sQKV, int m, int S,
                                            int n16, float scale, int lane,
                                            float (&mx)[2], float (&sum)[2]) {
  const int t = lane & 3;
  mx[0] = mx[1] = -CUDART_INF_F;
  // ---- the row max over every key tile ----
  for (int kt = 0; kt * 4 < n16; ++kt) {
    float s[8][4];
    strip_scores(s, sQKV, m, kt, min(4, n16 - kt * 4), scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (live_key(kt * KT + 8 * j + 2 * t + (q & 1), S))
          mx[q >> 1] = fmaxf(mx[q >> 1], s[j][q]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  sum[0] = sum[1] = 0.f;
  for (int kt = 0; kt * 4 < n16; ++kt) {
    float s[8][4];
    strip_scores(s, sQKV, m, kt, min(4, n16 - kt * 4), scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (live_key(kt * KT + 8 * j + 2 * t + (q & 1), S))
          sum[q >> 1] += expf(__fsub_rn(s[j][q], mx[q >> 1]));
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
}

// The scaled scores of key tile kt -> the normalised probabilities p =
// exp(s - max) / sum in float32; keys at or past S get 0.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], int kt, int S,
                                             const float (&mx)[2],
                                             const float (&sum)[2],
                                             int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int key = kt * KT + 8 * j + 2 * t + (q & 1);
      s[j][q] = live_key(key, S)
                    ? expf(__fsub_rn(s[j][q], mx[q >> 1])) / sum[q >> 1]
                    : 0.f;
    }
}

// ---------------------------------------------------------------------------
// The forward core: o = softmax(q k^T * scale) v of one (segment, head).
// ---------------------------------------------------------------------------

// blockIdx.x = segment * H + head; qkv [n_seg * S, 3C] in, o [n_seg * S,
// C] out (the head's 64 columns).
__global__ void __launch_bounds__(THREADS, 2)
attention_long_fwd_kernel(const bf16* __restrict__ qkv,
                          bf16* __restrict__ o, int H, int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQKV = reinterpret_cast<bf16*>(smem);
  const int C = H * D;
  const int seg = blockIdx.x / H, h = blockIdx.x % H;
  const long row0 = (long)seg * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = (S + 15) / 16;

  load_head(sQKV, nullptr, qkv, nullptr, row0, S, n16 * 16, C, h);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int m = warp; m < n16; m += WARPS) {
    float mx[2], sum[2];
    strip_stats(sQKV, m, S, n16, scale, lane, mx, sum);
    float acc[8][4];
    zero_acc(acc);
    for (int kt = 0; kt * 4 < n16; ++kt) {
      const int nsub = min(4, n16 - kt * 4);
      float p[8][4];
      strip_scores(p, sQKV, m, kt, nsub, scale, lane);
      softmax_tile(p, kt, S, mx, sum, lane);
      tile_accumulate(acc, p, sQKV + kt * KT * QKV_LD + 2 * D, QKV_LD, nsub,
                      lane);
    }
    // the head's output, cast once, over the strip's q (which only this
    // warp reads), then to o with 16-byte stores
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(
            sQKV + (m * 16 + g + 8 * hr) * QKV_LD + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * hr], acc[n][2 * hr + 1]);
    __syncwarp();
    store_strip(sQKV, QKV_LD, m, S, o, row0, C, h * D, lane);
  }
}

cudaError_t fwd_core(const bf16* qkv, bf16* o, int ns, int H, int S,
                     float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_long_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (err != cudaSuccess) return err;
  attention_long_fwd_kernel<<<ns * H, THREADS, FWD_SMEM, stream>>>(
      qkv, o, H, S, scale);
  return cudaGetLastError();
}

// The forward's per-chunk scratch: ln (full form), the row statistics
// ln_kernel writes, and qkv. With base null only the size is computed.
struct FwdScratch {
  bf16 *ln, *qkv;
  float* stats;
  size_t bytes;

  FwdScratch(char* base, int n_seg, int S, int C, bool use_ln) {
    const long rows = (long)chunk_segs(n_seg, S) * S;
    size_t off = 0;
    auto take = [&](size_t n) -> char* {
      char* p = base == nullptr ? nullptr : base + off;
      off += (n + 255) / 256 * 256;
      return p;
    };
    qkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
    ln = use_ln ? reinterpret_cast<bf16*>(take(2 * rows * C)) : nullptr;
    stats = reinterpret_cast<float*>(take(4 * 2 * rows));
    bytes = off;
  }
};

// o [n_seg * S, C] = attention(qkv([LN] x)) over chunks of segments.
template <int C>
cudaError_t launch_fwd(const bf16* x, const float* lns, const float* lnb,
                       const bf16* wqkv, const float* bqkv, bf16* o,
                       char* scratch, int n_seg, int S, float scale,
                       float eps, int use_ln, cudaStream_t stream) {
  const FwdScratch sc(scratch, n_seg, S, C, use_ln);
  const int segs = chunk_segs(n_seg, S);
  for (int s0 = 0; s0 < n_seg; s0 += segs) {
    const int ns = n_seg - s0 < segs ? n_seg - s0 : segs;
    const int rows = ns * S;
    const long r0 = (long)s0 * S;
    const bf16* ain = x + r0 * C;  // the bare form's ln is x
    if (use_ln) {
      ln_kernel<C><<<(rows + 7) / 8, 256, 0, stream>>>(ain, lns, lnb, eps,
                                                        sc.ln, sc.stats,
                                                        rows);
      CHAIN_CHECK(cudaGetLastError());
      ain = sc.ln;
    }
    CHAIN_CHECK((gemm<false, false>(ain, wqkv, bqkv, sc.qkv, rows, C, 3 * C,
                                    stream)));
    CHAIN_CHECK(fwd_core(sc.qkv, o + r0 * C, ns, C / D, S, scale, stream));
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The backward core of one (segment, head).
// ---------------------------------------------------------------------------

// blockIdx.x = segment * H + head. qkv [rows, 3C] and dattn [rows, C] of
// the chunk in; attn [rows, C] and dqkv [rows, 3C] out; part [segments,
// 3C] the block's column sums of dq | dk | dv at its head's columns. Warp
// w takes query strips w, w + 8, then key strips w, w + 8.
__global__ void __launch_bounds__(THREADS, 1)
attention_long_bwd_core_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ dattn,
                               bf16* __restrict__ attn,
                               bf16* __restrict__ dqkv,
                               float* __restrict__ part, int H, int S,
                               float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQKV = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQKV + RTL * QKV_LD;
  float* sMax = reinterpret_cast<float*>(sDO + RTL * DO_LD);  // scaled max
  float* sSum = sMax + RTL;                                    // sum of exp
  float* sRs = sSum + RTL;                                     // sum(dp p)
  float* red = sRs + RTL;                  // [3][WARPS][D]: dq, dk, dv

  const int C = H * D;
  const int seg = blockIdx.x / H, h = blockIdx.x % H;
  const long row0 = (long)seg * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n16 = (S + 15) / 16;

  load_head(sQKV, sDO, qkv, dattn, row0, S, n16 * 16, C, h);
  cp_async_commit();
  for (int i = threadIdx.x; i < 3 * WARPS * D; i += THREADS) red[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  // ---- query strips: o, dp, rowsum(dp p), ds, dq ----
  for (int m = warp; m < n16; m += WARPS) {
    float mx[2], sum[2];
    strip_stats(sQKV, m, S, n16, scale, lane, mx, sum);
    float acc[8][4];
    zero_acc(acc);
    float rs[2] = {0.f, 0.f};
    for (int kt = 0; kt * 4 < n16; ++kt) {
      const int nsub = min(4, n16 - kt * 4);
      float p[8][4], dp[8][4];
      strip_scores(p, sQKV, m, kt, nsub, scale, lane);
      softmax_tile(p, kt, S, mx, sum, lane);
      tile_accumulate(acc, p, sQKV + kt * KT * QKV_LD + 2 * D, QKV_LD, nsub,
                      lane);
      tile_products(dp, sDO + m * 16 * DO_LD, DO_LD,
                    sQKV + kt * KT * QKV_LD + 2 * D, QKV_LD, nsub, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) rs[q >> 1] += dp[j][q] * p[j][q];
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    store_strip_acc(acc, attn, row0, m, S, C, h * D, nullptr, lane);
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + g + 8 * hr;
        sMax[row] = mx[hr];
        sSum[row] = sum[hr];
        sRs[row] = rs[hr];
      }
    // dq = ds k, ds = p (dp - rowsum(dp p)) * scale in bf16
    zero_acc(acc);
    for (int kt = 0; kt * 4 < n16; ++kt) {
      const int nsub = min(4, n16 - kt * 4);
      float p[8][4], dp[8][4];
      strip_scores(p, sQKV, m, kt, nsub, scale, lane);
      softmax_tile(p, kt, S, mx, sum, lane);
      tile_products(dp, sDO + m * 16 * DO_LD, DO_LD,
                    sQKV + kt * KT * QKV_LD + 2 * D, QKV_LD, nsub, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[j][q] = p[j][q] * (dp[j][q] - rs[q >> 1]) * scale;
      tile_accumulate(acc, p, sQKV + kt * KT * QKV_LD + D, QKV_LD, nsub,
                      lane);
    }
    store_strip_acc(acc, dqkv, row0, m, S, 3 * C, h * D,
                    red + (0 * WARPS + warp) * D, lane, true);
  }
  __syncthreads();                       // the row statistics are complete

  // ---- key strips: p^T, dv = p^T do, dp^T, ds^T, dk = ds^T q ----
  const int nq = n16;  // query strips the key pass reads
  for (int kst = warp; kst < n16; kst += WARPS) {
    float dv[8][4], dk[8][4];
    zero_acc(dv);
    zero_acc(dk);
    for (int qt = 0; qt * 4 < nq; ++qt) {
      const int nsub = min(4, nq - qt * 4);
      // pt[j][q]: key kst * 16 + g (+ 8 for q >= 2), query qt * KT + 8j +
      // 2t + (q & 1)
      float pt[8][4], dpt[8][4];
      tile_products(pt, sQKV + kst * 16 * QKV_LD + D, QKV_LD,
                    sQKV + qt * KT * QKV_LD, QKV_LD, nsub, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int key = kst * 16 + g + 8 * (q >> 1);
          const int qi = qt * KT + 8 * j + 2 * t + (q & 1);
          pt[j][q] = live_key(key, S) && qi < nq * 16
                         ? expf(__fsub_rn(__fmul_rn(pt[j][q], scale),
                                          sMax[qi])) / sSum[qi]
                         : 0.f;
        }
      tile_accumulate(dv, pt, sDO + qt * KT * DO_LD, DO_LD, nsub, lane);
      tile_products(dpt, sQKV + kst * 16 * QKV_LD + 2 * D, QKV_LD,
                    sDO + qt * KT * DO_LD, DO_LD, nsub, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int qi = qt * KT + 8 * j + 2 * t + (q & 1);
          const float r = qi < nq * 16 ? sRs[qi] : 0.f;
          pt[j][q] = pt[j][q] * (dpt[j][q] - r) * scale;
        }
      tile_accumulate(dk, pt, sQKV + qt * KT * QKV_LD, QKV_LD, nsub, lane);
    }
    store_strip_acc(dv, dqkv, row0, kst, S, 3 * C, 2 * C + h * D,
                    red + (2 * WARPS + warp) * D, lane, true);
    store_strip_acc(dk, dqkv, row0, kst, S, 3 * C, C + h * D,
                    red + (1 * WARPS + warp) * D, lane, true);
  }
  __syncthreads();

  // ---- the block's column sums of dq | dk | dv, warps in order ----
  for (int c = threadIdx.x; c < 3 * D; c += THREADS) {
    const int which = c / D, col = c % D;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[(which * WARPS + w) * D + col];
    part[(long)seg * (3 * C) + which * C + h * D + col] = s;
  }
}

// The backward core of one chunk (attention_bwd_chain's core launch; the
// inert form only: the chain's row0 and dropout site go unused).
struct LongCore {
  int H, S;
  float scale;
  cudaError_t operator()(const bf16* qkv, const bf16* dattn, bf16* attn,
                         bf16* dqkv, float* part, int ns, long, Drop,
                         cudaStream_t stream) const {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_long_bwd_core_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
    if (err != cudaSuccess) return err;
    attention_long_bwd_core_kernel<<<ns * H, THREADS, BWD_SMEM, stream>>>(
        qkv, dattn, attn, dqkv, part, H, S, scale);
    return cudaGetLastError();
  }
};

template <int C>
cudaError_t launch_bwd(const bf16* x, const bf16* g, const float* lns,
                       const float* lnb, const bf16* wqkv, const float* bqkv,
                       const bf16* wproj, bf16* dx, bf16* ln, bf16* attn,
                       bf16* dqkv, float* sums, float* dwqkv, float* dwA,
                       char* scratch, int n_seg, int S, float scale,
                       float eps, int use_ln, int use_residual,
                       cudaStream_t stream) {
  return attention_bwd_chain<C>(x, g, lns, lnb, wqkv, bqkv, wproj, dx, ln,
                                attn, dqkv, sums, dwqkv, dwA, scratch, n_seg,
                                S, chunk_segs(n_seg, S), RTL, eps, use_ln,
                                use_residual, LongCore{C / D, S, scale},
                                INERT, stream);
}

}  // namespace

extern "C" {

// The bytes of scratch launch_attention_long_fwd needs.
long long attention_long_fwd_scratch_bytes(int n_seg, int S, int C,
                                           int use_ln) {
  return (long long)FwdScratch(nullptr, n_seg, S, C, use_ln != 0).bytes;
}

// The forward chain: o [n_seg * S, C] = attention(qkv([LN] x)) from x
// [n_seg, S, C]. Returns the first cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: S in 87..197 (the kernels
// take 1..208), C = 64 * num_heads with C in {256, 512, 768}, n_seg >= 1,
// every pointer 32-byte aligned; scratch: a device buffer of
// attention_long_fwd_scratch_bytes(n_seg, S, C, use_ln), 256-byte aligned.
int launch_attention_long_fwd(const void* x, const void* lns,
                              const void* lnb, const void* wqkv,
                              const void* bqkv, void* o, void* scratch,
                              int n_seg, int S, int C, int num_heads,
                              float scale, float eps, int use_ln,
                              void* stream) {
  if (S < 1 || S > RTL || C != num_heads * D || n_seg < 1)
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const float*)lns, (const float*)lnb, (const bf16*)wqkv,  \
      (const float*)bqkv, (bf16*)o, (char*)scratch, n_seg, S, scale, eps,   \
      use_ln, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_fwd<256>(ARGS);
    case 512: return (int)launch_fwd<512>(ARGS);
    case 768: return (int)launch_fwd<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The block-diagonal attention op: o [n_seg * S, C] from qkv [n_seg * S,
// 3C] (q | k | v, head h at h * 64). S in 65..197 (the kernel takes
// 1..208), C a multiple of 64.
int launch_block_diag_attention_long(const void* qkv, void* o, int n_seg,
                                     int S, int C, float scale,
                                     void* stream) {
  if (S < 1 || S > RTL || C % D != 0 || C < D || n_seg < 1)
    return (int)cudaErrorInvalidValue;
  return (int)fwd_core((const bf16*)qkv, (bf16*)o, n_seg, C / D, S, scale,
                       (cudaStream_t)stream);
}

// The bytes of scratch launch_attention_bwd_long needs.
long long attention_bwd_long_scratch_bytes(int n_seg, int S, int C, int dw,
                                           int use_ln) {
  return (long long)Scratch(nullptr, n_seg, S, C, dw != 0, use_ln != 0,
                            chunk_segs(n_seg, S), RTL).bytes;
}

// The backward chain, with the arguments and outputs of
// launch_attention_bwd_s86 (csrc/fused_attention_residual_bwd_s86.cu) at S
// in 87..197 (the kernels take 1..208); scratch: a device buffer of
// attention_bwd_long_scratch_bytes(n_seg, S, C, dw, use_ln).
int launch_attention_bwd_long(const void* x, const void* g, const void* lns,
                              const void* lnb, const void* wqkv,
                              const void* bqkv, const void* wproj, void* dx,
                              void* ln, void* attn, void* dqkv, void* sums,
                              void* dwqkv, void* dwA, void* scratch,
                              int n_seg, int S, int C, int num_heads,
                              float scale, float eps, int use_ln,
                              int use_residual, void* stream) {
  const bool dw = dwqkv != nullptr;
  if (S < 1 || S > RTL || C != num_heads * D || n_seg < 1 ||
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
    case 256: return (int)launch_bwd<256>(ARGS);
    case 512: return (int)launch_bwd<512>(ARGS);
    case 768: return (int)launch_bwd<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
