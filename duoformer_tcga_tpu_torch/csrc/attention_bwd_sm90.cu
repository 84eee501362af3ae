// Backward of the attention branch at 1 to 197 tokens a segment, for
// Hopper (sm_90a).
//
// The forward (csrc/attention_sm90.cu) is
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) ).
// Given x and the upstream gradient g (both [n_seg, S, C] bf16, S <= 197),
// this backward recomputes LN, qkv and the softmax and writes
//     dx   [n_seg, S, C] bf16   the input cotangent (LN backward, + g)
//     ln   [rows, C]     bf16   the LN output (full form only: the bare
//                               form's ln is x itself)
//     attn [rows, C]     bf16   the attention output, proj's input
//     dqkv [rows, 3C]    bf16   the cotangent of qkv (q | k | v columns)
// and the float32 column sums dlns = sum(dln * xhat), dlnb = sum(dln),
// dbqkv = sum(dqkv), dbproj = sum(g), summed in a fixed order. dw=False
// leaves the weight gradients dwqkv = ln^T dqkv and dwproj = attn^T g to
// the caller, as the JAX package leaves them to XLA. The dw form returns no
// row-space tensor: it forms
//     dwqkv [C, 3C] += ln^T dqkv,   dwA [C, C] += attn^T gacc   (float32)
// itself (gacc = bf16(g * proj mask / keep) with the proj dropout on, else
// g), from per-chunk scratch.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_bwd_kernel (:723) with dw=False and with dw=True, driven by
// _fused_block_bwd_impl (:921), at S <= 197: every ScaleBlock of the
// release DuoFormer in training at S=6 (2 scales), 22 (3 scales) and 86 (4
// scales, the R4r regions too), full form; every PatchBlock at S=50, bare
// form (use_ln = use_residual = 0); the R50ViT hybrid's blocks at S=50,
// C=384; the ViT-B/16's and R50-S/16 hybrid's at S=197. The reg forms
// (up to 86 tokens; _far_reg_bwd,
// :1228; :809-822, 848-870, 885-905) are runtime arguments of the same
// chain: per chunk geff_kernel (csrc/reg_grad.cuh) forms geff = bf16(bf16(
// g * proj mask / keep) * gamma), which dattn takes instead of g, and gm =
// bf16(g * proj mask / keep) (the ninth output with dw=False, per-chunk
// scratch in the dw form, where it is dwA's gacc); the core regenerates the
// forward's attention mask of each (token, key, head) at global tokens,
// drops the bf16 p for o and for dv = p^T do, drops and rescales dp, and
// takes the softmax Jacobian with the undropped float32 p; dbproj sums the
// float32 proj-masked g without gamma; the residual adds raw g.
//
// Rounding points are the TPU kernel's (pallas_attention.py:791-918): ln
// in bf16; qkv in bf16 after its bias; p in float32 for the softmax
// Jacobian and in bf16 for P.V and dv; each head's output o in bf16; each
// head's slice of dattn = geff wproj^T in bf16; ds * scale in bf16; dq, dk,
// dv in bf16; dln = dqkv wqkv^T accumulated in float32 from the bf16 dqkv;
// the LN backward in float32 and dx rounded once. dbqkv sums the rounded
// dqkv.
//
// Design. One C entry per call walks chunks of whole segments (the
// wrapper's attention_bwd_seg_chunks: every chunk but the last a multiple
// of G = 64 / S segments up to 64 tokens, the chunk's scratch within
// ATTN_BWD_SCRATCH_BYTES). Per chunk it launches
//   1. geff_kernel (reg form with gamma or the proj dropout);
//   2. ln_stats_kernel (csrc/chain_rows.cuh; full form): ln and each row's
//      mean and 1/std;
//   3. gemm_sm90<EPI_BIAS> (csrc/gemm_sm90.cuh): qkv = ln wqkv + bqkv;
//   4. gemm_sm90<EPI_BIAS, BT>: dattn = geff wproj^T, wproj read K-major;
//   5. attention_bwd_core: one block per SM walks the chunk's units, a unit
//      being one head of G whole segments in one m64 strip, as the forward
//      core packs them. Warpgroup 0's one producer thread
//      TMA-loads a unit's q, k, v and do (boxes of 64 rows x 64 columns,
//      128-byte swizzle) into a ring of 4 stages; consumer warpgroups 1 and
//      2 take the units in turn, each unit's stage waited on and released
//      by its consumer alone (an even ring, so a stage is always the same
//      consumer's). A unit is six wgmma m64n64k16 chains: the scores q k^T
//      (both K-major); after the block-diagonal mask and the float32
//      softmax in registers, o = p v (p from registers, v through the
//      transpose bit) and dp = do v^T (both K-major); ds = p (dp -
//      rowsum(dp p)) * scale, in registers; dq = ds k (ds from registers,
//      k through the transpose bit); dk = ds^T q and dv = p^T do, whose A
//      operands are the bf16 ds and p written to shared memory row-major
//      ([query, key], 128-byte swizzle) and read M-major (A's transpose
//      bit), their B operands q and do MN-major. o, dq, dk and dv are cast
//      once, staged in shared memory and stored with 16-byte stores, rows
//      past the group's G * S never; the unit's column sums of the rounded
//      dq | dk | dv (its rows, in warp order) make one partial row.
//      Past 64 tokens attention_bwd_core_long<NK> (NK = 96 up to 96
//      tokens, 208 past: the forward core's key counts): a unit is one
//      (segment, head), its m64 query strips and its m64 key strips (2 of
//      each at 96, 4 at 208, rows and keys past S masked). The producer
//      TMA-loads the unit's k and v (NK rows) and q and do (whole strips)
//      into a ring (2 stages at 96, 1 at 208). Both consumers take every
//      unit. First each takes its query strips (cw, cw + 2, ...): the
//      scores over the row (wgmma m64nNKk16), the float32 softmax in
//      registers, o = p v, dp = do v^T, the row sums sum(drop(dp) p) over
//      every key, ds and dq = ds k. At 96 dp comes with the scores in one
//      m64n96 chain; p and ds, cast to bf16, go to the unit's p and ds
//      tiles in shared memory ([query, key], 64 x 64 boxes), P.V and dq
//      read them K-major, and ds and dq run under P.V and o's store. At
//      208 a thread's registers (168 beside the producer warpgroup) hold
//      the row's 104 floats of p but not dp and dq beside them: dp runs a
//      key tile of 64 at a time, once for the row sums and again, with
//      the tile's scores, for ds and dq, and each row's max, 1 / sum and
//      sum(dp p) go to shared memory. After a barrier of both consumers
//      each takes its key strips: dk = ds^T q and dv = p^T do over the
//      query strips, at 96 with ds and p read from the tiles M-major (A's
//      transpose bit), at 208 with s^T = k q^T and dp^T = v do^T again and
//      p^T and ds^T formed in registers from the row statistics. Both
//      strips' outputs are cast once, staged and stored with 16-byte
//      stores, rows past S never; their column sums by warp make, after a
//      second barrier, the segment's partial row, each column summed over
//      strips and warps in order;
//   6. gemm_sm90<EPI_F32, BT>: dln = dqkv wqkv^T in float32;
//   7. ln_bwd_rows_kernel: the LN backward by rows, + g, dx rounded once,
//      and per-block column sums of dln * xhat, dln and g;
//   8. dw form only: gemm_sm90<EPI_ACC, AT>, dwqkv += ln^T dqkv and dwA +=
//      attn^T gacc in one persistent grid (ln and attn read M-major), added
//      in place;
//   9. sum_rows_kernel: the chunk's partial rows in order;
// and after the last chunk the chunks' rows in order. Chunks run in stream
// order and nothing is summed with atomics, so every output, dwqkv and dwA
// included, is bit-reproducible. qkv, dattn, dln, the statistics and the
// partial rows live in the per-chunk scratch; dw=False writes ln, attn and
// dqkv into the caller's outputs, the dw form into the scratch.
//
// Padding. A unit's box reads past its group's rows the next group's rows
// (finite) and, past the chunk, zeros: every tensor map spans exactly the
// chunk's rows (0 * NaN is NaN). A query row r attends to the keys of its
// own segment, [r / S * S, r / S * S + S), so a row past the group's live
// rows reaches only keys past them, whose dk and dv are never stored; the
// warps whose rows are all past them take p = 0. In the long core the
// keys at or past S are masked out of the scores and the query rows at or
// past S take p = ds = 0 (their q and do finite), so neither reaches a
// stored row; a key strip or tile reading past k's NK rows reads v's, and
// past v's q's.
//
// What bounds it on this card. 2 R C (3C + C + 3C) flops of products
// (qkv, dattn, dln; the dw form 4 R C^2 more for each of dwqkv's 3C and
// dwA's C columns) and 12 R S C of attention against 2 R C (3 + 1 + 1 + 3
// + 1) bytes of activations in and out: compute bound. The chain moves
// qkv, dattn, dln (and the dw form's ln, attn, dqkv) through device memory
// (or L2, at the scratch's size), and the packed core's padding costs (64 -
// G S) / 64 of its rows and all but S of each row's 64 keys; the long core
// does 80 m64n64k16 products a unit at NK = 96 and 616 at 208, where 12 S^2
// 64 flops need 43 and 227, and waits on its softmax's and stores'
// arithmetic between them (two warpgroups). The old designs (up to 64
// tokens one block of 48 rows doing the whole backward on warp-level m16n8
// products, streaming wqkv twice and wproj once from L2, the dw form's
// products added with float32 atomics; past 64 a chain of such products
// from per-thread asynchronous copies around a core of m16 strips) took
// 0.84-1.95x and 0.96-1.56x their library calls (PERF.md §6).

#include "chain_rows.cuh"
#include "gemm_sm90.cuh"
#include "reg_grad.cuh"

namespace {

constexpr int BWD_THREADS = 384;          // producer + 2 consumer warpgroups
constexpr int BWD_STAGE = 4 * BOX;        // a unit's q, k, v and do
constexpr int BWD_STAGES = 4;             // even: a stage is one consumer's
constexpr int BWD_TILES = 2 * BOX;        // a consumer's p and ds tiles
constexpr int BWD_RED = 3 * 4 * HD;       // its column sums [3][4 warps][64]
constexpr int BWD_SMEM = BWD_STAGES * BWD_STAGE + 2 * BWD_TILES +
                         2 * BWD_RED * 4 + 256 + 1024;
static_assert(BWD_SMEM <= SMEM_MAX, "the core's shared memory");

// A consumer's float accumulator fragments (fragment j: row 16 warp + g +
// 8 ((j >> 1) & 1), column 8 (j >> 2) + 2t + (j & 1)), cast once to bf16,
// into a 64 x 64 tile of TMA's 128-byte swizzle at `tile`.
__device__ __forceinline__ void stage_frags(const float (&a)[32],
                                            unsigned tile, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; j += 2)
    st_shared(tile + swz(16 * warp + g + 8 * ((j >> 1) & 1),
                         8 * (j >> 2) + 2 * t),
              pack_bf16(a[j], a[j + 1]));
}

// Rows below `live` of a staged 64 x 64 tile to out (row r at out + r *
// ld), 16 bytes a thread a step.
__device__ __forceinline__ void store_tile(unsigned tile, bf16* out, long ld,
                                           int live, int tid) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 128 * u, r = i >> 3, c8 = i & 7;
    if (r < live) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(tile + r * 128 + ((c8 ^ (r & 7)) << 4)));
      *reinterpret_cast<uint4*>(out + (long)r * ld + c8 * 8) = v;
    }
  }
}

// The warp's column sums of the bf16-rounded fragments over its rows
// below `live`, into red[warp][64] (lanes of g == 0 hold them after the
// shuffles).
__device__ __forceinline__ void frag_colsums(const float (&a)[32], int live,
                                             float* red, int warp,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool in0 = 16 * warp + g < live, in1 = 16 * warp + g + 8 < live;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s =
          (in0 ? __bfloat162float(__float2bfloat16(a[4 * c + e])) : 0.f) +
          (in1 ? __bfloat162float(__float2bfloat16(a[4 * c + 2 + e])) : 0.f);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (g == 0) red[warp * HD + 8 * c + 2 * t + e] = s;
    }
}

// The backward of one (group, head) unit by one consumer warpgroup. st:
// the unit's stage (q, k, v, do boxes); tiles: the consumer's p and ds
// tiles; red: its column sums [3][4][64]; live: the group's segments
// times S; tok0: the group's first global token; drop: the head's
// attention-dropout site (off in the inert forms). o to attn, dq | dk | dv
// to dqkv (both from the group's first row), the column sums of dq | dk |
// dv to prow [3C] at the head's columns.
__device__ __forceinline__ void unit_bwd(unsigned st, unsigned tiles,
                                         float* red, int S, int live,
                                         float scale, Drop drop,
                                         uint32_t tok0, bf16* attn,
                                         bf16* dqkv, float* prow, int C,
                                         int h, int tid, int bar) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned qa = st, ka = st + BOX, va = st + 2 * BOX, da = st + 3 * BOX;
  const unsigned pt = tiles, dst = tiles + BOX;
  // ---- scores q k^T in float32: fragment j holds row 16 warp + g + 8
  // ((j >> 1) & 1), key 8 (j >> 2) + 2t + (j & 1) ----
  float sc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<0, 0>(sc, desc128(qa + kk * 32, 16, 1024),
                   desc128(ka + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  // ---- the float32 softmax over each row's segment, [r / S * S, + S),
  // in a warp with a live row (the others take p = 0); keep bit j: the
  // forward's attention mask of fragment j (reg form) ----
  uint32_t keep = 0xffffffffu;
  if (16 * warp < live) {
    int lo[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) lo[hr] = (16 * warp + g + 8 * hr) / S * S;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = 8 * (j >> 2) + 2 * t + (j & 1);
      const int k0 = lo[(j >> 1) & 1];
      sc[j] = key >= k0 && key < k0 + S ? __fmul_rn(sc[j], scale)
                                        : -CUDART_INF_F;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = exp_sfu(__fsub_rn(sc[j], mx[(j >> 1) & 1]));
      sum[(j >> 1) & 1] += sc[j];
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = __fmul_rn(sc[j], inv[(j >> 1) & 1]);
    if (drop.on)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t qt = tok0 + 16 * warp + g + 8 * ((j >> 1) & 1);
        const uint32_t kt = tok0 + 8 * (j >> 2) + 2 * t + (j & 1);
        if (!keep_mask(drop.seed_plus, qt, kt, drop.thr)) keep &= ~(1u << j);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  }
  // ---- the bf16 (dropped) p: A fragments of P.V, and the p tile ----
  uint32_t pa[4][4];
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    float p0 = sc[j], p1 = sc[j + 1];
    if (drop.on) {
      p0 = (keep >> j) & 1u ? p0 * drop.scale : 0.f;
      p1 = (keep >> (j + 1)) & 1u ? p1 * drop.scale : 0.f;
    }
    pa[j >> 3][(j >> 1) & 3] = pack_bf16(p0, p1);
    st_shared(pt + swz(16 * warp + g + 8 * ((j >> 1) & 1),
                       8 * (j >> 2) + 2 * t),
              pa[j >> 3][(j >> 1) & 3]);
  }
  // ---- o = p v and dp = do v^T ----
  float acc[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_pv(acc, pa[kb], desc128(va + kb * 2048, 8192, 1024), kb > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<0, 0>(dp, desc128(da + kk * 32, 16, 1024),
                   desc128(va + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(dp);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kb][i])::"memory");
  // ---- o, cast once, staged in the ds tile (its last reader, the
  // previous unit's dk, has retired), to attn ----
  stage_frags(acc, dst, warp, lane);
  named_sync(bar);
  store_tile(dst, attn + h * HD, C, live, tid);
  named_sync(bar);
  // ---- ds = p (drop(dp) - rowsum(drop(dp) p)) * scale, bf16: A
  // fragments of dq, and the ds tile ----
  if (drop.on)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      dp[j] = (keep >> j) & 1u ? dp[j] * drop.scale : 0.f;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) rs[(j >> 1) & 1] += dp[j] * sc[j];
  rs[0] = quad_sum(rs[0]);
  rs[1] = quad_sum(rs[1]);
  uint32_t dsf[4][4];
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const float r = rs[(j >> 1) & 1];
    dsf[j >> 3][(j >> 1) & 3] = pack_bf16(sc[j] * (dp[j] - r) * scale,
                                          sc[j + 1] * (dp[j + 1] - r) * scale);
    st_shared(dst + swz(16 * warp + g + 8 * ((j >> 1) & 1),
                        8 * (j >> 2) + 2 * t),
              dsf[j >> 3][(j >> 1) & 3]);
  }
  // the p and ds tiles (generic writes) before the wgmma that read them
  fence_proxy_async();
  named_sync(bar);
  // ---- dq = ds k; dk = ds^T q and dv = p^T do, ds and p M-major ----
  float dq[32], dk[32], dv[32];
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_pv(dq, dsf[kb], desc128(ka + kb * 2048, 8192, 1024), kb > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<1, 1>(dk, desc128(dst + kk * 2048, 8192, 1024),
                   desc128(qa + kk * 2048, 8192, 1024), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<1, 1>(dv, desc128(pt + kk * 2048, 8192, 1024),
                   desc128(da + kk * 2048, 8192, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(dk);
  fence_regs(dv);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(dsf[kb][i])::"memory");
  // every warp's products have read q, k, v and do
  named_sync(bar);
  // ---- dq | dk | dv, cast once, staged over q | k | v, to dqkv; their
  // column sums ----
  stage_frags(dq, qa, warp, lane);
  stage_frags(dk, ka, warp, lane);
  stage_frags(dv, va, warp, lane);
  frag_colsums(dq, live, red, warp, lane);
  frag_colsums(dk, live, red + 4 * HD, warp, lane);
  frag_colsums(dv, live, red + 8 * HD, warp, lane);
  named_sync(bar);
#pragma unroll
  for (int w = 0; w < 3; ++w)
    store_tile(st + w * BOX, dqkv + w * C + h * HD, 3 * C, live, tid);
  for (int c = tid; c < 3 * HD; c += 128) {
    const float* r = red + (c / HD) * 4 * HD + c % HD;
    prow[(c / HD) * C + h * HD + c % HD] = ((r[0] + r[HD]) + r[2 * HD]) +
                                           r[3 * HD];
  }
  named_sync(bar);   // red read before the next unit writes it
}

// attn [n_seg * S, C] and dqkv [n_seg * S, 3C] of a chunk from its qkv
// [n_seg * S, 3C] and dattn [n_seg * S, C] (tm_qkv, tm_do: their maps,
// boxes of 64 rows x 64 columns over exactly n_seg * S rows); part
// [ceil(n_seg / G), 3C]: each group's column sums of dq | dk | dv. G:
// segments a unit (G S <= 64); adrop: the attention dropout (SITE_ATTN
// folded in; off in the inert forms); tok_base: the chunk's first global
// token.
__global__ void __launch_bounds__(BWD_THREADS, 1)
attention_bwd_core(const __grid_constant__ CUtensorMap tm_qkv,
                   const __grid_constant__ CUtensorMap tm_do,
                   bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                   float* __restrict__ part, int n_seg, int H, int S, int G,
                   float scale, Drop adrop, uint32_t tok_base) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tiles = smem + BWD_STAGES * BWD_STAGE;
  float* red = reinterpret_cast<float*>(tiles + 2 * BWD_TILES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * BWD_RED);
  uint64_t* empty = full + BWD_STAGES;
  const int C = H * HD;
  const int units = (n_seg + G - 1) / G * H;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);   // every thread of the unit's consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread loads the block's units in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const int s = i % BWD_STAGES;
        mbar_wait(&empty[s], ((i / BWD_STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * BWD_STAGE;
        const int r0 = u / H * G * S, col = u % H * HD;
        mbar_expect_tx(&full[s], BWD_STAGE);
        tma_load(st, &tm_qkv, col, r0, &full[s]);
        tma_load(st + BOX, &tm_qkv, C + col, r0, &full[s]);
        tma_load(st + 2 * BOX, &tm_qkv, 2 * C + col, r0, &full[s]);
        tma_load(st + 3 * BOX, &tm_do, col, r0, &full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes the block's units cw, cw + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    const unsigned my_tiles = smem_addr(tiles + cw * BWD_TILES);
    float* my_red = red + cw * BWD_RED;
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
      if ((i & 1) != cw) continue;
      const int s = i % BWD_STAGES;
      const int grp = u / H, h = u % H;
      const int seg = grp * G;              // the group's first segment
      const int live = min(G, n_seg - seg) * S;
      mbar_wait(&full[s], (i / BWD_STAGES) & 1);
      Drop hdrop = adrop;                   // head h's site
      hdrop.seed_plus = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
      const long row0 = (long)seg * S;
      unit_bwd(smem_addr(smem + s * BWD_STAGE), my_tiles, my_red, S, live,
               scale, hdrop, tok_base + (uint32_t)row0, attn + row0 * C,
               dqkv + row0 * 3 * C, part + (long)grp * 3 * C, C, h, tid,
               1 + cw);
      // the staged outputs (generic writes) before the stage's next load
      fence_proxy_async();
      mbar_arrive(&empty[s]);
    }
  }
}

cudaError_t launch_bwd_core(const bf16* qkv, const bf16* dattn, bf16* attn,
                            bf16* dqkv, float* part, int n_seg, int H, int S,
                            int G, float scale, Drop adrop,
                            uint32_t tok_base, cudaStream_t stream) {
  const int C = H * HD, rows = n_seg * S;
  CUtensorMap mq, md;
  if (!tensor_map(&mq, qkv, 3 * C, rows, 64) ||
      !tensor_map(&md, dattn, C, rows, 64))
    return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  static bool sized[MAX_DEVICES] = {};   // the shared-memory attribute set
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_core, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BWD_SMEM);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  const int units = (n_seg + G - 1) / G * H;
  attention_bwd_core<<<std::min(units, sm_count(dev)), BWD_THREADS, BWD_SMEM,
                       stream>>>(mq, md, attn, dqkv, part, n_seg, H, S, G,
                                 scale, adrop, tok_base);
  return cudaGetLastError();
}

// ---- the long core: one (segment, head) a unit, 65 to 197 tokens ----

// A stage of the long core: the unit's k and v (NK rows each), then its q
// and do (whole m64 strips, QP rows each). A key strip's or a key tile's
// 64 rows past k's NK read on into v, and past v's into q: finite rows
// whose keys are masked. At NK = 96 (TILES) the unit's bf16 p and ds,
// [query, key] in 64 x 64 boxes of TMA's 128-byte swizzle (strip m's keys
// 64b.. in box 2m + b), stay in shared memory for the key pass; past 96
// they would not fit, and the key pass takes s^T and dp^T again from each
// row's max, 1 / sum and sum(dp p) (STATS).
template <int NK>
struct LongShape {
  static constexpr bool TILES = NK <= 96;
  static constexpr int QS = (NK + 63) / 64;   // m64 strips: queries, keys
  static constexpr int QP = 64 * QS;          // rows of q and do
  static constexpr int NF = NK / 2;           // a row's score fragments
  static constexpr int STAGE = 2 * NK * 128 + 2 * QP * 128;
  static constexpr int PDS = TILES ? 2 * QS * QS * BOX : 0;   // p, ds
  // each row's statistics for two units in turn; each strip's column
  // sums of the rounded dq | dk | dv by warp, also for two units
  static constexpr int STATS = TILES ? 0 : 2 * QP * 16;
  static constexpr int RED = 3 * QS * 4 * HD;
  static constexpr int FIXED = PDS + STATS + 2 * RED * 4 + 2 * BOX + 256;
  static constexpr int STAGES = (SMEM_MAX - 1024 - FIXED) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + FIXED + 1024;
};

// ds of one (query, key): the softmax Jacobian on the undropped float32
// p, drop(dp) less the row's sum(drop(dp) p), times the score scale.
__device__ __forceinline__ float long_ds(float p, float d, float r,
                                        float scale) {
  return p * (d - r) * scale;
}

// Both consumer warpgroups of a long-core block.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// keeps the compiler from reusing a wgmma's A fragments before it retired
template <int KB>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KB][4]) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kb][i])::"memory");
}

// A row's bf16 pair (key, key + 1) of strip m into a [query, key] tile of
// 64 x 64 boxes (key 64b.. in box 2m + b at tiles).
__device__ __forceinline__ void st_pair(unsigned tiles, int m, int row,
                                        int key, uint32_t v) {
  st_shared(tiles + (2 * m + (key >> 6)) * BOX + swz(row, key & 63), v);
}

// dk, dv of key strip ks, cast once and staged, to dqkv (from the strip's
// first key row; rows below klive), their column sums to red.
template <int NK>
__device__ __forceinline__ void long_store_kv(const float (&dk)[32],
                                              const float (&dv)[32],
                                              int ks, int klive,
                                              bf16* dqkv, float* red,
                                              unsigned stg, int C, int h,
                                              int tid, int bar) {
  typedef LongShape<NK> Sh;
  const int warp = tid >> 5, lane = tid & 31;
  const long row = (long)64 * ks * 3 * C;
  stage_frags(dk, stg, warp, lane);
  frag_colsums(dk, klive, red + (Sh::QS + ks) * 4 * HD, warp, lane);
  named_sync(bar);
  store_tile(stg, dqkv + row + C + h * HD, 3 * C, klive, tid);
  named_sync(bar);
  stage_frags(dv, stg, warp, lane);
  frag_colsums(dv, klive, red + (2 * Sh::QS + ks) * 4 * HD, warp, lane);
  named_sync(bar);
  store_tile(stg, dqkv + row + 2 * C + h * HD, 3 * C, klive, tid);
  named_sync(bar);
}

// Query strip m of a unit, by one consumer warpgroup: the scores over the
// NK keys, the float32 softmax, o = p v (to attn), dp = do v^T, the row
// sums sum(drop(dp) p), ds and dq = ds k (to dqkv), dq's column sums to
// red. TILES: dp over the whole row with the scores, the bf16 p and ds
// also to the unit's tiles pds (p, then ds), ds and dq under P.V; else dp
// a key tile of 64 at a time, twice (the row sums, then ds and dq), and
// the row's statistics to st. ka, va, qa, da: the stage's k, v, q and do;
// live: the strip's rows below S; tok0: the segment's first global token;
// attn, dqkv: the strip's first row there; stg: the consumer's staging
// tile.
template <int NK>
__device__ __forceinline__ void long_query_strip(
    unsigned ka, unsigned va, unsigned qa, unsigned da, int m, int S,
    int live, float scale, Drop drop, uint32_t tok0, bf16* attn, bf16* dqkv,
    unsigned pds, float4* st, float* red, unsigned stg, int C, int h,
    int tid, int bar) {
  typedef LongShape<NK> Sh;
  constexpr int NF = Sh::NF, KT = Sh::QS, KB = NK / 16;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned sq = qa + m * BOX, sd = da + m * BOX;
  const bool rlive[2] = {16 * warp + g < live, 16 * warp + g + 8 < live};
  // ---- scores q k^T in float32 (TILES: and dp = do v^T): fragment j
  // holds row 16 warp + g + 8 ((j >> 1) & 1), key 8 (j >> 2) + 2t + (j & 1)
  float sc[NF], dp[Sh::TILES ? NF : 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_scores(sc, desc128(sq + kk * 32, 16, 1024),
                 desc128(ka + kk * 32, 16, 1024), kk > 0);
  if constexpr (Sh::TILES)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_scores(dp, desc128(sd + kk * 32, 16, 1024),
                   desc128(va + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  if constexpr (Sh::TILES) fence_regs(dp);
  // ---- the softmax over the keys below S; p in float32, 0 on rows at or
  // past S (the next segment's, or zeros) ----
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int key = 8 * (j >> 2) + 2 * t + (j & 1);
    sc[j] = key < S ? __fmul_rn(sc[j], scale) : -CUDART_INF_F;
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    sc[j] = exp_sfu(__fsub_rn(sc[j], mx[(j >> 1) & 1]));
    sum[(j >> 1) & 1] += sc[j];
  }
  const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
  for (int j = 0; j < NF; ++j)
    sc[j] = rlive[(j >> 1) & 1] ? __fmul_rn(sc[j], inv[(j >> 1) & 1]) : 0.f;
  // the forward's attention mask (reg form, up to 86 tokens): bit j of
  // keep
  uint32_t keep[(NF + 31) / 32];
#pragma unroll
  for (int w = 0; w < (NF + 31) / 32; ++w) keep[w] = 0xffffffffu;
  if (Sh::TILES && drop.on)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const uint32_t qt = tok0 + 64 * m + 16 * warp + g + 8 * ((j >> 1) & 1);
      const uint32_t kt = tok0 + 8 * (j >> 2) + 2 * t + (j & 1);
      if (!keep_mask(drop.seed_plus, qt, kt, drop.thr))
        keep[j >> 5] &= ~(1u << (j & 31));
    }
  float acc[32], dq[32];
  if constexpr (Sh::TILES) {
    // ---- the bf16 (dropped) p into the p tile (keys past NK 0), o = p v
    // from it; under P.V the row sums and ds in bf16 into the ds tile; dq
    // = ds k from it under o's store ----
#pragma unroll
    for (int j = 0; j < 64 * KT / 2; j += 2) {
      uint32_t v = 0u;
      if (j < NF) {
        float p0 = sc[j], p1 = sc[j + 1];
        if (drop.on) {
          p0 = (keep[j >> 5] >> (j & 31)) & 1u ? p0 * drop.scale : 0.f;
          p1 = (keep[j >> 5] >> ((j + 1) & 31)) & 1u ? p1 * drop.scale : 0.f;
        }
        v = pack_bf16(p0, p1);
      }
      st_pair(pds, m, 16 * warp + g + 8 * ((j >> 1) & 1), 8 * (j >> 2) + 2 * t,
              v);
    }
    // the p tile (generic writes) before the wgmma that read it
    fence_proxy_async();
    named_sync(bar);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      wgmma_ss<0, 1>(acc,
                     desc128(pds + (2 * m + (kb >> 2)) * BOX + (kb & 3) * 32,
                             16, 1024),
                     desc128(va + kb * 2048, 8192, 1024), kb > 0);
    wgmma_commit();
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      if (drop.on)
        dp[j] = (keep[j >> 5] >> (j & 31)) & 1u ? dp[j] * drop.scale : 0.f;
      rs[(j >> 1) & 1] += dp[j] * sc[j];
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    const unsigned dst = pds + 2 * Sh::QS * BOX;
#pragma unroll
    for (int j = 0; j < 64 * KT / 2; j += 2) {
      const int hr = (j >> 1) & 1;
      uint32_t v = 0u;
      if (j < NF)
        v = pack_bf16(long_ds(sc[j], dp[j], rs[hr], scale),
                      long_ds(sc[j + 1], dp[j + 1], rs[hr], scale));
      st_pair(dst, m, 16 * warp + g + 8 * hr, 8 * (j >> 2) + 2 * t, v);
    }
    fence_proxy_async();
    named_sync(bar);
    wgmma_wait<0>();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      wgmma_ss<0, 1>(dq,
                     desc128(dst + (2 * m + (kb >> 2)) * BOX + (kb & 3) * 32,
                             16, 1024),
                     desc128(ka + kb * 2048, 8192, 1024), kb > 0);
    wgmma_commit();
    stage_frags(acc, stg, warp, lane);
    named_sync(bar);
    store_tile(stg, attn + h * HD, C, live, tid);
    named_sync(bar);
    wgmma_wait<0>();
    fence_regs(dq);
  } else {
    // ---- o = p v, the bf16 p from registers ----
    {
      uint32_t pa[KB][4];
#pragma unroll
      for (int j = 0; j < NF; j += 2)
        pa[j >> 3][(j >> 1) & 3] = pack_bf16(sc[j], sc[j + 1]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
        wgmma_pv(acc, pa[kb], desc128(va + kb * 2048, 8192, 1024), kb > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
    }
    stage_frags(acc, stg, warp, lane);
    named_sync(bar);
    store_tile(stg, attn + h * HD, C, live, tid);
    named_sync(bar);
    // ---- the row sums sum(dp p) over every key, dp = do v^T a key tile
    // of 64 at a time ----
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {   // the row sums' key tiles
      float dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0, 0>(dpt, desc128(sd + kk * 32, 16, 1024),
                       desc128(va + kt * BOX + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (32 * kt + j < NF) rs[(j >> 1) & 1] += dpt[j] * sc[32 * kt + j];
    }
    rs[0] = quad_sum(rs[0]);
    rs[1] = quad_sum(rs[1]);
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        st[64 * m + 16 * warp + g + 8 * hr] =
            make_float4(mx[hr], inv[hr], rs[hr], 0.f);
    // ---- ds = p (dp - rowsum) * scale in bf16, and dq = ds k, a key
    // tile at a time (dp, the tile's scores and p again, from the row's
    // max and 1 / sum: the whole row of p beside dp and dq would not fit
    // in a thread's 168 registers) ----
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {   // ds and dq's key tiles
      float dpt[32], s2[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0, 0>(s2, desc128(sq + kk * 32, 16, 1024),
                       desc128(ka + kt * BOX + kk * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<0, 0>(dpt, desc128(sd + kk * 32, 16, 1024),
                       desc128(va + kt * BOX + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s2);
      fence_regs(dpt);
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int hr = (j >> 1) & 1;
        float p[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (rlive[hr] && 64 * kt + 8 * (j >> 2) + 2 * t + e < S)
            p[e] = __fmul_rn(
                exp_sfu(__fsub_rn(__fmul_rn(s2[j + e], scale), mx[hr])),
                inv[hr]);
        dsa[j >> 3][(j >> 1) & 3] =
            pack_bf16(long_ds(p[0], dpt[j], rs[hr], scale),
                      long_ds(p[1], dpt[j + 1], rs[hr], scale));
      }
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        wgmma_pv(dq, dsa[kb], desc128(ka + kt * BOX + kb * 2048, 8192, 1024),
                 kt > 0 || kb > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_frags(dsa);
    }
  }
  stage_frags(dq, stg, warp, lane);
  frag_colsums(dq, live, red + m * 4 * HD, warp, lane);
  named_sync(bar);
  store_tile(stg, dqkv + h * HD, 3 * C, live, tid);
  named_sync(bar);
}

// Key strip ks of a unit at NK = 96, by one consumer warpgroup: dk = ds^T
// q and dv = p^T do over the query strips, ds and p from the unit's tiles
// pds read M-major (A's transpose bit), q and do MN-major.
template <int NK>
__device__ __forceinline__ void long_key_strip_tiles(
    unsigned qa, unsigned da, int ks, int klive, int ql, bf16* dqkv,
    unsigned pds, float* red, unsigned stg, int C, int h, int tid, int bar) {
  typedef LongShape<NK> Sh;
  float dk[32], dv[32];
  wgmma_fence();
  for (int qs = 0; qs < ql; ++qs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dk,
                     desc128(pds + (2 * Sh::QS + 2 * qs + ks) * BOX +
                                 kk * 2048, 8192, 1024),
                     desc128(qa + qs * BOX + kk * 2048, 8192, 1024),
                     qs > 0 || kk > 0);
  for (int qs = 0; qs < ql; ++qs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dv,
                     desc128(pds + (2 * qs + ks) * BOX + kk * 2048, 8192,
                             1024),
                     desc128(da + qs * BOX + kk * 2048, 8192, 1024),
                     qs > 0 || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  long_store_kv<NK>(dk, dv, ks, klive, dqkv, red, stg, C, h, tid, bar);
}

// Key strip ks of a unit past 96 keys (no reg form: its flags stop at 86
// tokens), by one consumer warpgroup: dk = ds^T q and dv = p^T do over the
// query strips below S, s^T = k q^T and dp^T = v do^T again, p^T and ds^T
// from the row statistics st, both from registers; klive: the strip's
// keys below S; ql: the query strips with a row below S.
template <int NK>
__device__ __forceinline__ void long_key_strip(
    unsigned ka, unsigned va, unsigned qa, unsigned da, int ks, int S,
    int klive, int ql, float scale, bf16* dqkv, const float4* st,
    float* red, unsigned stg, int C, int h, int tid, int bar) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned sk = ka + ks * BOX, sv = va + ks * BOX;
  const bool klv[2] = {16 * warp + g < klive, 16 * warp + g + 8 < klive};
  // fragment j: key 64 ks + 16 warp + g + 8 ((j >> 1) & 1), query 64 qs +
  // 8 (j >> 2) + 2t + (j & 1)
  float dk[32], dv[32];
  for (int qs = 0; qs < ql; ++qs) {
    float sT[32], dpT[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(sT, desc128(sk + kk * 32, 16, 1024),
                     desc128(qa + qs * BOX + kk * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(dpT, desc128(sv + kk * 32, 16, 1024),
                     desc128(da + qs * BOX + kk * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int hr = (j >> 1) & 1;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 64 * qs + 8 * (j >> 2) + 2 * t + e;
        const float4 r = st[q];
        p[e] = 0.f;
        if (klv[hr] && q < S)
          p[e] = __fmul_rn(
              exp_sfu(__fsub_rn(__fmul_rn(sT[j + e], scale), r.x)), r.y);
        ds[e] = long_ds(p[e], dpT[j + e], r.z, scale);
      }
      pa[j >> 3][(j >> 1) & 3] = pack_bf16(p[0], p[1]);
      dsa[j >> 3][(j >> 1) & 3] = pack_bf16(ds[0], ds[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
      wgmma_pv(dk, dsa[kb], desc128(qa + qs * BOX + kb * 2048, 8192, 1024),
               qs > 0 || kb > 0);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
      wgmma_pv(dv, pa[kb], desc128(da + qs * BOX + kb * 2048, 8192, 1024),
               qs > 0 || kb > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pa);
    fence_frags(dsa);
  }
  long_store_kv<NK>(dk, dv, ks, klive, dqkv, red, stg, C, h, tid, bar);
}

// attn [n_seg * S, C] and dqkv [n_seg * S, 3C] of a chunk from its qkv and
// dattn (tm_kv: qkv in boxes of NK rows; tm_q, tm_do: qkv and dattn in
// boxes of QP rows; each over exactly n_seg * S rows); part [n_seg, 3C]:
// each segment's column sums of dq | dk | dv. One (segment, head) a unit;
// both consumers take every unit: its query strips cw, cw + 2, ..., then,
// once both have written the unit's p and ds tiles or its rows'
// statistics, its key strips cw, cw + 2, .... adrop, tok_base: as
// attention_bwd_core's.
template <int NK>
__global__ void __launch_bounds__(BWD_THREADS, 1)
attention_bwd_core_long(const __grid_constant__ CUtensorMap tm_kv,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        bf16* __restrict__ attn, bf16* __restrict__ dqkv,
                        float* __restrict__ part, int n_seg, int H, int S,
                        float scale, Drop adrop, uint32_t tok_base) {
  typedef LongShape<NK> Sh;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* pds = smem + Sh::STAGES * Sh::STAGE;             // p, ds tiles
  uint8_t* stg = pds + Sh::PDS;                             // 2 tiles
  float4* stats = reinterpret_cast<float4*>(stg + 2 * BOX);  // [2][QP]
  float* red = reinterpret_cast<float*>(stg + 2 * BOX + Sh::STATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * Sh::RED);
  uint64_t* empty = full + Sh::STAGES;
  const int C = H * HD;
  const int units = n_seg * H;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);   // every thread of both consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread loads the block's units in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const int s = i % Sh::STAGES;
        mbar_wait(&empty[s], ((i / Sh::STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * Sh::STAGE;
        const int r0 = u / H * S, col = u % H * HD;
        mbar_expect_tx(&full[s], Sh::STAGE);
        tma_load(st, &tm_kv, C + col, r0, &full[s]);
        tma_load(st + NK * 128, &tm_kv, 2 * C + col, r0, &full[s]);
        tma_load(st + 2 * NK * 128, &tm_q, col, r0, &full[s]);
        tma_load(st + 2 * NK * 128 + Sh::QP * 128, &tm_do, col, r0,
                 &full[s]);
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    const unsigned my_stg = smem_addr(stg + cw * BOX);
    const unsigned tiles = smem_addr(pds);
    const int ql = (S + 63) / 64;        // strips with a row below S
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
      const int s = i % Sh::STAGES;
      const int seg = u / H, h = u % H;
      const long row0 = (long)seg * S;
      mbar_wait(&full[s], (i / Sh::STAGES) & 1);
      const unsigned ka = smem_addr(smem + s * Sh::STAGE);
      const unsigned va = ka + NK * 128, qa = va + NK * 128;
      const unsigned da = qa + Sh::QP * 128;
      Drop hdrop = adrop;                   // head h's site
      hdrop.seed_plus = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
      const uint32_t tok0 = tok_base + (uint32_t)row0;
      float4* st = stats + (i & 1) * Sh::QP;
      float* rd = red + (i & 1) * Sh::RED;
      for (int m = cw; m < ql; m += 2)
        long_query_strip<NK>(ka, va, qa, da, m, S, min(64, S - 64 * m),
                             scale, hdrop, tok0, attn + (row0 + 64 * m) * C,
                             dqkv + (row0 + 64 * m) * 3 * C, tiles, st, rd,
                             my_stg, C, h, tid, 1 + cw);
      // the p and ds tiles (generic writes) before the wgmma that read them
      if (Sh::TILES) fence_proxy_async();
      pair_sync();   // every row's tiles or statistics written
      for (int ks = cw; ks < ql; ks += 2) {
        if constexpr (Sh::TILES)
          long_key_strip_tiles<NK>(qa, da, ks, min(64, S - 64 * ks), ql,
                                   dqkv + row0 * 3 * C, tiles, rd, my_stg, C,
                                   h, tid, 1 + cw);
        else
          long_key_strip<NK>(ka, va, qa, da, ks, S, min(64, S - 64 * ks), ql,
                             scale, dqkv + row0 * 3 * C, st, rd, my_stg, C,
                             h, tid, 1 + cw);
      }
      mbar_arrive(&empty[s]);
      pair_sync();   // every strip's column sums written, the tiles read
      // the unit's partial row: each column's strips and warps in order
      for (int c = threadIdx.x - 128; c < 3 * HD; c += 256) {
        const int kind = c / HD;
        float v = 0.f;
        for (int m = 0; m < ql; ++m) {
          const float* r = rd + (kind * Sh::QS + m) * 4 * HD + c % HD;
          v += ((r[0] + r[HD]) + r[2 * HD]) + r[3 * HD];
        }
        part[(long)seg * 3 * C + kind * C + h * HD + c % HD] = v;
      }
    }
  }
}

template <int NK>
cudaError_t launch_bwd_long_nk(const bf16* qkv, const bf16* dattn,
                               bf16* attn, bf16* dqkv, float* part,
                               int n_seg, int H, int S, float scale,
                               Drop adrop, uint32_t tok_base,
                               cudaStream_t stream) {
  typedef LongShape<NK> Sh;
  static_assert(Sh::STAGES >= 1, "the long core's shared memory");
  const int C = H * HD, rows = n_seg * S;
  CUtensorMap mkv, mq, md;
  if (!tensor_map(&mkv, qkv, 3 * C, rows, NK) ||
      !tensor_map(&mq, qkv, 3 * C, rows, Sh::QP) ||
      !tensor_map(&md, dattn, C, rows, Sh::QP))
    return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  static bool sized[MAX_DEVICES] = {};   // the shared-memory attribute set
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_core_long<NK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  attention_bwd_core_long<NK>
      <<<std::min(n_seg * H, sm_count(dev)), BWD_THREADS, Sh::SMEM,
         stream>>>(
          mkv, mq, md, attn, dqkv, part, n_seg, H, S, scale, adrop,
          tok_base);
  return cudaGetLastError();
}

// The scratch of one call, carved from one buffer in the order of the
// wrapper's attention_bwd_scratch_bytes (each piece 256-byte aligned), for
// chunks of at most chunk_segs segments: per chunk qkv, dattn, dln, the
// LN statistics, the LN backward's and the core's partial rows; the dw
// form's ln, attn, dqkv and gm; the reg form's geff; then the chunks' sums.
// With base null only the size is computed.
struct BwdScratch {
  bf16 *qkv, *dattn, *ln, *attn, *dqkv, *geff, *gm;
  float *dln, *stats, *part_r, *part_q, *chunk_sums;
  size_t bytes;

  BwdScratch(char* base, int n_seg, int chunk_segs, int S, int C, int G,
             bool dw, bool use_ln, bool geff_on, bool gm_on) {
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
    dattn = reinterpret_cast<bf16*>(take(2 * rows * C));
    dln = reinterpret_cast<float*>(take(4 * rows * C));
    stats = use_ln ? reinterpret_cast<float*>(take(4 * 2 * rows)) : nullptr;
    part_r = reinterpret_cast<float*>(
        take(4 * ((rows + RP_ROWS - 1) / RP_ROWS) * 3 * C));
    part_q = reinterpret_cast<float*>(
        take(4 * (long)((segs + G - 1) / G) * 3 * C));
    ln = attn = dqkv = gm = geff = nullptr;
    if (dw) {
      if (use_ln) ln = reinterpret_cast<bf16*>(take(2 * rows * C));
      attn = reinterpret_cast<bf16*>(take(2 * rows * C));
      dqkv = reinterpret_cast<bf16*>(take(2 * rows * 3 * C));
      if (gm_on) gm = reinterpret_cast<bf16*>(take(2 * rows * C));
    }
    if (geff_on) geff = reinterpret_cast<bf16*>(take(2 * rows * C));
    chunk_sums = reinterpret_cast<float*>(take(4 * (long)nchunks * 6 * C));
    bytes = off;
  }
};

template <int C>
cudaError_t backward(const bf16* x, const bf16* g, const float* lns,
                     const float* lnb, const bf16* wqkv, const float* bqkv,
                     const bf16* wproj, bf16* dx, bf16* ln, bf16* attn,
                     bf16* dqkv, float* sums, float* dwqkv, float* dwA,
                     char* scratch, size_t scratch_bytes, int n_seg, int S,
                     int chunk_segs, float scale, float eps, int use_ln,
                     int use_residual, ChainReg reg, cudaStream_t stream) {
  const int H = C / HD, G = S <= 64 ? 64 / S : 1;
  const bool dw = dwqkv != nullptr;
  const bool geff = reg.gamma != nullptr || reg.pdrop.on;
  const BwdScratch sc(scratch, n_seg, chunk_segs, S, C, G, dw, use_ln, geff,
                      dw && reg.pdrop.on);
  if (sc.bytes > scratch_bytes) return cudaErrorInvalidValue;
  const int nchunks = (n_seg + chunk_segs - 1) / chunk_segs;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s0 = ci * chunk_segs;
    const int ns = n_seg - s0 < chunk_segs ? n_seg - s0 : chunk_segs;
    const int rows = ns * S;
    const long r0 = (long)s0 * S;
    const bf16* xc = x + r0 * C;
    const bf16* gc = g + r0 * C;
    bf16* lnc = use_ln ? (dw ? sc.ln : ln + r0 * C) : nullptr;
    const bf16* ain = use_ln ? lnc : xc;   // the bare form's ln is x
    bf16* attnc = dw ? sc.attn : attn + r0 * C;
    bf16* dqkvc = dw ? sc.dqkv : dqkv + r0 * 3 * C;
    // the cotangent the proj's transpose takes (geff in the reg form), and
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
    GemmArgs q{rows, 3 * C, C, bqkv};
    CHAIN_CHECK(run_gemm<EPI_BIAS>(ain, wqkv, sc.qkv, nullptr, q, stream));
    GemmArgs d{rows, C, C, nullptr};
    CHAIN_CHECK((run_gemm<EPI_BIAS, false, true>(gsrc, wproj, sc.dattn,
                                                 nullptr, d, stream)));
    if (S <= 64)
      CHAIN_CHECK(launch_bwd_core(sc.qkv, sc.dattn, attnc, dqkvc, sc.part_q,
                                  ns, H, S, G, scale, reg.adrop,
                                  (uint32_t)r0, stream));
    else if (S <= 96)
      CHAIN_CHECK(launch_bwd_long_nk<96>(sc.qkv, sc.dattn, attnc, dqkvc,
                                         sc.part_q, ns, H, S, scale,
                                         reg.adrop, (uint32_t)r0, stream));
    else
      CHAIN_CHECK(launch_bwd_long_nk<208>(sc.qkv, sc.dattn, attnc, dqkvc,
                                          sc.part_q, ns, H, S, scale,
                                          reg.adrop, (uint32_t)r0, stream));
    GemmArgs l{rows, C, 3 * C, nullptr};
    l.out = sc.dln;
    CHAIN_CHECK((run_gemm<EPI_F32, false, true>(dqkvc, wqkv, nullptr,
                                                nullptr, l, stream)));
    const int rb = (rows + RP_ROWS - 1) / RP_ROWS;
    ln_bwd_rows_kernel<C><<<rb, 256, 0, stream>>>(
        sc.dln, xc, gc, lns, sc.stats, dx + r0 * C, sc.part_r, rows, use_ln,
        use_residual, reg.pdrop, r0);
    CHAIN_CHECK(cudaGetLastError());
    if (dw) {
      GemmArgs w{C, 3 * C, rows, nullptr};
      w.out = dwqkv;
      w.M2 = C;
      w.N2 = C;
      w.out2 = dwA;
      CHAIN_CHECK((run_gemm<EPI_ACC, true, false>(
          ain, dqkvc, nullptr, nullptr, w, stream, attnc, gacc)));
    }
    float* row = sc.chunk_sums + (long)ci * 6 * C;
    // dlns | dlnb | dbqkv | dbproj: part_r's dlns, dlnb and dbproj columns
    // around part_q's dbqkv
    CHAIN_CHECK(sum_rows(sc.part_q, (ns + G - 1) / G, 3 * C, row + 2 * C,
                         3 * C, nullptr, stream));
    CHAIN_CHECK(sum_rows(sc.part_r, rb, 3 * C, row, 2 * C, row + 5 * C,
                         stream));
  }
  return sum_rows(sc.chunk_sums, nchunks, 6 * C, sums, 6 * C, nullptr,
                  stream);
}

}  // namespace

extern "C" {

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: S in 1..64, C = 64 *
// num_heads with C in {256, 384, 512, 768}, n_seg >= 1, every pointer
// 32-byte aligned; chunk_segs the segments of every chunk but the last, a
// multiple of 64 / S where n_seg exceeds it. ln is null in the bare form;
// sums is float32 [6C]: dlns | dlnb | dbqkv (3C) | dbproj (with the proj
// dropout on, the sum of the float32 proj-masked g). The dw form: dwqkv
// float32 [C, 3C] and dwA float32 [C, C], zeroed by the caller, both given
// (else both null); ln, attn, dqkv and gm are then null. The reg form:
// gamma float32 [C] or null; gm bf16 [rows, C], written when the proj
// dropout is on with dw=False (else null); seed, the thresholds (< 0: off)
// and keep scales of the two dropout sites, as the forward took them.
// scratch: a device buffer of scratch_bytes, 256-byte aligned, at least
// what the wrapper's attention_bwd_scratch_bytes gives for the chunk plus
// the chunks' sums (checked).
int launch_attention_bwd_sm90(
    const void* x, const void* g, const void* lns, const void* lnb,
    const void* wqkv, const void* bqkv, const void* wproj, void* dx,
    void* ln, void* attn, void* dqkv, void* sums, void* dwqkv, void* dwA,
    void* scratch, long long scratch_bytes, int n_seg, int S, int C,
    int num_heads, int chunk_segs, float scale, float eps, int use_ln,
    int use_residual, const void* gamma, void* gm, int seed, int attn_thr,
    float attn_scale, int proj_thr, float proj_scale, void* stream) {
  const bool dw = dwqkv != nullptr;
  const ChainReg reg{(const float*)gamma,
                make_drop(seed, SITE_ATTN, attn_thr, attn_scale),
                make_drop(seed, SITE_PROJ, proj_thr, proj_scale), (bf16*)gm};
  if (S < 1 || S > 197 || C != num_heads * HD || n_seg < 1 ||
      (S > 86 && (gamma != nullptr || reg.adrop.on || reg.pdrop.on)) ||
      chunk_segs < 1 ||
      (chunk_segs < n_seg && S <= 64 && chunk_segs % (64 / S) != 0) ||
      (dwqkv == nullptr) != (dwA == nullptr) ||
      (!dw && (attn == nullptr || dqkv == nullptr ||
               (use_ln && ln == nullptr))) ||
      (!dw && reg.pdrop.on) != (gm != nullptr))
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,     \
      (const bf16*)wqkv, (const float*)bqkv, (const bf16*)wproj, (bf16*)dx, \
      (bf16*)ln, (bf16*)attn, (bf16*)dqkv, (float*)sums, (float*)dwqkv,     \
      (float*)dwA, (char*)scratch, (size_t)scratch_bytes, n_seg, S,         \
      chunk_segs, scale, eps, use_ln, use_residual, reg, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)backward<256>(ARGS);
    case 384: return (int)backward<384>(ARGS);
    case 512: return (int)backward<512>(ARGS);
    case 768: return (int)backward<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
