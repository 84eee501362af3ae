// Backward of the attention branch at 1 to 64 tokens a segment, for Hopper
// (sm_90a).
//
// The forward (csrc/attention_sm90.cu) is
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) ).
// Given x and the upstream gradient g (both [n_seg, S, C] bf16, S <= 64),
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
// _fused_block_bwd_impl (:921), at S <= 64: every ScaleBlock of the
// release DuoFormer in training at S=6 (2 scales) and 22 (3 scales), full
// form; every PatchBlock at S=50, bare form (use_ln = use_residual = 0);
// the R50ViT hybrid's blocks at S=50, C=384. The reg forms (_far_reg_bwd,
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
// of G = 64 / S segments, the chunk's scratch within ATTN_SCRATCH_BYTES).
// Per chunk it launches
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
//      dq | dk | dv (its rows, in warp order) make one partial row;
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
// warps whose rows are all past them take p = 0.
//
// What bounds it on this card. 2 R C (3C + C + 3C) flops of products
// (qkv, dattn, dln; the dw form 4 R C^2 more for each of dwqkv's 3C and
// dwA's C columns) and 12 R S C of attention against 2 R C (3 + 1 + 1 + 3
// + 1) bytes of activations in and out: compute bound. The chain moves
// qkv, dattn, dln (and the dw form's ln, attn, dqkv) through device memory
// (or L2, at the scratch's size), and the packed core's padding costs (64 -
// G S) / 64 of its rows and all but S of each row's 64 keys. The old
// design (one block of 48 rows doing the whole backward on mma.sync,
// streaming wqkv twice and wproj once from L2, the dw form's products added
// with float32 atomics) took 0.84-1.95x its library call (PERF.md §6).

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
  const int H = C / HD, G = 64 / S;
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
    CHAIN_CHECK(launch_bwd_core(sc.qkv, sc.dattn, attnc, dqkvc, sc.part_q,
                                ns, H, S, G, scale, reg.adrop, (uint32_t)r0,
                                stream));
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
  if (S < 1 || S > 64 || C != num_heads * HD || n_seg < 1 ||
      chunk_segs < 1 || (chunk_segs < n_seg && chunk_segs % (64 / S) != 0) ||
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
