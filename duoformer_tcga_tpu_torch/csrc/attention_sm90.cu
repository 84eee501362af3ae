// The attention branch's forward for Hopper (sm_90a), at 1 to 197 tokens a
// segment, and the block-diagonal attention op:
//
//     o = block-diagonal softmax attention( qkv( [LN](x) ) )     (core)
//     y = [x +] gamma * drop( o wproj + bproj )                   (proj)
//
// x is [n_seg, S, C] in bf16; each segment attends only within itself.
// Weights are bf16 in (in, out) layout: wqkv [C, 3C] (columns q | k | v,
// head h at h*64), wproj [C, C]; LayerNorm scale/bias, the biases and
// gamma are float32. o is [n_seg * S, C] in bf16, every head's output in
// its columns.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py
//   * _fused_block_kernel (#1, :311, driven by _fused_block_impl) at 1 <=
//     S <= 197 tokens (S=6 and 22: the release DuoFormer's scale blocks at
//     2 and 3 scales; 50: its patch blocks and the R50ViT hybrid's; 86:
//     the 4-scale model's regions; 197: the ViT-B/16 and R50-S/16 hybrid's
//     blocks), full form (LN + residual) and bare form, C in {256, 384,
//     512, 768} up to 64 tokens and {256, 512, 768} past, with the reg
//     flags up to 86 tokens (fused_attention_residual_reg, :1202): the
//     core drops each head's float32 probabilities before their bf16 cast
//     (site 4h at the global token indices segment * S + t, :370-383), the
//     proj's epilogue takes bias, then the proj dropout at the global row
//     and column, then gamma, then the residual (:426-439).
//   * _kernel (#10, :175, driven by _block_attention_impl): the block-
//     diagonal attention op, the core alone on the caller's qkv.
//
// Rounding points are the TPU kernel's: LN output cast to bf16; qkv cast
// after its bias; scores in float32 times scale, keys outside the query's
// segment masked, the softmax exp(s - max) / sum in float32 over the whole
// row (no online rescale, :372-378; the exponential on the special-
// function unit, the division as one reciprocal a row times each element,
// both within a few float32 ulps), the normalised p (dropped in the reg
// form) cast to bf16; P.V accumulated in float32 and each head's output
// cast once (so writing o and qkv to device memory moves no rounding
// point); proj + bias, dropout, gamma and residual in float32, cast once.
//
// Design. One wrapper call of the core runs, for each chunk of whole
// segments (the wrapper's attention_seg_chunks keeps the chunk's ln and
// qkv scratch within ATTN_SCRATCH_BYTES; the chunk's first segment gives
// the dropout masks' global tokens), three launches:
//   1. ln_kernel (full form): LayerNorm of the chunk's rows into ln;
//   2. gemm_sm90<EPI_BIAS> (csrc/gemm_sm90.cuh, the MLP's persistent
//      TMA-fed wgmma product): qkv = ln wqkv + bqkv, bf16 [rows, 3C];
//   3. attention_core: one block per SM walks the units of the chunk, a
//      unit being one head of G whole segments. Past 64 tokens G = 1; up
//      to 64, G = 64 / S segments are packed into one m64 strip (10 at
//      S=6, 2 at 22, 1 at 50), the groups restarting at the chunk's first
//      segment, the last one short where the chunk's count is not a
//      multiple of G (the wrapper rounds every chunk but the last to one).
//      Warpgroup 0 is the producer: one thread TMA-loads a unit's q, k and
//      v (boxes of NK rows x 64 columns, 128-byte swizzle, at columns
//      h*64, C + h*64, 2C + h*64 of the group's first row) into a ring of
//      stages (9 at NK = 64, 5 at 96, 2 at 208). Past 64 tokens warpgroups
//      1 and 2 both take every unit, each its m64 query strips in turn
//      (strips 0, 2 / 1, 3); up to 64 a unit is one strip and they take
//      the units in turn. A strip's scores are one wgmma m64nNKk16 chain
//      (A = q, B = k as stored, both K-major in shared memory); the whole
//      row of scores stays in registers (NK / 2 floats a thread), where the
//      segment mask (key t is live for query r only in r's segment, [r / S
//      * S, r / S * S + S): block-diagonal, as the TPU kernel's row_seg ==
//      col_seg, :354-357), the softmax and the reg dropout run; the bf16 p,
//      packed in the registers' own layout, is the A operand of P.V (wgmma
//      m64n64k16, A from registers, B = v through the transpose bit). The
//      head's output is cast once, staged over the strip's q in shared
//      memory and stored with 16-byte stores, rows at or past the group's
//      G * S (its own segment count times S) never. NK = 64 for S <= 64,
//      96 for S <= 96 and 208 for S <= 208 (the keys rounded up to 16 at
//      86 and 197).
// Past 64 tokens both consumers wait on every stage and the producer
// refills a stage only after both released it; up to 64 a stage is waited
// on and released by its unit's consumer alone. Either way no waiter is
// ever more than one phase ahead of the producer (a parity wait cannot
// tell two phases apart). Past a group's rows a box reads the next
// group's rows (finite, masked as keys, never stored as queries); past the
// chunk TMA reads zeros, because every tensor map spans exactly the
// chunk's rows (never the scratch's capacity: masked keys have p = 0, but
// 0 * NaN is NaN). The proj is the same product with EPI_OUT (K = C), over
// all rows in one launch.
//
// What bounds it on this card. The branch does 8 R C^2 + 4 R S C flops (R
// = n_seg S rows) against 4 R C bytes of x and y: compute bound; the core
// alone moves 8 R C bytes (qkv in, o out) for 4 R S C flops: bound by its
// bytes. Padding costs the core (NK - S) / NK of its score and P.V work
// (10 of 96 keys at 86, 11 of 208 at 197) and the query strips' rows past
// S (42 of 128 at 86, 59 of 256 at 197); packed, the rows past G * S (4 of
// 64 at S=6, 20 at 22, 14 at 50) and the keys outside each row's segment
// (58 of 64 at S=6). ln and qkv pass through device memory (or L2, at the
// scratch's size): 8 R C bytes more than the branch's. The old designs
// (mma.sync from cp.async slabs, the qkv product inside each segment's
// block re-reading wqkv from L2, at S=6 scores over the whole 48 x 48
// tile) took 2-3.3x their library call (PERF.md §6).

#include "gemm_sm90.cuh"

namespace {

constexpr int CORE_THREADS = 384;       // producer + 2 consumer warpgroups

// d[64 x NK] (+)= q[64 x 16] k[NK x 16]^T, both K-major in shared memory
// (no transpose); one overload per NK (64: 32 floats, 96: 48, 208: 104).
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_scores(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_scores(float (&d)[104], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103}, "
      "%104, %105, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NK>
struct CoreShape {
  static constexpr int Q_BYTES = (NK + 63) / 64 * BOX;   // whole strips
  static constexpr int KV_BYTES = NK * 128;              // k or v
  static constexpr int STAGE = Q_BYTES + 2 * KV_BYTES;
  static constexpr int STAGES = (SMEM_MAX - 1024 - 256) / STAGE;
  static constexpr int SMEM = STAGES * STAGE + 1024 + 256;
  static constexpr int TX = 3 * KV_BYTES;   // the bytes a unit's loads bring
};

// One consumer warpgroup's query strip m of one (group, head) unit: o
// rows 64m.. of the group (row0 its first row in o) for the head's
// columns, the rows below `live` (the group's segments times S) stored.
// qa, ka, va: the stage's q, k and v; tok0: the group's first global
// token; drop: the head's attention-dropout site.
template <int NK>
__device__ __forceinline__ void core_strip(unsigned qa, unsigned ka,
                                           unsigned va, int m, int S,
                                           int live, float scale, Drop drop,
                                           uint32_t tok0,
                                           bf16* __restrict__ o, long row0,
                                           int C, int h, int tid, int bar) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned sq = qa + m * BOX;
  // the first key of the segment of each of the thread's rows (hr 0, 1):
  // its keys are [lo, lo + S); one segment a unit past 64 tokens (lo = 0)
  int lo[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    lo[hr] = NK == 64 ? (16 * warp + g + 8 * hr) / S * S : 0;
  // ---- scores q k^T in float32: fragment j holds row 16 warp + g + 8
  // ((j >> 1) & 1), key 8 (j >> 2) + 2t + (j & 1) ----
  float sc[NK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_scores(sc, desc128(sq + kk * 32, 16, 1024),
                 desc128(ka + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  // ---- softmax over the live keys of rows g (hr 0) and g + 8 (hr 1),
  // in a warp with a live row (the others' rows are never stored); a
  // masked key's score is -inf, its exp 0 (a row at or past `live` has the
  // finite keys of its window, and is never stored). The normalised p in
  // float32, dropped in the reg form, cast to bf16 as P.V's A fragments
  // (k16 block kb: fragments 8kb..8kb+7) ----
  uint32_t pa[NK / 16][4];
  if (64 * m + 16 * warp < live) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) {
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
    for (int j = 0; j < NK / 2; ++j) {
      sc[j] = exp_sfu(__fsub_rn(sc[j], mx[(j >> 1) & 1]));
      sum[(j >> 1) & 1] += sc[j];
    }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
    for (int j = 0; j < NK / 2; j += 2) {
      const int hr = (j >> 1) & 1;
      float p0 = __fmul_rn(sc[j], inv[hr]);
      float p1 = __fmul_rn(sc[j + 1], inv[hr]);
      if (drop.on) {
        const uint32_t qt = tok0 + 64 * m + 16 * warp + g + 8 * hr;
        const uint32_t kt = tok0 + 8 * (j >> 2) + 2 * t;
        p0 = drop.apply(p0, qt, kt);
        p1 = drop.apply(p1, qt, kt + 1);
      }
      pa[j >> 3][(j >> 1) & 3] = pack_bf16(p0, p1);
    }
  } else {
#pragma unroll
    for (int kb = 0; kb < NK / 16; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kb][i] = 0u;
  }
  // ---- P V ----
  float acc[HD / 2];
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < NK / 16; ++kb)
    wgmma_pv(acc, pa[kb], desc128(va + kb * 2048, 8192, 1024), kb > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kb = 0; kb < NK / 16; ++kb)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kb][i])::"memory");
  // ---- the head's output, cast once, over the strip's q (read by this
  // warpgroup's wgmma alone, which has retired), then to o ----
#pragma unroll
  for (int j = 0; j < HD / 2; j += 2) {
    const int r = 16 * warp + g + 8 * ((j >> 1) & 1);
    st_shared(sq + swz(r, 8 * (j >> 2) + 2 * t), pack_bf16(acc[j], acc[j + 1]));
  }
  named_sync(bar);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tid + 128 * u, r = i >> 3, c8 = i & 7;
    if (64 * m + r < live) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(sq + r * 128 + ((c8 ^ (r & 7)) << 4)));
      *reinterpret_cast<uint4*>(o + (row0 + 64 * m + r) * C + h * HD +
                                c8 * 8) = v;
    }
  }
}

// o [n_seg * S, C] = attention of qkv [n_seg * S, 3C] (tm: its map, boxes
// of NK rows x 64 columns over exactly n_seg * S rows). G: segments a unit
// (G S <= 64 at NK = 64, else 1). adrop: the attention dropout
// (SITE_ATTN folded in; off in the inert forms); tok_base: the global
// token of the first row.
template <int NK>
__global__ void __launch_bounds__(CORE_THREADS, 1)
attention_core(const __grid_constant__ CUtensorMap tm, bf16* __restrict__ o,
               int n_seg, int H, int S, int G, float scale, Drop adrop,
               uint32_t tok_base) {
  typedef CoreShape<NK> Sh;
  // up to 64 tokens a unit is one strip, taken by one consumer
  constexpr bool PACKED = NK == 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::STAGES * Sh::STAGE);
  uint64_t* empty = full + Sh::STAGES;
  const int C = H * HD;
  const int units = (n_seg + G - 1) / G * H;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(&full[s], 1);
      // every thread of the consumers that take the stage's unit
      mbar_init(&empty[s], PACKED ? 128 : 256);
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
        const int r0 = u / H * G * S, col = u % H * HD;
        mbar_expect_tx(&full[s], Sh::TX);
        tma_load(st, &tm, col, r0, &full[s]);
        tma_load(st + Sh::Q_BYTES, &tm, C + col, r0, &full[s]);
        tma_load(st + Sh::Q_BYTES + Sh::KV_BYTES, &tm, 2 * C + col, r0,
                 &full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw takes strips cw, cw + 2 of every unit,
    // or, packed, the block's units cw, cw + 2, ... (its one strip) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    const int strips = (S + 63) / 64;
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
      if (PACKED && (i & 1) != cw) continue;
      const int s = i % Sh::STAGES;
      const int seg = u / H * G, h = u % H;   // the group's first segment
      const int live = min(G, n_seg - seg) * S;
      mbar_wait(&full[s], (i / Sh::STAGES) & 1);
      const unsigned qa = smem_addr(smem + s * Sh::STAGE);
      Drop hdrop = adrop;                  // head h's site
      hdrop.seed_plus = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
      const uint32_t tok0 = tok_base + (uint32_t)seg * (uint32_t)S;
      for (int m = PACKED ? 0 : cw; m < strips; m += 2)
        core_strip<NK>(qa, qa + Sh::Q_BYTES, qa + Sh::Q_BYTES + Sh::KV_BYTES,
                       m, S, live, scale, hdrop, tok0, o, (long)seg * S, C,
                       h, tid, 1 + cw);
      // o's staging (generic writes) before the stage's next TMA load
      fence_proxy_async();
      mbar_arrive(&empty[s]);
    }
  }
}

// The map spans the n_seg * S rows and no more, whatever the buffer holds
// past them (cap_rows: its capacity, checked).
template <int NK>
cudaError_t launch_core_nk(const bf16* qkv, bf16* o, int n_seg, int H, int S,
                           int G, float scale, Drop adrop, uint32_t tok_base,
                           long cap_rows, cudaStream_t stream) {
  typedef CoreShape<NK> Sh;
  CUtensorMap tm;
  if ((long)n_seg * S > cap_rows ||
      !tensor_map(&tm, qkv, 3 * H * HD, n_seg * S, NK))
    return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  static bool sized[MAX_DEVICES] = {};   // the shared-memory attribute set
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_core<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sh::SMEM);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  const int units = (n_seg + G - 1) / G * H;
  attention_core<NK><<<std::min(units, sm_count(dev)), CORE_THREADS, Sh::SMEM,
                       stream>>>(tm, o, n_seg, H, S, G, scale, adrop,
                                 tok_base);
  return cudaGetLastError();
}

// G: segments a unit, G S <= 64 up to 64 tokens, 1 past (checked).
cudaError_t launch_core(const bf16* qkv, bf16* o, int n_seg, int H, int S,
                        int G, float scale, Drop adrop, uint32_t tok_base,
                        long cap_rows, cudaStream_t stream) {
  if (S < 1 || S > 208 || G < 1 || (S <= 64 ? G * S > 64 : G != 1))
    return cudaErrorInvalidValue;
  if (S <= 64)
    return launch_core_nk<64>(qkv, o, n_seg, H, S, G, scale, adrop, tok_base,
                              cap_rows, stream);
  if (S <= 96)
    return launch_core_nk<96>(qkv, o, n_seg, H, S, 1, scale, adrop, tok_base,
                              cap_rows, stream);
  return launch_core_nk<208>(qkv, o, n_seg, H, S, 1, scale, adrop, tok_base,
                             cap_rows, stream);
}

const Drop NO_DROP = make_drop(0, 0, -1, 1.f);

}  // namespace

extern "C" {

// Arguments are checked by the Python wrapper: S in 1..197 (the kernels
// take 1..208), C = 64 * num_heads with C in {256, 384, 512, 768} (384 up
// to 64 tokens), n_seg >= 1, every pointer 32-byte aligned; G, the
// segments a unit of the core, is the wrapper's unit_segments(S): 64 / S
// up to 64 tokens, 1 past. Each entry returns its first failing launch's
// error (0 on success).

// The core's chain over one chunk of segments: o [n_seg * S, C] =
// attention(qkv([LN] x)) for x [n_seg, S, C] at the chunk's first row.
// ln: bf16 scratch [n_seg * S rounded up to 32, C] (full form; the bare
// form's ln is x), qkv: bf16 scratch [cap_rows >= n_seg * S, 3C]; seg0:
// the chunk's first global segment (the masks' tokens count from seg0 *
// S). seed, attn_thr, attn_scale: the reg form's attention dropout
// (attn_thr < 0: off).
int launch_attention_chain(const void* x, const void* lns, const void* lnb,
                           const void* wqkv, const void* bqkv, void* o,
                           void* ln, void* qkv, long long cap_rows,
                           int n_seg, int S, int G, int C, int num_heads,
                           int seg0, float scale, float eps, int use_ln,
                           int seed, int attn_thr, float attn_scale,
                           void* stream) {
  if (S < 1 || S > 208 || C != num_heads * HD || n_seg < 1 ||
      (use_ln && ln == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = n_seg * S;
  const bf16* a = (const bf16*)x;
  if (use_ln) {
    const cudaError_t err = run_layernorm(a, (const float*)lns,
                                          (const float*)lnb, (bf16*)ln, rows,
                                          C, eps, st);
    if (err != cudaSuccess) return (int)err;
    a = (const bf16*)ln;
  }
  const GemmArgs g{rows, 3 * C, C, (const float*)bqkv, nullptr, nullptr, 0,
                   0, NO_DROP, 0u};
  const cudaError_t err = run_gemm<EPI_BIAS>(a, (const bf16*)wqkv,
                                             (bf16*)qkv, nullptr, g, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_core((const bf16*)qkv, (bf16*)o, n_seg, num_heads, S,
                          G, scale, make_drop(seed, SITE_ATTN, attn_thr,
                                              attn_scale),
                          (uint32_t)seg0 * (uint32_t)S, (long)cap_rows, st);
}

// The block-diagonal attention op: o [n_seg * S, C] from qkv [n_seg * S,
// 3C] (q | k | v, head h at h * 64) in a buffer of cap_rows rows from qkv.
// S in 1..197 (the kernel takes 1..208), C a multiple of 64.
int launch_block_diag_attention(const void* qkv, void* o, long long cap_rows,
                                int n_seg, int S, int G, int C, float scale,
                                void* stream) {
  if (C % HD != 0 || C < HD || n_seg < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_core((const bf16*)qkv, (bf16*)o, n_seg, C / HD, S, G,
                          scale, NO_DROP, 0u, (long)cap_rows,
                          (cudaStream_t)stream);
}

// The proj: out [rows, C] = [x +] gamma * drop(o wproj + bproj). C a
// multiple of 128 (384 included). gamma float32 [C] or null; seed, proj_thr, proj_scale:
// the reg form's proj dropout (proj_thr < 0: off), at the global row.
int launch_attention_proj(const void* o, const void* x, const void* wproj,
                          const void* bproj, void* out, int rows, int C,
                          int use_residual, const void* gamma, int seed,
                          int proj_thr, float proj_scale, void* stream) {
  if (rows < 1 || C % BN != 0) return (int)cudaErrorInvalidValue;
  const GemmArgs g{rows, C, C, (const float*)bproj, (const bf16*)x,
                   (const float*)gamma, use_residual, 0,
                   make_drop(seed, SITE_PROJ, proj_thr, proj_scale), 0u};
  return (int)run_gemm<EPI_OUT>((const bf16*)o, (const bf16*)wproj,
                                (bf16*)out, nullptr, g,
                                (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
