// The persistent TMA-fed wgmma product the port's bf16 kernels share on
// Hopper (sm_90a), with its LayerNorm row pass and the PTX wrappers
// (mbarrier, TMA, wgmma) and attention helpers the attention cores use too:
//
//     D [M, N] = epilogue(A [M, K] B [K, N])
//
// A and D row-major bf16, B the weight as stored, (in, out), bf16. Two
// template flags read an operand the other way round, as it lies in
// device memory: AT, A given as [K, M] (M-major: the weight gradients'
// ln^T and attn^T); BT, B given as [N, K] (K-major: a product with a
// weight's transpose, g wproj^T and dqkv wqkv^T). The epilogue is a
// template argument too:
//   EPI_GELU (the MLP's fc1, csrc/fused_mlp_residual.cu): h = drop(gelu(
//     acc + bias)), the dropout at site 2; with store_z also z = acc +
//     bias; both cast to bf16;
//   EPI_OUT (the MLP's fc2, and the attention proj of csrc/attention_sm90
//     .cu): y = [x +] gamma * drop(acc + bias), in float32, cast once;
//   EPI_BIAS (the attention branch's qkv product, and with no bias the
//     backward's dattn): qkv = acc [+ bias], cast to bf16;
//   EPI_F32 (the backward's dln, csrc/attention_bwd_sm90.cu): out = acc in
//     float32;
//   EPI_ACC (the backward's weight gradients): out += acc in float32, in
//     place, for two problems in one grid (g.M2 > 0: the tiles of the
//     second, A2 B2 into out2, follow the first's), so that dwqkv's 108
//     tiles and dwA's 36 at C = 768 share the 132 SMs. Each output tile is
//     one block's, and successive launches run in stream order, so the
//     sums over a caller's chunks are bit-reproducible.
// Every mask counts from the global row (g.row0 + the chunk's row) and
// the column (csrc/dropout_hash.cuh).
//
// Design. gemm_sm90 is a persistent kernel: one block per SM walks the
// 128 x 128 output tiles in order. Warpgroup 0 is the producer: one thread
// keeps a ring of 5 shared-memory stages full with TMA loads (the 128 x 64
// A tile and the 64 x 128 B tile, 128-byte swizzled), each completing on
// its stage's "full" mbarrier. Warpgroups 1-4 are two pairs of consumers;
// a pair takes every other tile of the block, its two warpgroups 64 rows
// each, and runs wgmma.mma_async m64n128k16 (bf16 in, float32 accumulate)
// on the stages as they arrive, releasing each on its "empty" mbarrier
// once the wgmma that read it has retired. So one pair's epilogue (the
// arithmetic a tile waits for) runs while the other pair's products do; an
// "order" mbarrier lets a pair start a tile's stages only after the other
// pair has taken the previous tile's. B as stored, N contiguous, is read
// through wgmma's transpose bit, so the weights are never copied; a
// K-major B (BT) comes in one box of 128 rows of N and takes no transpose
// bit; an M-major A (AT) comes in two boxes of 64 columns of M, one per
// warpgroup, and takes A's transpose bit. K need not be a multiple of 64
// with AT: TMA reads zeros past the K rows of A and B. The bf16 epilogues
// write their tile into shared memory in the TMA store layout and
// TMA-store it: coalesced, and the rows of a ragged last tile are clipped
// by the store (its loads read zeros there); the float32 ones store or add
// float pairs to device memory, rows past M never. The residual x is read
// from device memory with its rows masked. Tiles of 128 x 256 (the two
// warpgroups splitting one tile, the epilogue not overlapped) and one pair
// taking 128-row tiles alone (ping-pong) were slower on the card (PERF.md
// §6).
//
// What bounds it on this card: 2 M N K flops against the bytes of A, B
// and D; at the port's shapes the products are compute bound. Every row
// tile reads its weight slabs from L2 again (no cluster multicast yet).

#pragma once

#include <cuda.h>

#include <algorithm>
#include <mutex>

#include "tile_ops.cuh"

namespace {

constexpr int BM = 128;          // rows of an output tile
constexpr int BN = 128;          // columns of an output tile
constexpr int BK = 64;           // depth of a ring stage (128 bytes of bf16)
constexpr int THREADS = 640;     // producer warpgroup + 2 pairs of consumers
constexpr int SMEM_MAX = 232448;
constexpr int LN_ROWS = 32;      // rows of an ln_kernel block (8 warps)

// shared memory: the ring (each stage the 128 x 64 A tile and the 64 x 128
// B tile), each consumer's staged 64 x 128 output, the mbarriers
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE = A_BYTES + BK * BN * 2;
constexpr int OUT = 64 * BN * 2;
constexpr int STAGES = (SMEM_MAX - 4 * OUT - 2048) / STAGE;   // 5
constexpr int SMEM = STAGES * STAGE + 4 * OUT + 2048;

enum Epi { EPI_GELU, EPI_OUT, EPI_BIAS, EPI_F32, EPI_ACC };

// ---- PTX wrappers: mbarrier, TMA, wgmma, fences ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const unsigned addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the shared memory of every committed store has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// every committed store is complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(unsigned addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (bytes; the descriptor holds them / 16).
__device__ __forceinline__ uint64_t desc128(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128] from shared memory: A K-major
// (row-major [M, K]; TA = 1: M-major, row-major [K, M]), B MN-major
// (row-major [K, N], TB = 1: the transpose bit set; TB = 0: K-major,
// row-major [N, K]); scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, the
// major-ness as wgmma's (the attention cores' scores q k^T and dp = do v^T
// with TA = TB = 0; the backward's dk = ds^T q and dv = p^T do, both
// operands MN-major, with TA = TB = 1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x 64] (+)= a[64 x 16] b[16 x 64]: a from registers (the m16n8k16 A
// fragment of each warp's 16 rows), b MN-major in shared memory (the
// transpose bit set): the attention cores' P.V and the backward's dq =
// ds k.
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- attention helpers ----

constexpr int HD = 64;                  // head width
constexpr int BOX = 64 * 128;           // 64 rows of one head's columns

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(d) on the special-function unit: ex2.approx of d log2(e) (relative
// error ~2^-22, far inside p's bf16 cast; exp(-inf) = 0). The softmax's
// arithmetic, not its bytes, is what a unit waits for: CUDA's expf and an
// IEEE division an element took twice the core's time at 86 tokens
// (PERF.md §6).
__device__ __forceinline__ float exp_sfu(float d) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(e)
      : "f"(__fmul_rn(d, 1.4426950408889634f)));
  return e;
}

// Byte offset of (r, c) in a 64-column box of TMA's 128-byte swizzle.
__device__ __forceinline__ unsigned swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// ---- the LayerNorm row pass ----

// LayerNorm of rows [row0, row0 + LN_ROWS) of x into ln (bf16, the block's
// rows from ln + row0 * C); the scratch holds whole LN_ROWS blocks:
// ln_rows zero-fills the rows of the last block past `rows`.
template <int C>
__global__ void __launch_bounds__(256)
ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
          const float* __restrict__ lnb, float eps, bf16* __restrict__ ln,
          int rows) {
  const long row0 = (long)blockIdx.x * LN_ROWS;
  ln_rows<C, LN_ROWS, 8>(x, row0, (int)min((long)LN_ROWS, rows - row0), lns,
                         lnb, eps, true, ln + row0 * C, C);
}

// LayerNorm of `rows` rows of x into ln [rows rounded up to LN_ROWS, C].
cudaError_t run_layernorm(const bf16* x, const float* lns, const float* lnb,
                          bf16* ln, int rows, int C, float eps,
                          cudaStream_t stream) {
  const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS);
  switch (C) {
    case 256: ln_kernel<256><<<grid, 256, 0, stream>>>(x, lns, lnb, eps, ln,
                                                        rows);
      break;
    case 384: ln_kernel<384><<<grid, 256, 0, stream>>>(x, lns, lnb, eps, ln,
                                                        rows);
      break;
    case 512: ln_kernel<512><<<grid, 256, 0, stream>>>(x, lns, lnb, eps, ln,
                                                        rows);
      break;
    case 768: ln_kernel<768><<<grid, 256, 0, stream>>>(x, lns, lnb, eps, ln,
                                                        rows);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- the product ----

struct GemmArgs {
  int M, N, K;                // the chunk's rows; output width; depth
  const float* bias;          // [N] (EPI_BIAS: or null)
  const bf16* x;              // EPI_OUT: the residual [M, N]
  const float* gamma;         // EPI_OUT: LayerScale [N] or null
  int use_residual;           // EPI_OUT
  int store_z;                // EPI_GELU: also z (tmZ)
  Drop drop;                  // EPI_GELU: site 2; EPI_OUT: site 3 or 1
  uint32_t row0;              // the chunk's first global row
  float* out;                 // EPI_F32, EPI_ACC: float32 [M, N]
  int M2, N2;                 // EPI_ACC: the second problem (M2 = 0: none)
  float* out2;                //   its float32 [M2, N2], same K
};

// The first global row, column and problem of output tile t (the first
// problem's tiles0 tiles, then the second's).
__device__ __forceinline__ void tile_at(const GemmArgs& g, int t, int tiles0,
                                        int& second, int& m0, int& n0) {
  second = t >= tiles0;
  const int u = second ? t - tiles0 : t;
  const int nt = (second ? g.N2 : g.N) / BN;
  m0 = u / nt * BM;
  n0 = u % nt * BN;
}

// Byte offset of (r, c) in a consumer's staged 64 x 128 output: two boxes
// of 64 x 64 side by side, each in TMA's 128-byte swizzle.
__device__ __forceinline__ unsigned out_offset(int r, int c) {
  return (c >> 6) * 8192 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// The exact GELU, 0.5 z (1 + erf(z / sqrt 2)), with the TPU kernel's erf:
// Abramowitz-Stegun 7.1.26 (pallas_attention.py:1293 _erf_poly, max abs
// error 1.5e-7), its reciprocal and exponential on the special-function
// unit (rcp.approx, ex2; ~1e-7 relative). It is half the arithmetic of
// CUDA's erff, and the epilogue's arithmetic is what a product's tile
// waits for.
__device__ __forceinline__ float gelu(float z) {
  const float ax = fabsf(z) * 0.70710678118654752f;
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, ax, 1.f)));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf_ax = 1.f - p * exp2f(-ax * ax * 1.4426950408889634f);
  return 0.5f * z * (1.f + copysignf(erf_ax, z));
}

// The staged output may be written again once its last stores have read it.
__device__ __forceinline__ void staging_free(int tid, int bar) {
  if (tid == 0) bulk_wait_read();
  named_sync(bar);
}

// TMA-store a consumer's staged 64 x 128 output (rows m0.., columns n0..)
// once every thread of the consumer has written it.
__device__ __forceinline__ void store_staged(const CUtensorMap* map,
                                             const uint8_t* tile, int n0,
                                             int m0, int tid, int bar) {
  fence_proxy_async();
  named_sync(bar);
  if (tid == 0) {
    tma_store(map, tile, n0, m0);
    tma_store(map, tile + 8192, n0 + 64, m0);
    bulk_commit();
  }
}

// acc + bias, cast to bf16, into the consumer's staged output (z of
// EPI_GELU's z form; the whole epilogue of EPI_BIAS).
__device__ __forceinline__ void stage_bias_cast(const float (&acc)[BN / 2],
                                                const float* bias, int n0,
                                                unsigned tile_addr, int warp,
                                                int lane) {
#pragma unroll
  for (int c8 = 0; c8 < BN / 8; ++c8) {
    const int col = c8 * 8 + 2 * (lane & 3);
    const float2 bb = bias == nullptr ? make_float2(0.f, 0.f)
        : *reinterpret_cast<const float2*>(bias + n0 + col);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + (lane >> 2) + 8 * hr;
      st_shared(tile_addr + out_offset(r, col),
                pack_bf16(acc[c8 * 4 + 2 * hr] + bb.x,
                          acc[c8 * 4 + 2 * hr + 1] + bb.y));
    }
  }
}

template <int EPI, bool AT, bool BT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap tmA,
          const __grid_constant__ CUtensorMap tmB,
          const __grid_constant__ CUtensorMap tmD,
          const __grid_constant__ CUtensorMap tmZ,
          const __grid_constant__ CUtensorMap tmA2,
          const __grid_constant__ CUtensorMap tmB2, const GemmArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out_tiles = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + 4 * OUT);
  uint64_t* empty = full + STAGES;
  // order[p] completes a phase when the other pair has waited for every
  // stage of its tile, so that pair p waits on a stage at most one phase
  // ahead of the producer (a parity wait cannot tell two phases apart)
  uint64_t* order = empty + STAGES;

  const int tiles0 = (g.M + BM - 1) / BM * (g.N / BN);
  const int total =
      tiles0 + (g.M2 > 0 ? (g.M2 + BM - 1) / BM * (g.N2 / BN) : 0);
  const int ktiles = (g.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);   // every thread of the pair
    }
    mbar_init(&order[0], 256);
    mbar_init(&order[1], 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, in tile order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int pos = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int second, m0, n0;
        tile_at(g, t, tiles0, second, m0, n0);
        const CUtensorMap* ma = second ? &tmA2 : &tmA;
        const CUtensorMap* mb = second ? &tmB2 : &tmB;
        for (int kt = 0; kt < ktiles; ++kt, ++pos) {
          const int s = pos % STAGES;
          mbar_wait(&empty[s], ((pos / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          if (AT) {        // two boxes of 64 columns of M, 64 rows of K
            tma_load(st, ma, m0, kt * BK, &full[s]);
            tma_load(st + 8192, ma, m0 + 64, kt * BK, &full[s]);
          } else {
            tma_load(st, ma, kt * BK, m0, &full[s]);
          }
          if (BT) {        // one box of 128 rows of N, 64 columns of K
            tma_load(st + A_BYTES, mb, kt * BK, n0, &full[s]);
          } else {
            tma_load(st + A_BYTES, mb, n0, kt * BK, &full[s]);
            tma_load(st + A_BYTES + 8192, mb, n0 + 64, kt * BK, &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: pair p takes the block's tiles p, p + 2, ...; its
    // warpgroup q the tile's rows 64 q.. ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
    const int cw = wg - 1, p = cw >> 1, q = cw & 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int bar = 1 + cw;
    const uint8_t* tile = out_tiles + cw * OUT;
    const unsigned tile_addr = smem_addr(tile);
    float acc[BN / 2];

    for (int i = p; blockIdx.x + (long)i * gridDim.x < total; i += 2) {
      const int t = blockIdx.x + i * gridDim.x;
      int second, m0, n0;
      tile_at(g, t, tiles0, second, m0, n0);
      // ---- mainloop, after tile i - 1's ----
      if (i > 0) mbar_wait(&order[p], ((i - 1) >> 1) & 1);
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int pos = i * ktiles + kt, s = pos % STAGES;
        mbar_wait(&full[s], (pos / STAGES) & 1);
        // warpgroup q's A: rows 64 q.. of the K-major tile, or box q of
        // the M-major one (both 8192 q bytes in)
        const unsigned a = smem_addr(smem + s * STAGE) + q * 8192;
        const unsigned b = smem_addr(smem + s * STAGE + A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma<AT, !BT>(acc,
                        AT ? desc128(a + kk * 2048, 8192, 1024)
                           : desc128(a + kk * 32, 16, 1024),
                        BT ? desc128(b + kk * 32, 16, 1024)
                           : desc128(b + kk * 2048, 8192, 1024),
                        kt > 0 || kk > 0);
        wgmma_commit();
        fence_regs(acc);
        if (kt > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      mbar_arrive(&order[p ^ 1]);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[prev]);

      // ---- epilogue: fragment j holds row 16 warp + lane/4 + 8 (j%4 >=
      // 2), column 8 (j/4) + 2 (lane%4) + j%2 ----
      const int mt0 = m0 + 64 * q;   // the consumer's first chunk row
      if constexpr (EPI == EPI_F32 || EPI == EPI_ACC) {
        float* out = second ? g.out2 : g.out;
        const int M = second ? g.M2 : g.M, N = second ? g.N2 : g.N;
#pragma unroll
        for (int c8 = 0; c8 < BN / 8; ++c8) {
          const int col = n0 + c8 * 8 + 2 * (lane & 3);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = mt0 + warp * 16 + (lane >> 2) + 8 * hr;
            if (row >= M) continue;
            float2* o = reinterpret_cast<float2*>(out + (long)row * N + col);
            float2 v = make_float2(acc[c8 * 4 + 2 * hr],
                                   acc[c8 * 4 + 2 * hr + 1]);
            if (EPI == EPI_ACC) {
              const float2 was = *o;
              v.x += was.x;
              v.y += was.y;
            }
            *o = v;
          }
        }
        continue;   // nothing staged
      } else if constexpr (EPI == EPI_BIAS) {
        staging_free(tid, bar);
        stage_bias_cast(acc, g.bias, n0, tile_addr, warp, lane);
      } else if constexpr (EPI == EPI_GELU) {
        if (g.store_z) {
          staging_free(tid, bar);
          stage_bias_cast(acc, g.bias, n0, tile_addr, warp, lane);
          store_staged(&tmZ, tile, n0, mt0, tid, bar);
        }
        staging_free(tid, bar);
#pragma unroll
        for (int c8 = 0; c8 < BN / 8; ++c8) {
          const int col = c8 * 8 + 2 * (lane & 3);
          const float2 bb =
              *reinterpret_cast<const float2*>(g.bias + n0 + col);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + (lane >> 2) + 8 * hr;
            float a0 = gelu(acc[c8 * 4 + 2 * hr] + bb.x);
            float a1 = gelu(acc[c8 * 4 + 2 * hr + 1] + bb.y);
            if (g.drop.on) {
              const uint32_t grow = g.row0 + (uint32_t)(mt0 + r);
              a0 = g.drop.apply(a0, grow, n0 + col);
              a1 = g.drop.apply(a1, grow, n0 + col + 1);
            }
            st_shared(tile_addr + out_offset(r, col), pack_bf16(a0, a1));
          }
        }
      } else {
        staging_free(tid, bar);
#pragma unroll
        for (int c8 = 0; c8 < BN / 8; ++c8) {
          const int col = c8 * 8 + 2 * (lane & 3), gc = n0 + col;
          const float2 bb = *reinterpret_cast<const float2*>(g.bias + gc);
          float2 gm = make_float2(1.f, 1.f);
          if (g.gamma != nullptr)
            gm = *reinterpret_cast<const float2*>(g.gamma + gc);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + (lane >> 2) + 8 * hr;
            const int row = mt0 + r;      // chunk row
            float y0 = acc[c8 * 4 + 2 * hr] + bb.x;
            float y1 = acc[c8 * 4 + 2 * hr + 1] + bb.y;
            if (g.drop.on) {
              const uint32_t grow = g.row0 + (uint32_t)row;
              y0 = g.drop.apply(y0, grow, gc);
              y1 = g.drop.apply(y1, grow, gc + 1);
            }
            if (g.gamma != nullptr) {
              y0 = __fmul_rn(y0, gm.x);
              y1 = __fmul_rn(y1, gm.y);
            }
            // rows past the chunk are computed but never stored
            if (g.use_residual && row < g.M) {
              const float2 r2 = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      g.x + (long)row * g.N + gc));
              y0 += r2.x;
              y1 += r2.y;
            }
            st_shared(tile_addr + out_offset(r, col), pack_bf16(y0, y1));
          }
        }
      }
      store_staged(&tmD, tile, n0, mt0, tid, bar);
    }
    if (tid == 0) bulk_wait();
  }
}

// ---- host side ----

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, a libcuda function, looked up through the CUDA
// runtime so that this library links no libcuda
EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A row-major bf16 [outer, inner] matrix at `base`, read or written in
// boxes of box_outer rows x 64 columns with the 128-byte swizzle; reads
// past `outer` give zeros, writes there are dropped. The last maps made are kept: a call meets the same weights, and
// mostly the same scratch and activation addresses, as the one before.
bool tensor_map(CUtensorMap* map, const void* base, int inner, int outer,
                int box_outer) {
  struct Entry {
    const void* base;
    int inner, outer, box_outer;
    CUtensorMap map;
  };
  constexpr int CACHED = 32;
  static Entry cache[CACHED];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.inner == inner && e.outer == outer &&
        e.box_outer == box_outer) {
      *map = e.map;
      return true;
    }
  }
  EncodeFn enc = encoder();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(bf16)};
  cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  cuuint32_t elem[2] = {1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = Entry{base, inner, outer, box_outer, *map};
  next = (next + 1) % CACHED;
  used = std::max(used, next == 0 ? CACHED : next);
  return true;
}

constexpr int MAX_DEVICES = 64;

int sm_count(int dev) {
  static int n[MAX_DEVICES] = {};
  if (n[dev] == 0)
    cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

// The current device, or -1 past MAX_DEVICES.
int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return -1;
  return dev;
}

// D [M, N] = epilogue(A [M, K] B [K, N]) on tiles of 128 x 128 (A as
// [K, M] with AT, B as [N, K] with BT). N a multiple of 128, K of 64 but
// with AT; Z: EPI_GELU's z (or null). EPI_F32 and EPI_ACC write g.out
// (D, Z null); EPI_ACC's second problem (g.M2 > 0) reads A2 and B2.
template <int EPI, bool AT = false, bool BT = false>
cudaError_t run_gemm(const bf16* A, const bf16* B, bf16* D, bf16* Z,
                     const GemmArgs& g, cudaStream_t stream,
                     const bf16* A2 = nullptr, const bf16* B2 = nullptr) {
  constexpr bool F32 = EPI == EPI_F32 || EPI == EPI_ACC;
  if (g.M < 1 || g.N % BN != 0 || g.K < 1 || (!AT && g.K % BK != 0) ||
      (F32 && g.out == nullptr) ||
      (g.M2 > 0 && (EPI != EPI_ACC || g.N2 % BN != 0 || g.out2 == nullptr ||
                    A2 == nullptr || B2 == nullptr)))
    return cudaErrorInvalidValue;
  auto map_a = [&](CUtensorMap* m, const bf16* a, int M) {
    return AT ? tensor_map(m, a, M, g.K, 64) : tensor_map(m, a, g.K, M, BM);
  };
  auto map_b = [&](CUtensorMap* m, const bf16* b, int N) {
    return BT ? tensor_map(m, b, g.K, N, BN) : tensor_map(m, b, N, g.K, BK);
  };
  CUtensorMap ma, mb, md, mz, ma2, mb2;
  if (!map_a(&ma, A, g.M) || !map_b(&mb, B, g.N))
    return cudaErrorInvalidValue;
  md = mz = ma2 = ma;
  mb2 = mb;
  if (!F32 && (!tensor_map(&md, D, g.N, g.M, 64) ||
               !tensor_map(&mz, Z != nullptr ? Z : D, g.N, g.M, 64)))
    return cudaErrorInvalidValue;
  if (g.M2 > 0 && (!map_a(&ma2, A2, g.M2) || !map_b(&mb2, B2, g.N2)))
    return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  static bool sized[MAX_DEVICES] = {};   // the shared-memory attribute set
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90<EPI, AT, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  const int tiles = (g.M + BM - 1) / BM * (g.N / BN) +
                    (g.M2 > 0 ? (g.M2 + BM - 1) / BM * (g.N2 / BN) : 0);
  gemm_sm90<EPI, AT, BT><<<std::min(tiles, sm_count(dev)), THREADS, SMEM,
                           stream>>>(ma, mb, md, mz, ma2, mb2, g);
  return cudaGetLastError();
}

}  // namespace
