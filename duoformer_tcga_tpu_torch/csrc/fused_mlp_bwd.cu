// The recompute-from-x backward of the fused MLP residual branch for Hopper
// (sm_90a). The forward (csrc/fused_mlp_residual.cu) is
//
//     y = x + fc2( gelu_erf( fc1( LN(x) ) ) ).
//
// Given x and the upstream gradient g (both [rows, C] bf16), w1 [C, H] and
// w2 [H, C] (bf16, (in, out) layout) and the float32 LN scale/bias and b1,
// this backward recomputes LN and fc1 and writes
//     dx [rows, C] bf16   the input cotangent: the LN backward of dln, + g
//     ln [rows, C] bf16   the LN output            (for dW1 = ln^T dz)
//     h  [rows, H] bf16   gelu(z), z = ln w1 + b1  (for dW2 = h^T g)
//     dz [rows, H] bf16   (g w2^T) * gelu'(z)      (for dW1 and db1)
// and the float32 column sums dlns = sum(dln * xhat), dlnb = sum(dln). The
// weight gradients are large products the caller runs outside, as the JAX
// package leaves them to XLA.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_mlp_bwd_kernel (:1597), driven by _fused_mlp_bwd_impl (:1634): the
// MLP backward when the forward saved no hidden (DUOFORMER_MLP_SAVE_HIDDEN=0
// with DUOFORMER_PALLAS_MLP_BWD=1; in the port mlp_save_hidden=False), once
// in every ScaleBlock of the memory-lean training step.
//
// Rounding points are the TPU kernel's: LN with float32 statistics, ln in
// bf16; z = ln w1 + b1 in float32; h = bf16(z * Phi(z)) from the float32
// z (the save-hidden route takes it from the bf16 z); dh = g w2^T in
// float32; dz = bf16(dh * (Phi(z) + z * phi(z))); dln = dz w1^T from the
// bf16 dz, in float32; the LN backward in float32 and dx = bf16(dxf + g).
// Phi is the TPU kernel's erf, the Abramowitz-Stegun polynomial (max abs
// error 1.5e-7), its reciprocal and exponential on the special-function
// unit; phi(z) = exp(-z^2 / 2) / sqrt(2 pi) reuses that exponential.
//
// Design. One C entry per call walks chunks of rows (the wrapper's
// mlp_bwd_row_chunks: every chunk but the last a multiple of 128 rows, the
// chunk's float32 scratch within MLP_BWD_SCRATCH_BYTES). Per chunk it
// launches
//   1. ln_stats_kernel (csrc/chain_rows.cuh): ln, into the caller's
//      output, and each row's mean and 1/std;
//   2. dgelu_sm90, one persistent TMA-fed wgmma product with two K-runs
//      into one output tile: z = ln w1 (w1 as stored, through wgmma's
//      transpose bit), then dh = g w2^T (w2 read K-major), each C deep.
//      It is csrc/gemm_sm90.cuh's product (its PTX wrappers, tensor maps,
//      ring of TMA stages and staged TMA stores) on 128 x 128 tiles with
//      one pair of consumer warpgroups, each 64 rows of a tile in two
//      m64n128 float32 accumulators: 128 registers, which the header's
//      two pairs (112 registers a thread) cannot hold, and 128 x 64 tiles
//      ran at 310 TFLOP/s against this form's 575 (PERF.md §6). With one
//      pair no other pair's products run under a tile's epilogue, so the
//      epilogue is spread under the products: while the dh run's stages
//      are multiplied, each stage's share of z's fragments is turned into
//      h = bf16(z Phi(z)) (staged, TMA-stored after the run) and gelu'(z),
//      kept in z's registers; after the run dz = bf16(dh gelu'(z)) is
//      staged and stored. b1 is added to z there; z and dh never leave the
//      chip;
//   3. gemm_sm90<EPI_F32, BT> (csrc/gemm_sm90.cuh): dln = dz w1^T in
//      float32 into the chunk's scratch, w1 read K-major;
//   4. ln_bwd_rows_kernel (csrc/chain_rows.cuh): the LN backward by rows,
//      + g, dx rounded once, and per-block column sums;
//   5. sum_rows_kernel: the chunk's partial rows in order;
// and after the last chunk the chunks' rows in order. Chunks run in stream
// order and nothing is summed with atomics, so every output, dlns and dlnb
// included, is bit-reproducible.
//
// What bounds it on this card. 6 rows C H flops (z, dh, dln: 0.539 ms at
// 37,632 rows and C = 768) against 2 rows (4C + 2H) bytes of activations in
// and out: bound by the operations. The chain moves dz once more (written
// by the product, read by dln) and the float32 dln through device memory
// (or L2, at the chunk's size). Every row tile reads its weight slabs from
// L2 again (no cluster multicast yet). The old design (one block of 8 warps
// per 32 rows on mma.sync, streaming w1 twice and w2 once from L2 through
// cp.async slabs) took 4.885 ms at 37,632 rows (PERF.md §6).

#include "chain_rows.cuh"
#include "gemm_sm90.cuh"

namespace {

// ---- the z/dh product ----

// h = z Phi(z) and gelu'(z) = Phi(z) + z phi(z) of the float32 z, Phi with
// the TPU kernel's erf (gemm_sm90.cuh's gelu), phi from its exponential.
__device__ __forceinline__ void gelu_and_slope(float z, float& h,
                                               float& slope) {
  const float ax = fabsf(z) * 0.70710678118654752f;
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, ax, 1.f)));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                               1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float e = exp2f(-ax * ax * 1.4426950408889634f);   // exp(-z^2 / 2)
  const float Phi = 0.5f * (1.f + copysignf(1.f - p * e, z));
  const float phi = 0.39894228040143268f * e;
  h = z * Phi;
  slope = Phi + z * phi;
}

// shared memory: a ring of stages (the 128 x 64 A tile, ln or g, and the
// 64 x 128 B tile, w1 or w2), each consumer's staged h and dz (64 x 128
// each), the mbarriers
constexpr int DG_THREADS = 384;                    // producer + one pair
constexpr int DG_STAGE = A_BYTES + BK * BN * 2;    // 32 KB
constexpr int DG_OUT = 2 * 64 * BN * 2;
constexpr int DG_STAGES = (SMEM_MAX - 2 * DG_OUT - 2048) / DG_STAGE;   // 5
constexpr int DG_SMEM = DG_STAGES * DG_STAGE + 2 * DG_OUT + 2048;
static_assert(DG_SMEM <= SMEM_MAX, "the z/dh product's shared memory");

// h [M, N] = bf16(gelu(ln w1 + b1)), dz [M, N] = bf16((g w2^T) gelu'(ln w1
// + b1)) for ln, g [M, K], w1 [K, N] as stored and w2 [N, K], K = KT1 * 64,
// on 128 x 128 tiles: the producer warpgroup's one thread keeps the ring
// full in tile order, each tile's KT1 stages of (ln, w1) then KT1 of (g,
// w2); consumer warpgroup q takes rows 64 q.. of every tile into two
// m64n128 float32 accumulators, z then dh.
template <int KT1>
__global__ void __launch_bounds__(DG_THREADS, 1)
dgelu_sm90(const __grid_constant__ CUtensorMap tmLN,
           const __grid_constant__ CUtensorMap tmW1,
           const __grid_constant__ CUtensorMap tmG,
           const __grid_constant__ CUtensorMap tmW2,
           const __grid_constant__ CUtensorMap tmH,
           const __grid_constant__ CUtensorMap tmDZ,
           const float* __restrict__ b1, int M, int N) {
  constexpr int ktiles = 2 * KT1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out_tiles = smem + DG_STAGES * DG_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + 2 * DG_OUT);
  uint64_t* empty = full + DG_STAGES;

  const int nt = N / BN;
  const int total = (M + BM - 1) / BM * nt;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int pos = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int m0 = t / nt * BM, n0 = t % nt * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++pos) {
          const int s = pos % DG_STAGES;
          mbar_wait(&empty[s], ((pos / DG_STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * DG_STAGE;
          mbar_expect_tx(&full[s], DG_STAGE);
          if (kt < KT1) {
            tma_load(st, &tmLN, kt * BK, m0, &full[s]);
            tma_load(st + A_BYTES, &tmW1, n0, kt * BK, &full[s]);
            tma_load(st + A_BYTES + 8192, &tmW1, n0 + 64, kt * BK, &full[s]);
          } else {
            tma_load(st, &tmG, (kt - KT1) * BK, m0, &full[s]);
            tma_load(st + A_BYTES, &tmW2, (kt - KT1) * BK, n0, &full[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int q = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int bar = 1 + q;
    const uint8_t* tile_h = out_tiles + q * DG_OUT;
    const uint8_t* tile_dz = tile_h + DG_OUT / 2;
    const unsigned h_addr = smem_addr(tile_h), dz_addr = smem_addr(tile_dz);
    float zacc[BN / 2], dacc[BN / 2];

    for (int i = 0; blockIdx.x + (long)i * gridDim.x < total; ++i) {
      const int t = blockIdx.x + i * gridDim.x;
      const int m0 = t / nt * BM, n0 = t % nt * BN, mt0 = m0 + 64 * q;
      int prev = 0;
      for (int kt = 0; kt < KT1; ++kt) {          // z = ln w1
        const int pos = i * ktiles + kt, s = pos % DG_STAGES;
        mbar_wait(&full[s], (pos / DG_STAGES) & 1);
        const unsigned a = smem_addr(smem + s * DG_STAGE) + q * 8192;
        const unsigned b = smem_addr(smem + s * DG_STAGE + A_BYTES);
        fence_regs(zacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma<0, 1>(zacc, desc128(a + kk * 32, 16, 1024),
                      desc128(b + kk * 2048, 8192, 1024), kt > 0 || kk > 0);
        wgmma_commit();
        fence_regs(zacc);
        if (kt > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      // dh = g w2^T; under its stages, h = bf16(gelu(z)) is staged and z's
      // registers take gelu'(z), the 32 fragment pairs spread over the
      // KT1 stages
#pragma unroll
      for (int u = 0; u < KT1; ++u) {
        const int pos = i * ktiles + KT1 + u, s = pos % DG_STAGES;
        mbar_wait(&full[s], (pos / DG_STAGES) & 1);
        const unsigned a = smem_addr(smem + s * DG_STAGE) + q * 8192;
        const unsigned b = smem_addr(smem + s * DG_STAGE + A_BYTES);
        fence_regs(dacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma<0, 0>(dacc, desc128(a + kk * 32, 16, 1024),
                      desc128(b + kk * 32, 16, 1024), u > 0 || kk > 0);
        wgmma_commit();
        fence_regs(dacc);
        if (u == 0) {     // z's last group has retired
          wgmma_wait<1>();
          fence_regs(zacc);
          mbar_arrive(&empty[prev]);
          staging_free(tid, bar);
        }
#pragma unroll
        for (int pr = 0; pr < BN / 4; ++pr) {
          if (pr * KT1 / (BN / 4) != u) continue;
          const int c8 = pr >> 1, hr = pr & 1, j = c8 * 4 + 2 * hr;
          const int col = c8 * 8 + 2 * (lane & 3);
          const int r = warp * 16 + (lane >> 2) + 8 * hr;
          const float2 bb = *reinterpret_cast<const float2*>(b1 + n0 + col);
          float h0, h1;
          gelu_and_slope(zacc[j] + bb.x, h0, zacc[j]);
          gelu_and_slope(zacc[j + 1] + bb.y, h1, zacc[j + 1]);
          st_shared(h_addr + out_offset(r, col), pack_bf16(h0, h1));
        }
        if (u > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      store_staged(&tmH, tile_h, n0, mt0, tid, bar);
      wgmma_wait<0>();
      fence_regs(dacc);
      mbar_arrive(&empty[prev]);
      // dz = bf16(dh gelu'(z)); the staged dz was last read by the
      // previous tile's store, which staging_free above waited for
#pragma unroll
      for (int c8 = 0; c8 < BN / 8; ++c8) {
        const int col = c8 * 8 + 2 * (lane & 3);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = warp * 16 + (lane >> 2) + 8 * hr;
          const int j = c8 * 4 + 2 * hr;
          st_shared(dz_addr + out_offset(r, col),
                    pack_bf16(dacc[j] * zacc[j], dacc[j + 1] * zacc[j + 1]));
        }
      }
      store_staged(&tmDZ, tile_dz, n0, mt0, tid, bar);
    }
    if (tid == 0) bulk_wait();
  }
}

// h and dz of a chunk's M rows (ln, g, h, dz from its first row); H a
// multiple of 128.
template <int C>
cudaError_t run_dgelu(const bf16* ln, const bf16* g, const bf16* w1,
                      const bf16* w2, const float* b1, bf16* h, bf16* dz,
                      int M, int H, cudaStream_t stream) {
  constexpr int KT1 = C / BK;
  CUtensorMap mln, mw1, mg, mw2, mh, mdz;
  if (!tensor_map(&mln, ln, C, M, BM) || !tensor_map(&mg, g, C, M, BM) ||
      !tensor_map(&mw1, w1, H, C, BK) || !tensor_map(&mw2, w2, C, H, BN) ||
      !tensor_map(&mh, h, H, M, 64) || !tensor_map(&mdz, dz, H, M, 64))
    return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  static bool sized[MAX_DEVICES] = {};
  if (!sized[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgelu_sm90<KT1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DG_SMEM);
    if (err != cudaSuccess) return err;
    sized[dev] = true;
  }
  const int tiles = (M + BM - 1) / BM * (H / BN);
  dgelu_sm90<KT1><<<std::min(tiles, sm_count(dev)), DG_THREADS, DG_SMEM,
                    stream>>>(mln, mw1, mg, mw2, mh, mdz, b1, M, H);
  return cudaGetLastError();
}

// ---- the chain ----

// The scratch of one call, carved from one buffer in the order of the
// wrapper's mlp_bwd_scratch_bytes (each piece 256-byte aligned), for chunks
// of at most chunk_rows rows: per chunk dln, the LN statistics and the LN
// backward's partial rows; then the chunks' sums and the column sums of g
// (ln_bwd_rows_kernel's third, which no output takes).
struct MlpBwdScratch {
  float *dln, *stats, *part, *chunk_sums, *gsum;
  size_t bytes;

  MlpBwdScratch(char* base, int rows, int chunk_rows, int C) {
    const long n = rows < chunk_rows ? rows : chunk_rows;
    const int nchunks = (rows + chunk_rows - 1) / chunk_rows;
    size_t off = 0;
    auto take = [&](size_t b) -> float* {
      char* p = base + off;
      off += (b + 255) / 256 * 256;
      return reinterpret_cast<float*>(p);
    };
    dln = take(4 * n * C);
    stats = take(4 * 2 * n);
    part = take(4 * ((n + RP_ROWS - 1) / RP_ROWS) * 3 * C);
    chunk_sums = take(4 * (long)nchunks * 3 * C);
    gsum = take(4 * (long)C);
    bytes = off;
  }
};

template <int C>
cudaError_t backward(const bf16* x, const bf16* g, const float* lns,
                     const float* lnb, const bf16* w1, const float* b1,
                     const bf16* w2, bf16* dx, bf16* ln, bf16* h, bf16* dz,
                     float* sums, char* scratch, size_t scratch_bytes,
                     int rows, int hidden, int chunk_rows, float eps,
                     cudaStream_t stream) {
  const MlpBwdScratch sc(scratch, rows, chunk_rows, C);
  if (sc.bytes > scratch_bytes) return cudaErrorInvalidValue;
  const int nchunks = (rows + chunk_rows - 1) / chunk_rows;
  for (int ci = 0; ci < nchunks; ++ci) {
    const long r0 = (long)ci * chunk_rows;
    const int n = rows - r0 < chunk_rows ? (int)(rows - r0) : chunk_rows;
    const bf16* xc = x + r0 * C;
    const bf16* gc = g + r0 * C;
    bf16* lnc = ln + r0 * C;
    bf16* dzc = dz + r0 * hidden;
    ln_stats_kernel<C><<<(n + 7) / 8, 256, 0, stream>>>(xc, lns, lnb, eps,
                                                         lnc, sc.stats, n);
    CHAIN_CHECK(cudaGetLastError());
    CHAIN_CHECK(run_dgelu<C>(lnc, gc, w1, w2, b1, h + r0 * hidden, dzc, n,
                             hidden, stream));
    GemmArgs l{n, C, hidden, nullptr};
    l.out = sc.dln;
    CHAIN_CHECK((run_gemm<EPI_F32, false, true>(dzc, w1, nullptr, nullptr,
                                                l, stream)));
    const int rb = (n + RP_ROWS - 1) / RP_ROWS;
    ln_bwd_rows_kernel<C><<<rb, 256, 0, stream>>>(
        sc.dln, xc, gc, lns, sc.stats, dx + r0 * C, sc.part, n, 1, 1,
        INERT.pdrop, r0);
    CHAIN_CHECK(cudaGetLastError());
    CHAIN_CHECK(sum_rows(sc.part, rb, 3 * C, sc.chunk_sums + (long)ci * 3 * C,
                         3 * C, nullptr, stream));
  }
  // dlns | dlnb; g's sums into the scratch
  return sum_rows(sc.chunk_sums, nchunks, 3 * C, sums, 2 * C, sc.gsum,
                  stream);
}

}  // namespace

extern "C" {

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: rows >= 1, C in {256, 384,
// 512, 768}, hidden a positive multiple of 128, every pointer 32-byte
// aligned; chunk_rows the rows of every chunk but the last, a multiple of
// 128 where rows exceeds it. sums is float32 [2C]: dlns | dlnb. scratch: a
// device buffer of scratch_bytes, 256-byte aligned, at least what the
// wrapper's mlp_bwd_scratch_bytes gives for the chunk plus the chunks'
// sums and g's (checked).
int launch_fused_mlp_bwd(const void* x, const void* g, const void* lns,
                         const void* lnb, const void* w1, const void* b1,
                         const void* w2, void* dx, void* ln, void* h,
                         void* dz, void* sums, void* scratch,
                         long long scratch_bytes, int rows, int C,
                         int hidden, int chunk_rows, float eps,
                         void* stream) {
  if (rows < 1 || hidden <= 0 || hidden % 128 != 0 || chunk_rows < 1 ||
      (chunk_rows < rows && chunk_rows % BM != 0))
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,    \
      (const bf16*)w1, (const float*)b1, (const bf16*)w2, (bf16*)dx,       \
      (bf16*)ln, (bf16*)h, (bf16*)dz, (float*)sums, (char*)scratch,        \
      (size_t)scratch_bytes, rows, hidden, chunk_rows, eps,                \
      (cudaStream_t)stream
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
