// Backward of the fused attention residual branch for Hopper (sm_90a).
//
// The forward (csrc/fused_attention_residual.cu) is
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) ).
// Given x and the upstream gradient g (both [n_seg, S, C] bf16), this kernel
// recomputes LN, qkv and the softmax on chip and writes
//     dx   [n_seg, S, C] bf16   the input cotangent (LN backward, + g)
//     ln   [rows, C]     bf16   the LN output (full form only: the bare
//                               form's ln is x itself)
//     attn [rows, C]     bf16   the attention output, proj's input
//     dqkv [rows, 3C]    bf16   the cotangent of qkv (q | k | v columns)
// and the float32 column sums dlns = sum(dln * xhat), dlnb = sum(dln),
// dbqkv = sum(dqkv), dbproj = sum(g), each [C] or [3C]. The weight
// gradients dwqkv = ln^T dqkv and dwproj = attn^T g are large products the
// caller runs outside, as the JAX package leaves them to XLA; or, in the
// dw form below, this kernel forms them in place of ln, attn and dqkv.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py,
// _fused_block_bwd_kernel with dw=False (the default) and with dw=True,
// driven by _fused_block_bwd_impl. Both forms run in a training step's
// backward (dw=True in the memory-lean step): the
// full form (LN + residual) in every ScaleBlock at S=6, the bare form
// (use_ln = use_residual = 0) in every PatchBlock at S=50.
//
// The reg instantiation (_far_reg_bwd, pallas_attention.py:809-822,
// 848-870, 896-905), as runtime arguments: a first small kernel (geff_kernel,
// csrc/reg_grad.cuh, which the 65..86-token chain shares) forms the
// upstream gradient the branch saw, geff = bf16(bf16(g * proj mask / keep)
// * gamma), and writes gm = bf16(g * proj mask / keep) when the proj
// dropout is on; the main kernel streams geff where it streamed g, drops
// the bf16 probabilities for P.V and dv with the forward's mask, drops and
// rescales dp, and takes the softmax Jacobian with the UNDROPPED float32 p;
// dbproj sums the float32 proj-masked g without gamma (the caller's
// dgamma and dbproj identities need it so), and the residual adds raw g.
// Every mask is the forward's, regenerated from csrc/dropout_hash.cuh at
// global positions: this kernel's row blocks are not the forward's.
//
// Rounding points are the TPU kernel's (pallas_attention.py:791-918): ln
// in bf16; qkv in bf16 after its bias; p in float32 for the softmax
// backward and in bf16 for P.V and dv; each head's output o in bf16; each
// head's slice of dattn = g wproj^T in bf16; ds * scale in bf16; dq, dk, dv
// in bf16; dln = dqkv wqkv^T accumulated in float32 from the bf16 dqkv;
// the LN backward in float32 and dx rounded once. dbqkv sums the rounded
// dqkv.
//
// Design. One block of 8 warps takes RT / S whole segments, RT = 48 rows
// for S <= 48 (8 segments at S=6) and 64 rows up to S = 64 (one segment at
// S=50), as in the forward; a ragged last block masks its missing rows and
// nothing is padded in device memory. The block normalises its rows once
// into shared memory (keeping each row's mean and 1/std), then walks the
// heads. Per head h it
//   1. recomputes q | k | v [RT, 192] (wqkv slabs of 64 rows x the head's
//      192 columns), the scores within each segment and the softmax;
//   2. writes o = P.V to attn;
//   3. computes do = g wproj[h rows]^T [RT, 64] (slabs of 64 columns of g
//      and of the head's 64 rows of wproj);
//   4. dv = P^T do, dp = do v^T, ds = p (dp - rowsum(dp p)) * scale,
//      dq = ds k, dk = ds^T q, all on chip (the transposed operands come
//      from ldmatrix .trans), and writes dq | dk | dv to dqkv;
//   5. adds dqkv_h wqkv[:, head]^T into a float32 [RT, C] dln accumulator
//      held in registers (the same wqkv slabs as 1, streamed again).
// Neither qkv nor dqkv is ever whole on chip: one S=50 segment's qkv is
// 230 KB, more than a block's shared memory. Weights and g stream through a
// double-buffered cp.async ring. After the last head the block finishes the
// LN backward from the accumulator (row sums across the 8 warps through
// shared memory), writes dx, and writes its column sums of dln * xhat,
// dln, dqkv and g as one float32 partial row [6C]. The TPU kernel summed
// those over its sequential grid in revisited blocks; a CUDA grid runs in
// parallel, so a second, small kernel adds the blocks' partials in a fixed
// order. No atomics: the sums do not depend on the order blocks ran in.
//
// The dw form (_fused_block_bwd_kernel with dw=True, pallas_attention.py:
// 885-895; switched on by non-null dwqkv and dwA): ln, attn and dqkv are
// not written. Instead the block adds its rows' weight-gradient products
// into two float32 accumulators the caller zeroed,
//     dwqkv [C, 3C] += ln^T dqkv     (the bare form's ln is x)
//     dwA   [C, C]  += attn^T gacc   (gacc = bf16(g * proj mask / keep)
//                                     with the proj dropout on, else g),
// bf16 operands with float32 sums, as the TPU kernel's. Per head h, after
// step 3 the head's output o (bf16, kept in the dp buffer until step 4
// needs it) times the block's gacc rows, streamed in 64-column slabs
// through the same ring (the proj mask applied in shared memory), gives
// rows [h*64, h*64 + 64) of dwA; after step 4 ln^T dqkv_h gives the
// head's 192 columns of dwqkv, from sLN and sQKV as they stand. The TPU
// kernel kept the two accumulators (9.4 MB at C=768) in VMEM over its
// sequential grid; here every block runs in parallel and no SM could hold
// them, so each block adds its products with float2 atomicAdd (red.global)
// into the one accumulator in device memory, which stays in the 50 MB L2.
// The order of those float32 additions changes from run to run, so dwqkv
// and dwA are not bit-reproducible (two launches agree to float32 rounding
// of the sums); every other output is. The proj-masked gacc is formed from
// raw g in shared memory, so the dw form writes no gm.
//
// Layouts. wqkv [C, 3C] and wproj [C, C] come as the forward takes them,
// the JAX package's (in, out) layout, not the TPU kernel's pre-transposed
// copies (pallas_attention.py:990-991, made to save VMEM): ldmatrix reads
// a row-major slab either way, with .trans where the slab is the B operand
// as it stands (the qkv recompute) and without where B is its transpose
// (dattn = g wproj^T, dln = dqkv wqkv^T).
//
// What bounds it on this card. About 2*rows*C*(3C + C + 3C) flops of
// products for the recompute, dattn and dln (plus the per-segment
// attention products) against ~2*rows*(2C + C + C + 3C) bytes of
// activations in and out: compute bound. This kernel is far from the
// tensor-core roof: each block streams wqkv twice and wproj once from L2
// (about 8 MB at C=768) in 36 slabs per head with two block-wide barriers
// each, on mma.sync. wgmma with TMA-fed slabs, multicast of the slabs
// across a cluster and the dln product done per head chunk rather than
// from a second pass over wqkv are the next steps. The dw form adds
// 8*rows*C^2 flops and, per block, 4C^2 float32 atomic additions (9.4 MB
// at C=768) into L2: at 48 rows a block that traffic is about the weight
// slabs' own, so the dw form is expected to cost more than the dw=False
// kernel plus two large matmuls on this card. Wider row tiles in dw mode
// (fewer additions per row) would cut it; they need more shared memory.

#include "reg_grad.cuh"

namespace {

constexpr int D = 64;                  // head width
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KS = 64;                 // rows or columns per weight slab
constexpr int QKV_LD = 3 * D + 8;      // one head's q | k | v (then dqkv)
constexpr int DO_LD = D + 8;           // bf16 do
constexpr int GS_LD = KS + 8;          // dattn slab: wproj rows, then g rows
constexpr int QN = 3 * D / 8 / WARPS;  // qkv n8 tiles per warp (3)

// RT rows per block; C = 64 * heads.
template <int RT, int C_>
struct Shape {
  static constexpr int C = C_;
  static constexpr int H = C / D;
  static constexpr int MT = RT / 16;       // m16 row tiles
  static constexpr int NQ = C / KS;        // dln n8 tiles per warp
  // C = 384 (ViT-S, 6 heads): 6 slabs of 64 a phase, 6 dln tiles a warp,
  // the dw form's dwqkv rows in 24 m16 tiles (3 a warp)
  static_assert(C % KS == 0, "the slabs must tile C");
  static constexpr int SLABS = C / KS;     // slabs per phase of a head
  static constexpr int LN_LD = C + 8;
  static constexpr int S_LD = RT + 4;      // float32 p and dp
  static constexpr int P_LD = RT + 8;      // bf16 p, then ds
  static constexpr int STAGE = (KS * QKV_LD > (D + RT) * GS_LD)
                                   ? KS * QKV_LD : (D + RT) * GS_LD;
  static constexpr int DT = MT * (D / 16);     // 16 x 16 tiles of a head
  static constexpr size_t SMEM =
      sizeof(bf16) * (RT * LN_LD + RT * QKV_LD + RT * P_LD + RT * DO_LD +
                      2 * STAGE) +
      sizeof(float) * (2 * RT * S_LD + 2 * RT);
};

// Slab j of head h's stream: phase 0 (recompute) and phase 2 (dln) take
// wqkv rows [k*KS, k*KS + KS) x the head's q | k | v columns; phase 1
// (dattn) takes wproj rows [h*D, h*D + D) and the block's g rows, columns
// [k*KS, k*KS + KS) of each. g rows at or past R are zeros. (The reg form
// passes geff as g.)
// The dw form adds a phase between 1 and the dln phase: the block's raw g
// rows, columns [k*KS, k*KS + KS), for dwA (rows at or past R zeros).
// *p += (a, b) in device memory, one float2 reduction (sm_90).
__device__ __forceinline__ void atomic_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

template <int RT, int C, bool DW>
__device__ __forceinline__ void load_slab(bf16* dst, int h, int j,
                                          const bf16* wqkv,
                                          const bf16* wproj, const bf16* g,
                                          const bf16* graw, long row0,
                                          int R) {
  typedef Shape<RT, C> Sh;
  const int phase = j / Sh::SLABS, k0 = (j % Sh::SLABS) * KS;
  if (DW && phase == 2) {
    for (int i = threadIdx.x; i < RT * (KS / 8); i += THREADS) {
      const int row = i / (KS / 8), seg = i % (KS / 8);
      bf16* d = dst + row * GS_LD + seg * 8;
      if (row < R)
        cp_async16(d, graw + (row0 + row) * C + k0 + seg * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else if (phase != 1) {
    for (int i = threadIdx.x; i < KS * 3 * (D / 8); i += THREADS) {
      const int row = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
      const int part = rem / (D / 8), seg = rem % (D / 8);
      cp_async16(dst + row * QKV_LD + part * D + seg * 8,
                 wqkv + (long)(k0 + row) * (3 * C) + part * C + h * D +
                     seg * 8);
    }
  } else {
    for (int i = threadIdx.x; i < (D + RT) * (KS / 8); i += THREADS) {
      const int row = i / (KS / 8), seg = i % (KS / 8);
      bf16* d = dst + row * GS_LD + seg * 8;
      if (row < D)
        cp_async16(d, wproj + (long)(h * D + row) * C + k0 + seg * 8);
      else if (row - D < R)
        cp_async16(d, g + (row0 + row - D) * C + k0 + seg * 8);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// DW: the dw form (a template argument, so that the dw=False instantiation
// carries none of its code or registers).
template <int RT, int C, bool DW>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const bf16* __restrict__ gsrc,
                     const float* __restrict__ lns,
                     const float* __restrict__ lnb,
                     const bf16* __restrict__ wqkv,
                     const float* __restrict__ bqkv,
                     const bf16* __restrict__ wproj, bf16* __restrict__ dx,
                     bf16* __restrict__ ln_out, bf16* __restrict__ attn_out,
                     bf16* __restrict__ dqkv_out, float* __restrict__ part,
                     float* __restrict__ dwqkv, float* __restrict__ dwA,
                     int n_seg, int S, float scale, float eps, int use_ln,
                     int use_residual, Drop adrop, Drop pdrop) {
  typedef Shape<RT, C> Sh;
  constexpr int MT = Sh::MT;
  constexpr int NQ = Sh::NQ;
  constexpr int DT = Sh::DT;
  // the dw form keeps each head's bf16 o in the float32 dp buffer
  static_assert(sizeof(float) * Sh::S_LD >= sizeof(bf16) * DO_LD,
                "o does not fit the dp buffer");
  constexpr bool dw = DW;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sLN = reinterpret_cast<bf16*>(smem);
  bf16* sQKV = sLN + RT * Sh::LN_LD;
  bf16* sP = sQKV + RT * QKV_LD;
  bf16* sDO = sP + RT * Sh::P_LD;
  bf16* stage0 = sDO + RT * DO_LD;
  float* sS = reinterpret_cast<float*>(stage0 + 2 * Sh::STAGE);
  float* sD = sS + RT * Sh::S_LD;
  float* sStat = sD + RT * Sh::S_LD;       // mean, 1/std per row
  bf16* sO = reinterpret_cast<bf16*>(sD);  // dw: the head's o, steps 2-3

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;  // mma fragment row / column pair

  const int G = RT / S;                      // segments per block
  const int seg0 = blockIdx.x * G;
  const int R = min(G, n_seg - seg0) * S;    // live rows of this block
  const long row0 = (long)seg0 * S;
  float* bpart = part + (long)blockIdx.x * 6 * C;

  const int per_head = (dw ? 4 : 3) * Sh::SLABS;
  const int total = Sh::H * per_head;
  int s = 0;                                 // slab counter
  load_slab<RT, C, DW>(stage0, 0, 0, wqkv, wproj, gsrc, g, row0, R);
  cp_async_commit();
  // the next slab into the other buffer, then wait for slab s
  auto next_slab = [&]() -> const bf16* {
    if (s + 1 < total)
      load_slab<RT, C, DW>(stage0 + ((s + 1) & 1) * Sh::STAGE,
                           (s + 1) / per_head, (s + 1) % per_head, wqkv,
                           wproj, gsrc, g, row0, R);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    return stage0 + (s & 1) * Sh::STAGE;
  };

  // ---- LayerNorm (or a copy) of the block's rows; ln to device memory ----
  ln_rows<C, RT, WARPS>(x, row0, R, lns, lnb, eps, use_ln, sLN, Sh::LN_LD,
                        sStat);
  __syncthreads();
  if (use_ln && ln_out != nullptr)
    for (int i = threadIdx.x; i < R * (C / 8); i += THREADS) {
      const int r = i / (C / 8), seg = i % (C / 8);
      *reinterpret_cast<uint4*>(ln_out + (row0 + r) * C + seg * 8) =
          *reinterpret_cast<const uint4*>(sLN + r * Sh::LN_LD + seg * 8);
    }

  float qacc[MT][QN][4];                     // qkv recompute, then dattn
  float acc[MT][NQ][4];                      // dln: warp owns columns
#pragma unroll                               // q*64 + warp*8 + [0, 8)
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int h = 0; h < Sh::H; ++h) {
    // ---- 1. q | k | v of head h, KS rows of K at a time ----
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) qacc[m][n][q] = 0.f;
    for (int k = 0; k < Sh::SLABS; ++k, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned b01[4], b2[2];
        ldsm_b2(b01, slab + kk * QKV_LD + warp * 24, QKV_LD, lane);
        ldsm_b1(b2, slab + kk * QKV_LD + warp * 24 + 16, QKV_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sLN + m * 16 * Sh::LN_LD + k * KS + kk, Sh::LN_LD, lane);
          mma16816(qacc[m][0], a, b01[0], b01[1]);
          mma16816(qacc[m][1], a, b01[2], b01[3]);
          mma16816(qacc[m][2], a, b2[0], b2[1]);
        }
      }
      __syncthreads();
    }
    // + bias, to bf16
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int col = warp * 24 + n * 8 + 2 * t;   // within q | k | v
      const int gcol = (col / D) * C + h * D + col % D;
      const float bb0 = bqkv[gcol], bb1 = bqkv[gcol + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m * 16 + gq + 8 * hr;
          *reinterpret_cast<__nv_bfloat162*>(sQKV + row * QKV_LD + col) =
              __floats2bfloat162_rn(qacc[m][n][2 * hr] + bb0,
                                    qacc[m][n][2 * hr + 1] + bb1);
        }
    }
    __syncthreads();
    // scores q k^T over the RT x RT tile (float32)
    for (int task = warp; task < MT * MT; task += WARPS) {
      const int mt = task % MT, nt = task / MT;
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
          float* d = sS + (mt * 16 + gq + 8 * hr) * Sh::S_LD + nt * 16 +
                     n * 8 + 2 * t;
          d[0] = c[n][2 * hr];
          d[1] = c[n][2 * hr + 1];
        }
    }
    __syncthreads();
    // softmax within each row's segment: p (float32) into sS, bf16 into sP
    // (dropped with the forward's mask in the reg form: the forward's P.V
    // operand, for o and dv; sS keeps the undropped p for the Jacobian)
    const uint32_t hseed = site_seed(adrop.seed_plus, SITE_ATTN + 4 * h);
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
      float inv = 0.f;
      if (live) {
        const float mx = warp_max(fmaxf(sv[0], sv[1]));
#pragma unroll
        for (int u = 0; u < 2; ++u) e[u] = in[u] ? expf(sv[u] - mx) : 0.f;
        inv = 1.f / warp_sum(e[0] + e[1]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c < RT) {
          const float pv = e[u] * inv;
          sS[r * Sh::S_LD + c] = pv;
          sP[r * Sh::P_LD + c] = __float2bfloat16(
              adrop.on && !keep_mask(hseed, (uint32_t)(row0 + r),
                                     (uint32_t)(row0 + c), adrop.thr)
                  ? 0.f
                  : (adrop.on ? pv * adrop.scale : pv));
        }
      }
    }
    __syncthreads();
    // ---- 2. o = P V, bf16, to attn (live rows); dw: to sO (all rows) ----
    for (int task = warp; task < DT; task += WARPS) {
      const int mt = task % MT, nt = task / MT;
      float c[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_a(a, sP + mt * 16 * Sh::P_LD + k0, Sh::P_LD, lane);
        ldsm_b2(b, sQKV + k0 * QKV_LD + 2 * D + nt * 16, QKV_LD, lane);
        mma16816(c[0], a, b[0], b[1]);
        mma16816(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mt * 16 + gq + 8 * hr;
          const __nv_bfloat162 o2 =
              __floats2bfloat162_rn(c[n][2 * hr], c[n][2 * hr + 1]);
          if (dw)
            *reinterpret_cast<__nv_bfloat162*>(
                sO + row * DO_LD + nt * 16 + n * 8 + 2 * t) = o2;
          else if (row < R)
            *reinterpret_cast<__nv_bfloat162*>(
                attn_out + (row0 + row) * C + h * D + nt * 16 + n * 8 +
                2 * t) = o2;
        }
    }

    // ---- 3. do = g wproj[h*D .. h*D + D)^T: warp owns 8 of the columns ----
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) qacc[m][0][q] = 0.f;
    for (int k = 0; k < Sh::SLABS; ++k, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        unsigned b[2];
        ldsm_bt1(b, slab + warp * 8 * GS_LD + kk, GS_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, slab + (D + m * 16) * GS_LD + kk, GS_LD, lane);
          mma16816(qacc[m][0], a, b[0], b[1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(
            sDO + (m * 16 + gq + 8 * hr) * DO_LD + warp * 8 + 2 * t) =
            __floats2bfloat162_rn(qacc[m][0][2 * hr], qacc[m][0][2 * hr + 1]);
    __syncthreads();

    // ---- 3b (dw). dwA[h*D .. h*D + D, :] += o^T gacc, KS columns a slab:
    // warp owns the m16 tile warp / 2 of the head's rows and 4 n8 tiles ----
    if (dw)
      for (int k = 0; k < Sh::SLABS; ++k, ++s) {
        bf16* slab = const_cast<bf16*>(next_slab());
        if (pdrop.on) {                    // gacc = bf16(g * mask / keep)
          for (int i = threadIdx.x; i < R * KS; i += THREADS) {
            const int r = i / KS, c = i % KS;
            bf16* p = slab + r * GS_LD + c;
            *p = __float2bfloat16(pdrop.apply(__bfloat162float(*p),
                                              (uint32_t)(row0 + r),
                                              k * KS + c));
          }
          __syncthreads();
        }
        const int mt = warp >> 1, n0 = (warp & 1) * 32;
        float c4[4][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < RT; k0 += 16) {
          unsigned a[4], b0[4], b1[4];
          ldsm_at(a, sO + k0 * DO_LD + mt * 16, DO_LD, lane);
          ldsm_b2(b0, slab + k0 * GS_LD + n0, GS_LD, lane);
          ldsm_b2(b1, slab + k0 * GS_LD + n0 + 16, GS_LD, lane);
          mma16816(c4[0], a, b0[0], b0[1]);
          mma16816(c4[1], a, b0[2], b0[3]);
          mma16816(c4[2], a, b1[0], b1[1]);
          mma16816(c4[3], a, b1[2], b1[3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            atomic_add2(dwA + (long)(h * D + mt * 16 + gq + 8 * hr) * C +
                            k * KS + n0 + n * 8 + 2 * t,
                        c4[n][2 * hr], c4[n][2 * hr + 1]);
        __syncthreads();
      }

    // ---- 4. the softmax backward ----
    // dv = P^T do (held in registers until v is no longer read)
    constexpr int DV_IT = (DT + WARPS - 1) / WARPS;
    float dv[DV_IT][2][4];
#pragma unroll
    for (int it = 0; it < DV_IT; ++it) {
      const int task = warp + it * WARPS;
      if (task >= DT) continue;
      const int mt = task % MT, nt = task / MT;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) dv[it][n][q] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_at(a, sP + k0 * Sh::P_LD + mt * 16, Sh::P_LD, lane);
        ldsm_b2(b, sDO + k0 * DO_LD + nt * 16, DO_LD, lane);
        mma16816(dv[it][0], a, b[0], b[1]);
        mma16816(dv[it][1], a, b[2], b[3]);
      }
    }
    // dp = do v^T (float32) into sD
    for (int task = warp; task < MT * MT; task += WARPS) {
      const int mt = task % MT, nt = task / MT;
      float c[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_a(a, sDO + mt * 16 * DO_LD + k0, DO_LD, lane);
        ldsm_bt2(b, sQKV + nt * 16 * QKV_LD + 2 * D + k0, QKV_LD, lane);
        mma16816(c[0], a, b[0], b[1]);
        mma16816(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float* d = sD + (mt * 16 + gq + 8 * hr) * Sh::S_LD + nt * 16 +
                     n * 8 + 2 * t;
          d[0] = c[n][2 * hr];
          d[1] = c[n][2 * hr + 1];
        }
    }
    __syncthreads();
    // dv (bf16) over v; ds = p (dp - rowsum(dp p)) * scale (bf16) over P
#pragma unroll
    for (int it = 0; it < DV_IT; ++it) {
      const int task = warp + it * WARPS;
      if (task >= DT) continue;
      const int mt = task % MT, nt = task / MT;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<__nv_bfloat162*>(
              sQKV + (mt * 16 + gq + 8 * hr) * QKV_LD + 2 * D + nt * 16 +
              n * 8 + 2 * t) = __floats2bfloat162_rn(dv[it][n][2 * hr],
                                                     dv[it][n][2 * hr + 1]);
    }
    for (int r = warp; r < RT; r += WARPS) {
      float pv[2], dpv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        pv[u] = c < RT ? sS[r * Sh::S_LD + c] : 0.f;
        dpv[u] = c < RT ? sD[r * Sh::S_LD + c] : 0.f;
        if (adrop.on && c < RT)      // dp through the dropout: mask, rescale
          dpv[u] = keep_mask(hseed, (uint32_t)(row0 + r),
                             (uint32_t)(row0 + c), adrop.thr)
                       ? dpv[u] * adrop.scale
                       : 0.f;
      }
      const float rs = warp_sum(dpv[0] * pv[0] + dpv[1] * pv[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c < RT)
          sP[r * Sh::P_LD + c] =
              __float2bfloat16(pv[u] * (dpv[u] - rs) * scale);
      }
    }
    __syncthreads();
    // dq = ds k and dk = ds^T q in registers, then over q | k
    constexpr int QK_IT = (2 * DT + WARPS - 1) / WARPS;
    float dqk[QK_IT][2][4];
#pragma unroll
    for (int it = 0; it < QK_IT; ++it) {
      const int task = warp + it * WARPS;
      if (task >= 2 * DT) continue;
      const int which = task / DT, tt = task % DT;   // 0: dq, 1: dk
      const int mt = tt % MT, nt = tt / MT;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) dqk[it][n][q] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += 16) {
        unsigned a[4], b[4];
        if (which == 0) {
          ldsm_a(a, sP + mt * 16 * Sh::P_LD + k0, Sh::P_LD, lane);
          ldsm_b2(b, sQKV + k0 * QKV_LD + D + nt * 16, QKV_LD, lane);
        } else {
          ldsm_at(a, sP + k0 * Sh::P_LD + mt * 16, Sh::P_LD, lane);
          ldsm_b2(b, sQKV + k0 * QKV_LD + nt * 16, QKV_LD, lane);
        }
        mma16816(dqk[it][0], a, b[0], b[1]);
        mma16816(dqk[it][1], a, b[2], b[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < QK_IT; ++it) {
      const int task = warp + it * WARPS;
      if (task >= 2 * DT) continue;
      const int which = task / DT, tt = task % DT;
      const int mt = tt % MT, nt = tt / MT;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<__nv_bfloat162*>(
              sQKV + (mt * 16 + gq + 8 * hr) * QKV_LD + which * D +
              nt * 16 + n * 8 + 2 * t) =
              __floats2bfloat162_rn(dqk[it][n][2 * hr],
                                    dqk[it][n][2 * hr + 1]);
    }
    __syncthreads();
    // dq | dk | dv to device memory, and their column sums over live rows
    for (int i = threadIdx.x; i < (dw ? 0 : R) * 3 * (D / 8); i += THREADS) {
      const int r = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
      const int p = rem / (D / 8), seg = rem % (D / 8);
      *reinterpret_cast<uint4*>(dqkv_out + (row0 + r) * (3 * C) + p * C +
                                h * D + seg * 8) =
          *reinterpret_cast<const uint4*>(sQKV + r * QKV_LD + p * D +
                                          seg * 8);
    }
    for (int c = threadIdx.x; c < 3 * D; c += THREADS) {
      float cs = 0.f;
      for (int r = 0; r < R; ++r) cs += __bfloat162float(sQKV[r * QKV_LD + c]);
      bpart[2 * C + (c / D) * C + h * D + c % D] = cs;
    }
    // ---- 4b (dw). dwqkv[:, the head's q | k | v columns] += ln^T dqkv_h:
    // warp takes m16 tiles of ln's columns, each against all 192 columns
    // (sLN and sQKV are read only until the next head's barriers) ----
    if (dw)
      for (int mt = warp; mt < C / 16; mt += WARPS) {
        unsigned a[MT][4];
#pragma unroll
        for (int kt = 0; kt < MT; ++kt)
          ldsm_at(a[kt], sLN + kt * 16 * Sh::LN_LD + mt * 16, Sh::LN_LD,
                  lane);
        for (int np = 0; np < 3 * D / 16; ++np) {
          float c2[2][4] = {};
#pragma unroll
          for (int kt = 0; kt < MT; ++kt) {
            unsigned b[4];
            ldsm_b2(b, sQKV + kt * 16 * QKV_LD + np * 16, QKV_LD, lane);
            mma16816(c2[0], a[kt], b[0], b[1]);
            mma16816(c2[1], a[kt], b[2], b[3]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = np * 16 + n * 8 + 2 * t;     // within q | k | v
            const int gcol = (col / D) * C + h * D + col % D;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr)
              atomic_add2(dwqkv + (long)(mt * 16 + gq + 8 * hr) * (3 * C) +
                              gcol,
                          c2[n][2 * hr], c2[n][2 * hr + 1]);
          }
        }
      }

    // ---- 5. dln += dqkv_h wqkv[:, head]^T, KS output columns a slab ----
#pragma unroll
    for (int q = 0; q < NQ; ++q, ++s) {
      const bf16* slab = next_slab();
#pragma unroll
      for (int kk = 0; kk < 3 * D; kk += 16) {
        unsigned b[2];
        ldsm_bt1(b, slab + warp * 8 * QKV_LD + kk, QKV_LD, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          unsigned a[4];
          ldsm_a(a, sQKV + m * 16 * QKV_LD + kk, QKV_LD, lane);
          mma16816(acc[m][q], a, b[0], b[1]);
        }
      }
      __syncthreads();
    }
  }

  // ---- 6. LN backward, dx, and the block's column sums ----
  float mean[MT][2], istd[MT][2], m1[MT][2], m2[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m * 16 + gq + 8 * hr;
      const bool live = use_ln && row < R;
      mean[m][hr] = live ? sStat[2 * row] : 0.f;
      istd[m][hr] = live ? sStat[2 * row + 1] : 0.f;
      m1[m][hr] = m2[m][hr] = 0.f;
    }
  if (use_ln) {
    // row sums of dxh = dln * lns and of dxh * xhat, over the warp's
    // columns, then over the 8 warps through shared memory (sS)
    float* red = sS;                               // [WARPS][RT][2]
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + gq + 8 * hr;
        float s1 = 0.f, s2 = 0.f;
        if (row < R) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int col = q * KS + warp * 8 + 2 * t;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    x + (row0 + row) * C + col));
            const float xh0 = (xv.x - mean[m][hr]) * istd[m][hr];
            const float xh1 = (xv.y - mean[m][hr]) * istd[m][hr];
            const float d0 = acc[m][q][2 * hr] * lns[col];
            const float d1 = acc[m][q][2 * hr + 1] * lns[col + 1];
            s1 += d0 + d1;
            s2 += d0 * xh0 + d1 * xh1;
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (t == 0) {
          red[(warp * RT + row) * 2] = s1;
          red[(warp * RT + row) * 2 + 1] = s2;
        }
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + gq + 8 * hr;
        float s1 = 0.f, s2 = 0.f;
        for (int w = 0; w < WARPS; ++w) {
          s1 += red[(w * RT + row) * 2];
          s2 += red[(w * RT + row) * 2 + 1];
        }
        m1[m][hr] = s1 / C;
        m2[m][hr] = s2 / C;
      }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int col = q * KS + warp * 8 + 2 * t;
    float cs[3][2] = {};                           // dln*xhat, dln, g
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + gq + 8 * hr;
        if (row >= R) continue;
        const long off = (row0 + row) * C + col;
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(g + off));
        float dl[2] = {acc[m][q][2 * hr], acc[m][q][2 * hr + 1]};
        float gg[2] = {gv.x, gv.y};
        float out[2];
        if (use_ln) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + off));
          const float xs[2] = {xv.x, xv.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xh = (xs[e] - mean[m][hr]) * istd[m][hr];
            const float dxh = dl[e] * lns[col + e];
            out[e] = istd[m][hr] * (dxh - m1[m][hr] - xh * m2[m][hr]);
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
          // dbproj's sum: the float32 proj-masked g, no gamma (reg form)
          cs[2][e] += pdrop.on ? pdrop.apply(gg[e], (uint32_t)(row0 + row),
                                             col + e)
                               : gg[e];
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + off) =
            __floats2bfloat162_rn(out[0], out[1]);
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cs[i][e] += __shfl_xor_sync(0xffffffffu, cs[i][e], o);
    if (gq == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bpart[col + e] = cs[0][e];
        bpart[C + col + e] = cs[1][e];
        bpart[5 * C + col + e] = cs[2][e];
      }
  }
}

// out[j] = sum over b < nb of part[b * width + j], in order of b.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nb,
                                    int width, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[(long)b * width + j];
  out[j] = s;
}

// Rows per block for seg_len S.
int rows_per_block(int S) { return S <= 48 ? 48 : 64; }

template <int RT, int C>
cudaError_t launch(const bf16* x, const bf16* g, const float* lns,
                   const float* lnb, const bf16* wqkv, const float* bqkv,
                   const bf16* wproj, bf16* dx, bf16* ln, bf16* attn,
                   bf16* dqkv, float* sums, float* part, float* dwqkv,
                   float* dwA, int n_seg, int S, float scale, float eps,
                   int use_ln, int use_residual, const float* gamma,
                   bf16* geff, bf16* gm, Drop adrop, Drop pdrop,
                   cudaStream_t stream) {
  constexpr size_t smem = Shape<RT, C>::SMEM;
  const bool dw = dwqkv != nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      dw ? attention_bwd_kernel<RT, C, true>
         : attention_bwd_kernel<RT, C, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bf16* gsrc = g;
  if (gamma != nullptr || pdrop.on) {
    err = launch_geff(g, gamma, pdrop, geff, gm, (long)n_seg * S * C, C, 0,
                      stream);
    if (err != cudaSuccess) return err;
    gsrc = geff;
  }
  const int G = RT / S;
  const int blocks = (n_seg + G - 1) / G;
  (dw ? attention_bwd_kernel<RT, C, true>
      : attention_bwd_kernel<RT, C, false>)<<<blocks, THREADS, smem,
                                               stream>>>(
      x, g, gsrc, lns, lnb, wqkv, bqkv, wproj, dx, ln, attn, dqkv, part,
      dwqkv, dwA, n_seg, S, scale, eps, use_ln, use_residual, adrop, pdrop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(6 * C + 255) / 256, 256, 0, stream>>>(
      part, blocks, 6 * C, sums);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_rows(const bf16* x, const bf16* g, const float* lns,
                        const float* lnb, const bf16* wqkv,
                        const float* bqkv, const bf16* wproj, bf16* dx,
                        bf16* ln, bf16* attn, bf16* dqkv, float* sums,
                        float* part, float* dwqkv, float* dwA, int n_seg,
                        int S, float scale, float eps, int use_ln,
                        int use_residual, const float* gamma, bf16* geff,
                        bf16* gm, Drop adrop, Drop pdrop,
                        cudaStream_t stream) {
  if (rows_per_block(S) == 48)
    return launch<48, C>(x, g, lns, lnb, wqkv, bqkv, wproj, dx, ln, attn,
                         dqkv, sums, part, dwqkv, dwA, n_seg, S, scale, eps,
                         use_ln, use_residual, gamma, geff, gm, adrop, pdrop,
                         stream);
  return launch<64, C>(x, g, lns, lnb, wqkv, bqkv, wproj, dx, ln, attn, dqkv,
                       sums, part, dwqkv, dwA, n_seg, S, scale, eps, use_ln,
                       use_residual, gamma, geff, gm, adrop, pdrop, stream);
}

}  // namespace

extern "C" {

// Returns the first cudaGetLastError() of the two launches (0 on success).
// Arguments are checked by the Python wrapper: S in 1..64, C = 64 *
// num_heads with C in {256, 384, 512, 768}, every pointer 32-byte
// aligned; ln may be null when use_ln is 0. sums is float32 [6C]: dlns |
// dlnb | dbqkv (3C) | dbproj. part is a float32 workspace of blocks * 6C,
// blocks = ceil(n_seg / (rows per block / S)). The reg form: gamma
// float32 [C] or null; geff a bf16 [rows, C] workspace, needed when gamma is given or the
// proj dropout is on (else null); gm bf16 [rows, C], written when the proj
// dropout is on (else null); seed, the thresholds (< 0: off) and keep
// scales of the two dropout sites, as the forward took them. The dw form:
// dwqkv float32 [C, 3C] and dwA float32 [C, C], zeroed by the caller, both
// given (else both null); ln, attn, dqkv and gm are then null.
int launch_fused_attention_residual_bwd(
    const void* x, const void* g, const void* lns, const void* lnb,
    const void* wqkv, const void* bqkv, const void* wproj, void* dx,
    void* ln, void* attn, void* dqkv, void* sums, void* part, void* dwqkv,
    void* dwA, int n_seg,
    int S, int C, int num_heads, float scale, float eps, int use_ln,
    int use_residual, const void* gamma, void* geff, void* gm, int seed,
    int attn_thr, float attn_scale, int proj_thr, float proj_scale,
    void* stream) {
  if (S < 1 || S > 64 || C != num_heads * D || n_seg < 1 ||
      (dwqkv == nullptr) != (dwA == nullptr))
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const bf16*)x, (const bf16*)g, (const float*)lns, (const float*)lnb,     \
      (const bf16*)wqkv, (const float*)bqkv, (const bf16*)wproj, (bf16*)dx, \
      (bf16*)ln, (bf16*)attn, (bf16*)dqkv, (float*)sums, (float*)part,      \
      (float*)dwqkv, (float*)dwA, n_seg, S, scale, eps, use_ln,             \
      use_residual, (const float*)gamma, (bf16*)geff, (bf16*)gm,            \
      make_drop(seed, SITE_ATTN, attn_thr, attn_scale),                     \
      make_drop(seed, SITE_PROJ, proj_thr, proj_scale), (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch_rows<256>(ARGS);
    case 384: return (int)launch_rows<384>(ARGS);
    case 512: return (int)launch_rows<512>(ARGS);
    case 768: return (int)launch_rows<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

int blocks_for(int n_seg, int S) {
  const int G = rows_per_block(S) / S;
  return (n_seg + G - 1) / G;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
