// The row launches the backward chains share (sm_90a): the attention
// backward's (csrc/attention_bwd_sm90.cu) and the MLP backward's
// (csrc/fused_mlp_bwd.cu):
//   ln_stats_kernel      ln = bf16(LN(x)) and each row's mean and 1/std;
//   ln_bwd_rows_kernel   the LN backward by whole rows, + g, dx rounded once,
//                        and per-block column sums;
//   sum_rows_kernel      fixed-order sums of per-block partial rows;
// and the chains' error check and reg flags (CHAIN_CHECK, ChainReg).
// Every sum is taken in an order that does not depend on timing, so the
// chains' outputs are bit-reproducible.
// Their rounding points are the TPU kernel's (pallas_attention.py:
// 691-710, 906-918).

#pragma once

#include "tile_ops.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm rows: ln = bf16(LN(x)), stats[2r] = mean, stats[2r + 1] =
// 1/sqrt(var + eps) (float32, two-pass variance: ln_rows' arithmetic). One
// warp a row.
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(256)
ln_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, float eps,
                bf16* __restrict__ ln, float* __restrict__ stats, int rows) {
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
// The LN backward by rows: dx = 1/std (dxh - mean(dxh) - xhat
// mean(dxh xhat)) [+ g], dxh = dln * lns (full form), or dln [+ g] (bare);
// rounded once. part [blocks, 3C]: the block's column sums of dln * xhat,
// dln (zeros in the bare form) and g, or with the proj dropout on the
// float32 g * proj mask / keep (the residual adds raw g); the mask at the
// global row grow0 + the chunk's row. A block takes RP_ROWS rows, each of
// its 8 warps one row at a time with the row's C / 64 column pairs in
// registers (dln read once, the row's two sums warp reductions), and keeps
// its rows' column sums in registers; the warps add theirs into the
// block's partial row in warp order, so the sums do not depend on timing.
// ---------------------------------------------------------------------------

constexpr int RP_ROWS = 64;

template <int C>
__global__ void __launch_bounds__(256)
ln_bwd_rows_kernel(const float* __restrict__ dln, const bf16* __restrict__ x,
                   const bf16* __restrict__ g, const float* __restrict__ lns,
                   const float* __restrict__ stats, bf16* __restrict__ dx,
                   float* __restrict__ part, int rows, int use_ln,
                   int use_residual, Drop pdrop, long grow0) {
  constexpr int NP = C / 64;             // column pairs a lane: 2 lane + 64 i
  __shared__ float sPart[3 * C];         // dln * xhat, dln, g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r0 = (long)blockIdx.x * RP_ROWS;
  const int R = (int)min((long)RP_ROWS, rows - r0);
  float cs[3][NP][2] = {};
  for (int r = warp; r < R; r += 8) {
    const long row = r0 + r, base = row * C;
    const float mean = use_ln ? stats[2 * row] : 0.f;
    const float istd = use_ln ? stats[2 * row + 1] : 0.f;
    float2 dl[NP], gv[NP], xh[NP];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 2 * lane + 64 * i;
      dl[i] = *reinterpret_cast<const float2*>(dln + base + c);
      gv[i] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + base + c));
      xh[i] = make_float2(0.f, 0.f);
      if (use_ln) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + base + c));
        xh[i] = make_float2((xv.x - mean) * istd, (xv.y - mean) * istd);
        const float d0 = dl[i].x * lns[c], d1 = dl[i].y * lns[c + 1];
        s1 += d0 + d1;
        s2 += d0 * xh[i].x + d1 * xh[i].y;
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 2 * lane + 64 * i;
      const float dl2[2] = {dl[i].x, dl[i].y}, gg[2] = {gv[i].x, gv[i].y};
      const float xs[2] = {xh[i].x, xh[i].y};
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (use_ln) {
          const float dxh = dl2[e] * lns[c + e];
          out[e] = istd * (dxh - m1 - xs[e] * m2);
          cs[0][i][e] += dl2[e] * xs[e];
          cs[1][i][e] += dl2[e];
        } else {
          out[e] = dl2[e];
        }
        if (use_residual) out[e] += gg[e];
        cs[2][i][e] += pdrop.on ? pdrop.apply(gg[e], (uint32_t)(grow0 + row),
                                              c + e)
                                : gg[e];
      }
      *reinterpret_cast<__nv_bfloat162*>(dx + base + c) =
          __floats2bfloat162_rn(out[0], out[1]);
    }
  }
  for (int w = 0; w < 8; ++w) {
    if (warp == w)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* p = sPart + k * C + 2 * lane + 64 * i + e;
            *p = (w == 0 ? 0.f : *p) + cs[k][i][e];
          }
    __syncthreads();
  }
  float* bpart = part + (long)blockIdx.x * 3 * C;
  for (int j = threadIdx.x; j < 3 * C; j += 256) bpart[j] = sPart[j];
}

// ---------------------------------------------------------------------------
// out[j] = sum over b < nb of part[b * width + j], in a fixed order: each
// of a block's 4 slices of 64 columns sums its quarter of the rows in
// order, then the quarters in order; column j goes to out_lo[j] below
// split, else to out_hi[j - split].
// ---------------------------------------------------------------------------

constexpr int SUM_COLS = 64, SUM_SLICES = 4;

__global__ void __launch_bounds__(SUM_COLS * SUM_SLICES)
sum_rows_kernel(const float* __restrict__ part, int nb, int width,
                float* __restrict__ out_lo, int split,
                float* __restrict__ out_hi) {
  __shared__ float q[SUM_SLICES][SUM_COLS];
  const int col = threadIdx.x % SUM_COLS, slice = threadIdx.x / SUM_COLS;
  const int j = blockIdx.x * SUM_COLS + col;
  const int per = (nb + SUM_SLICES - 1) / SUM_SLICES;
  const int b1 = min(nb, (slice + 1) * per);
  float s = 0.f;
  if (j < width) {
#pragma unroll 8
    for (int b = slice * per; b < b1; ++b) s += part[(long)b * width + j];
  }
  q[slice][col] = s;
  __syncthreads();
  if (slice != 0 || j >= width) return;
  s = ((q[0][col] + q[1][col]) + q[2][col]) + q[3][col];
  if (j < split)
    out_lo[j] = s;
  else
    out_hi[j - split] = s;
}

cudaError_t sum_rows(const float* part, int nb, int width, float* out_lo,
                     int split, float* out_hi, cudaStream_t stream) {
  sum_rows_kernel<<<(width + SUM_COLS - 1) / SUM_COLS, SUM_COLS * SUM_SLICES,
                    0, stream>>>(part, nb, width, out_lo, split, out_hi);
  return cudaGetLastError();
}

#define CHAIN_CHECK(expr)                   \
  do {                                      \
    const cudaError_t e_ = (expr);          \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

// The reg form's flags of a backward chain: gamma (LayerScale, or null),
// the attention and proj dropout sites (off in the inert form), and gm,
// the caller's [rows, C] proj-masked g (dw=False with the proj dropout on;
// else null).
struct ChainReg {
  const float* gamma;
  Drop adrop, pdrop;
  bf16* gm;
};

constexpr ChainReg INERT{nullptr, Drop{0u, 0u, 1.f, 0}, Drop{0u, 0u, 1.f, 0},
                         nullptr};

}  // namespace
