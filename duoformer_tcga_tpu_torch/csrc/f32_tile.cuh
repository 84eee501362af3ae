// Float32 building blocks of the port's float32 kernel forms (sm_90a): a
// tiled product with fused epilogues, the row LayerNorm forward and
// backward, the block-diagonal attention core and its backward,
// deterministic column sums, and the TF32 split (tf32_split) of the
// operands of the 3xTF32 products. The float32 forms of the fused kernels
// (csrc/*_f32.cu) are chains of these launches; the attention forward's
// (csrc/fused_attention_residual_f32.cu) runs its two products on
// gemm_sm90.cuh's EPI_X3 instead of the FMA tile.
//
// Products. The FMA product is float32 on the CUDA cores: a 128 x 128
// output tile per block of 256 threads, each thread an 8 x 8 register
// micro-tile, K streamed through shared memory 8 at a time (two buffers,
// the next slab prefetched into registers while the current one is
// multiplied). The tensor cores' only float32 input is TF32 (10 mantissa
// bits, ~3e-4 relative error a product), which the float32 forms must not
// round to; 3xTF32 (each operand split into a TF32 high part and a
// remainder, three TF32 products into one float32 accumulator) keeps
// float32 accuracy at up to ~3x the FMA rate: the attention forward's
// products run so; the MLP's, the backward's and the dz pass's stay on
// this tile until theirs move too. FMA has no rounding point
// below float32 and its sums run in one fixed order.
//
// What bounds these products on this card: 67 TFLOP/s of float32 FMA, not
// the bytes (K >= 256 gives >= 64 flops a byte in every product here).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

namespace f32 {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int GEMM_THREADS = 256;
constexpr int COLSUM_ROWS = 256;   // rows a column-sum block adds
constexpr int LN_ROWS = 32;        // rows a LayerNorm-backward warp adds
constexpr int LN_WARPS = 8;
constexpr int ATT_THREADS = 128;   // the attention core's backward: 4 warps
constexpr int ATT_LD = 65;         // its q, k, v, do rows in shared memory
constexpr float SQRT1_2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The TF32 split of a float32 a: hi its rounding to TF32 (to nearest,
// ties away from zero, as cvt.rna.tf32.f32: the low 13 mantissa bits
// zero), lo = a - hi exactly (|lo| <= 2^-11 |a|); a non-finite a gives
// hi = a, lo = 0. hi lo as wgmma reads lo (its low 13 bits dropped) add
// up to a within 2^-22 |a|. ops/fused_attention.tf32_split_plain is its
// plain twin, bit for bit.
__device__ __forceinline__ void tf32_split(float a, float& hi, float& lo) {
  if (isfinite(a)) {
    hi = __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
    lo = __fsub_rn(a, hi);
  } else {
    hi = a;
    lo = 0.f;
  }
}

// ---- epilogues: (row, col, columns col..col+3 of the product) ----

// out = acc [+ bias] [+ resid], resid and out [rows, ld]
struct EpiStore {
  float* out;
  const float* bias;
  const float* resid;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    if (bias != nullptr) {
      v.x += bias[c];
      v.y += bias[c + 1];
      v.z += bias[c + 2];
      v.w += bias[c + 3];
    }
    const long off = (long)r * ld + c;
    if (resid != nullptr) {
      const float4 x = *reinterpret_cast<const float4*>(resid + off);
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    *reinterpret_cast<float4*>(out + off) = v;
  }
};

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * SQRT1_2));
}

// z = acc + bias (written when zout is given), h = gelu_erf(z)
struct EpiGelu {
  float* h;
  float* zout;
  const float* bias;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    v.x += bias[c];
    v.y += bias[c + 1];
    v.z += bias[c + 2];
    v.w += bias[c + 3];
    const long off = (long)r * ld + c;
    if (zout != nullptr) *reinterpret_cast<float4*>(zout + off) = v;
    *reinterpret_cast<float4*>(h + off) =
        make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z),
                    gelu_erf(v.w));
  }
};

// gelu'(z) = Phi(z) + z * phi(z)
__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * SQRT1_2)) +
         z * (INV_SQRT_2PI * expf(-0.5f * z * z));
}

// dz = acc * gelu'(z), z and dz [rows, ld]
struct EpiDz {
  const float* z;
  float* dz;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float4 v) const {
    const long off = (long)r * ld + c;
    const float4 zz = *reinterpret_cast<const float4*>(z + off);
    *reinterpret_cast<float4*>(dz + off) =
        make_float4(v.x * gelu_grad(zz.x), v.y * gelu_grad(zz.y),
                    v.z * gelu_grad(zz.z), v.w * gelu_grad(zz.w));
  }
};

// ---- the product: epi(A[M, K] . B) over the [M, N] output ----
// B is [K, N] row-major, or with BT the transpose of a row-major [N, K] W
// (B[k][n] = W[n][k]). N % 128 == 0, K % 8 == 0; rows of A at or past M
// (the ragged last tile) are read as zeros and never written.
template <bool BT, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B, int M,
            int N, int K, Epi epi) {
  __shared__ __align__(16) float sA[2][BK][BM];
  __shared__ __align__(16) float sB[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // A (and a transposed B): row tid / 2 of the tile, k (tid % 2) * 4..+3
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  // B: k row tid / 32, columns (tid % 32) * 4..+3
  const int bk = tid >> 5, bc = (tid & 31) * 4;
  const bool a_live = m0 + ar < M;
  const float* Ap = A + (long)(a_live ? m0 + ar : 0) * K + ak;
  const float* Bp = BT ? B + (long)(n0 + ar) * K + ak
                       : B + (long)bk * N + n0 + bc;
  float4 ra, rb;
  auto load = [&](int k0) {
    ra = a_live ? *reinterpret_cast<const float4*>(Ap + k0)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    rb = BT ? *reinterpret_cast<const float4*>(Bp + k0)
            : *reinterpret_cast<const float4*>(Bp + (long)k0 * N);
  };
  auto stage = [&](int buf) {
    sA[buf][ak + 0][ar] = ra.x;
    sA[buf][ak + 1][ar] = ra.y;
    sA[buf][ak + 2][ar] = ra.z;
    sA[buf][ak + 3][ar] = ra.w;
    if (BT) {
      sB[buf][ak + 0][ar] = rb.x;
      sB[buf][ak + 1][ar] = rb.y;
      sB[buf][ak + 2][ar] = rb.z;
      sB[buf][ak + 3][ar] = rb.w;
    } else {
      *reinterpret_cast<float4*>(&sB[buf][bk][bc]) = rb;
    }
  };

  // thread (ty, tx): rows ty*4..+3 and 64+ty*4..+3, columns tx*4..+3 and
  // 64+tx*4..+3 of the tile
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sA[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sB[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      stage(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
    epi(r, n0 + tx * 4,
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    epi(r, n0 + 64 + tx * 4,
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

template <bool BT, class Epi>
cudaError_t gemm(const float* A, const float* B, int M, int N, int K,
                 Epi epi, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (N % BN != 0 || K % BK != 0) return cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<BT, Epi><<<grid, GEMM_THREADS, 0, stream>>>(A, B, M, N, K,
                                                          epi);
  return cudaGetLastError();
}

// ---- LayerNorm forward: one warp per row ----
// ln = (x - mean) * rsqrt(var + eps) * scale + bias, mean and the
// two-pass variance in float32; stats (when given) keeps each row's mean
// and 1/sqrt(var + eps) for the backward. SPLIT: ln's TF32 split instead,
// hi into ln and lo into lo (tf32_split).
template <int C, bool SPLIT = false>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ lns,
              const float* __restrict__ lnb, float eps, float* __restrict__ ln,
              float* __restrict__ stats, int rows,
              float* __restrict__ lo = nullptr) {
  constexpr int NT = C / 32;
  const int lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * C;
  float v[NT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    v[i] = xr[lane + 32 * i];
    sum += v[i];
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float d = v[i] - mean;
    sq += d * d;
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  float* lr = ln + r * C;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c = lane + 32 * i;
    const float y = (v[i] - mean) * inv * lns[c] + lnb[c];
    if (SPLIT)
      tf32_split(y, lr[c], lo[r * C + c]);
    else
      lr[c] = y;
  }
  if (stats != nullptr && lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = inv;
  }
}

template <int C>
cudaError_t ln_fwd(const float* x, const float* lns, const float* lnb,
                   float eps, float* ln, float* stats, int rows,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  ln_fwd_kernel<C><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0,
                     stream>>>(x, lns, lnb, eps, ln, stats, rows);
  return cudaGetLastError();
}

// The LayerNorm's TF32 split: hi [rows, C], lo [rows, C].
template <int C>
cudaError_t ln_fwd_split(const float* x, const float* lns, const float* lnb,
                         float eps, float* hi, float* lo, int rows,
                         cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  ln_fwd_kernel<C, true><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32,
                           0, stream>>>(x, lns, lnb, eps, hi, nullptr, rows,
                                        lo);
  return cudaGetLastError();
}

// ---- LayerNorm backward: one warp per LN_ROWS rows ----
// xhat = (x - mean) * inv, dxh = dln * scale,
// dx = inv * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) [+ g];
// the warp's column sums of dln * xhat and of dln go to part[w][0, C) and
// part[w][C, 2C) (w the warp's global index), added up by colsum_parts.
template <int C>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bwd_kernel(const float* __restrict__ dln, const float* __restrict__ x,
              const float* __restrict__ stats, const float* __restrict__ lns,
              const float* __restrict__ g, float* __restrict__ dx,
              float* __restrict__ part, int rows) {
  constexpr int NT = C / 32;
  const int lane = threadIdx.x & 31;
  const long w = (long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  const long r0 = w * LN_ROWS;
  if (r0 >= rows) return;
  const long r1 = r0 + LN_ROWS < rows ? r0 + LN_ROWS : rows;
  float ps[NT], pb[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) ps[i] = pb[i] = 0.f;
  for (long r = r0; r < r1; ++r) {
    const float mean = stats[2 * r], inv = stats[2 * r + 1];
    float d[NT], xh[NT];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int c = lane + 32 * i;
      d[i] = dln[r * C + c];
      xh[i] = (x[r * C + c] - mean) * inv;
      const float dxh = d[i] * lns[c];
      m1 += dxh;
      m2 += dxh * xh[i];
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int c = lane + 32 * i;
      float v = inv * (d[i] * lns[c] - m1 - xh[i] * m2);
      if (g != nullptr) v += g[r * C + c];
      dx[r * C + c] = v;
      ps[i] += d[i] * xh[i];
      pb[i] += d[i];
    }
  }
  float* pw = part + w * 2 * C;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    pw[lane + 32 * i] = ps[i];
    pw[C + lane + 32 * i] = pb[i];
  }
}

inline int ln_bwd_parts(int rows) { return (rows + LN_ROWS - 1) / LN_ROWS; }

// ---- column sums: out[c] = sum over the rows of a[r][c], in a fixed
// order (no atomics): chunks of COLSUM_ROWS rows into part[chunk][c],
// then the chunks added in order ----
__global__ void colsum_chunks_kernel(const float* __restrict__ a, int rows,
                                     int N, float* __restrict__ part) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const long r0 = (long)blockIdx.y * COLSUM_ROWS;
  const long r1 = r0 + COLSUM_ROWS < rows ? r0 + COLSUM_ROWS : rows;
  float s = 0.f;
  for (long r = r0; r < r1; ++r) s += a[r * N + c];
  part[(long)blockIdx.y * N + c] = s;
}

__global__ void colsum_parts_kernel(const float* __restrict__ part,
                                    int nparts, int N,
                                    float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[(long)p * N + c];
  out[c] = s;
}

inline int colsum_parts(int rows) {
  return (rows + COLSUM_ROWS - 1) / COLSUM_ROWS;
}

// out[c] = sum over nparts rows of part [nparts, N]
inline cudaError_t sum_parts(const float* part, int nparts, int N,
                             float* out, cudaStream_t stream) {
  colsum_parts_kernel<<<(N + 127) / 128, 128, 0, stream>>>(part, nparts, N,
                                                          out);
  return cudaGetLastError();
}

// out[c] = column sums of a [rows, N]; part holds colsum_parts(rows) * N
// floats. rows = 0 writes zeros.
inline cudaError_t colsum(const float* a, int rows, int N, float* part,
                          float* out, cudaStream_t stream) {
  const int nparts = colsum_parts(rows);
  if (nparts > 0) {
    colsum_chunks_kernel<<<dim3((N + 127) / 128, nparts), 128, 0, stream>>>(
        a, rows, N, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return sum_parts(part, nparts, N, out, stream);
}

// ---- the block-diagonal attention core and its backward ----
// Shared memory of the backward, one block per (segment, head): q, k, v
// and do [S][ATT_LD], the scores and dp [S][S + 1] and each row's 1 / sum
// of its exponentials.
inline size_t att_bwd_smem(int S) {
  return sizeof(float) * (4 * S * ATT_LD + 2 * S * (S + 1) + S);
}

// Head h's q | k | v of segment seg (columns h*64 of each third of the
// [rows, 3C] qkv) into sq, sk, sv.
__device__ __forceinline__ void load_qkv(const float* __restrict__ qkv,
                                         long row0, int S, int C, int h,
                                         float* sq, float* sk, float* sv) {
  for (int i = threadIdx.x; i < S * 64; i += blockDim.x) {
    const int r = i >> 6, d = i & 63;
    const float* src = qkv + (row0 + r) * 3 * C + h * 64 + d;
    sq[r * ATT_LD + d] = src[0];
    sk[r * ATT_LD + d] = src[C];
    sv[r * ATT_LD + d] = src[2 * C];
  }
}

// ss[r][j] = (q_r . k_j) * scale over the segment's S x S tile
__device__ __forceinline__ void scores(const float* sq, const float* sk,
                                       float* ss, int S, float scale) {
  const int SL = S + 1;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int r = i / S, j = i % S;
    float a = 0.f;
#pragma unroll 16
    for (int d = 0; d < 64; ++d)
      a = fmaf(sq[r * ATT_LD + d], sk[j * ATT_LD + d], a);
    ss[r * SL + j] = a * scale;
  }
}

// o = softmax(q k^T * scale) v within each segment: qkv [rows, 3C] -> o
// [rows, C] (head h in columns h*64..) as its TF32 split, hi into o and
// lo into o_lo (tf32_split): the operand of the proj's 3xTF32 product.
// One block per G whole segments and one head, on 4 x 4 register tiles
// of a segment's scores and of its o (16-byte vectors of q, k, p and v: a
// quarter of a shared-memory load a multiply-add); P = S rounded up to 4,
// G = 64 / P segments (at least 1), so that a short segment's few tiles
// do not leave the block's 256 threads idle. Shared memory: q, k, v
// [G P][TL_LD] and the scores [G P][P + 4] (rows and keys past S zero).
// The sums run over d, then over the keys, in order.
constexpr int TL_THREADS = 256;
constexpr int TL_LD = 68;

inline int att_fwd_pad(int S) { return (S + 3) / 4 * 4; }
inline int att_fwd_group(int S) {
  const int g = 64 / att_fwd_pad(S);
  return g > 1 ? g : 1;
}
inline size_t att_fwd_smem(int S) {
  const int P = att_fwd_pad(S), R = att_fwd_group(S) * P;
  return sizeof(float) * (3 * R * TL_LD + R * (P + 4));
}

__global__ void __launch_bounds__(TL_THREADS)
attention_core_kernel(const float* __restrict__ qkv, float* __restrict__ o,
                      float* __restrict__ o_lo, int n_seg, int S, int C,
                      float scale) {
  extern __shared__ __align__(16) float smem[];
  const int P = (S + 3) / 4 * 4, T = P / 4, SL = P + 4;
  const int G = max(1, 64 / P), R = G * P;
  float* sq = smem;
  float* sk = sq + R * TL_LD;
  float* sv = sk + R * TL_LD;
  float* ss = sv + R * TL_LD;
  const int seg0 = blockIdx.x * G;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // block row g P + r: token r of segment seg0 + g
  for (int i = threadIdx.x; i < R * 16; i += TL_THREADS) {
    const int row = i >> 4, c = (i & 15) * 4;
    const int g = row / P, r = row % P;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f), k = q, v = q;
    if (r < S && seg0 + g < n_seg) {
      const float* src =
          qkv + ((long)(seg0 + g) * S + r) * 3 * C + h * 64 + c;
      q = *reinterpret_cast<const float4*>(src);
      k = *reinterpret_cast<const float4*>(src + C);
      v = *reinterpret_cast<const float4*>(src + 2 * C);
    }
    *reinterpret_cast<float4*>(sq + row * TL_LD + c) = q;
    *reinterpret_cast<float4*>(sk + row * TL_LD + c) = k;
    *reinterpret_cast<float4*>(sv + row * TL_LD + c) = v;
  }
  __syncthreads();
  // scores: segment g's rows 4 tr.., keys 4 tj.. (ss's columns: the
  // segment's keys)
  for (int t = threadIdx.x; t < G * T * T; t += TL_THREADS) {
    const int g = t / (T * T), u = t % (T * T);
    const int r0 = g * P + u / T * 4, j0 = u % T * 4;
    const float* kg = sk + g * P * TL_LD;
    float a[4][4] = {};
    for (int d = 0; d < 64; d += 4) {
      float4 q[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = *reinterpret_cast<const float4*>(sq + (r0 + i) * TL_LD + d);
        k[i] = *reinterpret_cast<const float4*>(kg + (j0 + i) * TL_LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = fmaf(q[i].x, k[j].x, a[i][j]);
          a[i][j] = fmaf(q[i].y, k[j].y, a[i][j]);
          a[i][j] = fmaf(q[i].z, k[j].z, a[i][j]);
          a[i][j] = fmaf(q[i].w, k[j].w, a[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(ss + (r0 + i) * SL + j0) =
          make_float4(a[i][0] * scale, a[i][1] * scale, a[i][2] * scale,
                      a[i][3] * scale);
  }
  __syncthreads();
  // softmax of each row: p = e / sum(e), e = exp(s - max); keys S..P-1
  // p = 0
  for (int r = warp; r < R; r += TL_THREADS / 32) {
    const float s0 = lane < S ? ss[r * SL + lane] : -CUDART_INF_F;
    const float s1 = lane + 32 < S ? ss[r * SL + lane + 32] : -CUDART_INF_F;
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = lane < S ? expf(s0 - mx) : 0.f;
    const float e1 = lane + 32 < S ? expf(s1 - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (lane < P) ss[r * SL + lane] = e0 / sum;
    if (lane + 32 < P) ss[r * SL + lane + 32] = e1 / sum;
  }
  __syncthreads();
  // o = p v: segment g's rows 4 tr.., columns 4 tc..
  for (int t = threadIdx.x; t < G * T * 16; t += TL_THREADS) {
    const int g = t / (T * 16), u = t % (T * 16);
    const int r0 = g * P + u / 16 * 4, c0 = u % 16 * 4;
    const float* vg = sv + g * P * TL_LD;
    float a[4][4] = {};
    for (int j = 0; j < P; j += 4) {
      float4 p[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = *reinterpret_cast<const float4*>(ss + (r0 + i) * SL + j);
        v[i] = *reinterpret_cast<const float4*>(vg + (j + i) * TL_LD + c0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int u2 = 0; u2 < 4; ++u2) {
          a[i][0] = fmaf(pi[u2], v[u2].x, a[i][0]);
          a[i][1] = fmaf(pi[u2], v[u2].y, a[i][1]);
          a[i][2] = fmaf(pi[u2], v[u2].z, a[i][2]);
          a[i][3] = fmaf(pi[u2], v[u2].w, a[i][3]);
        }
      }
    }
    if (seg0 + g >= n_seg) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i - g * P;
      if (r >= S) break;
      const long at = ((long)(seg0 + g) * S + r) * C + h * 64 + c0;
      float4 hi, lo;
      tf32_split(a[i][0], hi.x, lo.x);
      tf32_split(a[i][1], hi.y, lo.y);
      tf32_split(a[i][2], hi.z, lo.z);
      tf32_split(a[i][3], hi.w, lo.w);
      *reinterpret_cast<float4*>(o + at) = hi;
      *reinterpret_cast<float4*>(o_lo + at) = lo;
    }
  }
}

inline cudaError_t attention_core(const float* qkv, float* o, float* o_lo,
                                  int n_seg, int S, int C, float scale,
                                  cudaStream_t stream) {
  if (n_seg == 0) return cudaSuccess;
  const size_t smem = att_fwd_smem(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = att_fwd_group(S);
  attention_core_kernel<<<dim3((n_seg + G - 1) / G, C / 64), TL_THREADS,
                          smem, stream>>>(qkv, o, o_lo, n_seg, S, C, scale);
  return cudaGetLastError();
}

// The attention core's backward, recomputing the forward: qkv [rows, 3C],
// dattn [rows, C] (the cotangent of o) -> attn = o [rows, C] and dqkv
// [rows, 3C]: with p = softmax(s), dv = p^T do, dp = do v^T,
// ds = p * (dp - rowsum(dp * p)) * scale, dq = ds k, dk = ds^T q. The
// probabilities stay as the exponentials e = exp(s - max) with each row's
// 1 / sum(e), so p = e * inv where it is used.
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_bwd_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ dattn,
                          float* __restrict__ attn, float* __restrict__ dqkv,
                          int S, int C, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int SL = S + 1;
  float* sq = smem;
  float* sk = sq + S * ATT_LD;
  float* sv = sk + S * ATT_LD;
  float* sdo = sv + S * ATT_LD;
  float* se = sdo + S * ATT_LD;
  float* sdp = se + S * SL;
  float* sinv = sdp + S * SL;
  const long row0 = (long)blockIdx.x * S;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_qkv(qkv, row0, S, C, h, sq, sk, sv);
  for (int i = threadIdx.x; i < S * 64; i += ATT_THREADS) {
    const int r = i >> 6, d = i & 63;
    sdo[r * ATT_LD + d] = dattn[(row0 + r) * C + h * 64 + d];
  }
  __syncthreads();
  scores(sq, sk, se, S, scale);
  // dp = do v^T
  for (int i = threadIdx.x; i < S * S; i += ATT_THREADS) {
    const int r = i / S, j = i % S;
    float a = 0.f;
#pragma unroll 16
    for (int d = 0; d < 64; ++d)
      a = fmaf(sdo[r * ATT_LD + d], sv[j * ATT_LD + d], a);
    sdp[r * SL + j] = a;
  }
  __syncthreads();
  // the exponentials and 1 / their sum; ds over dp in place
  for (int r = warp; r < S; r += ATT_THREADS / 32) {
    const float s0 = lane < S ? se[r * SL + lane] : -CUDART_INF_F;
    const float s1 = lane + 32 < S ? se[r * SL + lane + 32] : -CUDART_INF_F;
    const float mx = warp_max(fmaxf(s0, s1));
    const float e0 = lane < S ? expf(s0 - mx) : 0.f;
    const float e1 = lane + 32 < S ? expf(s1 - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    const float p0 = e0 * inv, p1 = e1 * inv;
    const float dp0 = lane < S ? sdp[r * SL + lane] : 0.f;
    const float dp1 = lane + 32 < S ? sdp[r * SL + lane + 32] : 0.f;
    const float rs = warp_sum(dp0 * p0 + dp1 * p1);
    if (lane < S) {
      se[r * SL + lane] = e0;
      sdp[r * SL + lane] = p0 * (dp0 - rs) * scale;
    }
    if (lane + 32 < S) {
      se[r * SL + lane + 32] = e1;
      sdp[r * SL + lane + 32] = p1 * (dp1 - rs) * scale;
    }
    if (lane == 0) sinv[r] = inv;
  }
  __syncthreads();
  const long ld3 = 3L * C;
  for (int i = threadIdx.x; i < S * 64; i += ATT_THREADS) {
    const int r = i >> 6, d = i & 63;     // r: a query row, then a key row
    float o = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < S; ++j) {
      o = fmaf(se[r * SL + j] * sinv[r], sv[j * ATT_LD + d], o);
      dq = fmaf(sdp[r * SL + j], sk[j * ATT_LD + d], dq);
      dk = fmaf(sdp[j * SL + r], sq[j * ATT_LD + d], dk);
      dv = fmaf(se[j * SL + r] * sinv[j], sdo[j * ATT_LD + d], dv);
    }
    attn[(row0 + r) * C + h * 64 + d] = o;
    float* dst = dqkv + (row0 + r) * ld3 + h * 64 + d;
    dst[0] = dq;
    dst[C] = dk;
    dst[2 * C] = dv;
  }
}

inline cudaError_t attention_core_bwd(const float* qkv, const float* dattn,
                                      float* attn, float* dqkv, int n_seg,
                                      int S, int C, float scale,
                                      cudaStream_t stream) {
  if (n_seg == 0) return cudaSuccess;
  const size_t smem = att_bwd_smem(S);
  cudaError_t err = cudaFuncSetAttribute(
      attention_core_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_core_bwd_kernel<<<dim3(n_seg, C / 64), ATT_THREADS, smem,
                              stream>>>(qkv, dattn, attn, dqkv, S, C, scale);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace
