// Block-diagonal softmax attention for Hopper (sm_90a):
//
//     out[n, s, h] = sum_t softmax_t(q[n, s, h] . k[n, t, h] * scale) v[n, t, h]
//
// qkv is [n_seg, S, 3C] bf16, laid out q | k | v with the heads contiguous
// (head h at columns h*64 of each third); out is [n_seg, S, C] bf16. Each
// segment of S tokens attends only within itself.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _kernel, driven by
// _block_attention_impl: the forward of the public op block_diag_attention
// (its backward is autograd through the plain version, as the JAX op's is
// the XLA reference's vjp).
//
// Rounding points are the TPU kernel's: scores q k^T accumulated in float32
// and times scale, the softmax in float32, p cast to bf16 for P.V, and o
// accumulated in float32 and rounded once.
//
// Design. The attention core of csrc/fused_attention_residual.cu without
// the projections around it. One block of 4 warps takes RT / S whole
// segments, RT = 48 rows for S <= 48 (8 segments at S=6) and 64 rows up to
// S = 64 (one segment at S=50); a ragged last block loads zeros for its
// missing rows and does not write them. The block walks the heads; each
// head's q | k | v [RT, 192] comes in by cp.async while the previous head
// is computed (double-buffered). Scores over the RT x RT tile in float32
// (shared memory), the softmax within each row's segment (one warp a row),
// P.V from shared memory, all on mma.sync m16n8k16 with ldmatrix operands.
//
// What bounds it on this card. 8 bytes in and out per (row, column of C)
// against 4*S flops a pair: bound by the bytes (0.0345 ms at S=6,
// n_seg=3136; 0.0059 ms at S=50, n_seg=64). At S=6 the RT x RT score tile
// computes 8 times the products that the 6-wide segments need.

#include "tile_ops.cuh"

namespace {

constexpr int D = 64;              // head width
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QKV_LD = 3 * D + 8;  // one head's q | k | v, padded

template <int RT>
struct Shape {
  static constexpr int MT = RT / 16;
  static constexpr int S_LD = RT + 4;    // float32 scores
  static constexpr int P_LD = RT + 8;    // bf16 probabilities
  static constexpr size_t SMEM = sizeof(bf16) * (2 * RT * QKV_LD +
                                                 RT * P_LD) +
                                 sizeof(float) * RT * S_LD;
};

// Head h's q | k | v of the block's rows into dst; rows at or past R zeros.
template <int RT>
__device__ __forceinline__ void load_head(bf16* dst, const bf16* qkv, int h,
                                          long row0, int R, int C) {
  for (int i = threadIdx.x; i < RT * 3 * (D / 8); i += THREADS) {
    const int r = i / (3 * (D / 8)), rem = i % (3 * (D / 8));
    const int part = rem / (D / 8), seg = rem % (D / 8);
    bf16* d = dst + r * QKV_LD + part * D + seg * 8;
    if (r < R)
      cp_async16(d, qkv + (row0 + r) * (3L * C) + part * C + h * D + seg * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

template <int RT>
__global__ void __launch_bounds__(THREADS)
block_diag_attention_kernel(const bf16* __restrict__ qkv,
                            bf16* __restrict__ out, int n_seg, int S, int C,
                            float scale) {
  typedef Shape<RT> Sh;
  constexpr int MT = Sh::MT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQKV = reinterpret_cast<bf16*>(smem);          // 2 x [RT, QKV_LD]
  bf16* sP = sQKV + 2 * RT * QKV_LD;
  float* sS = reinterpret_cast<float*>(sP + RT * Sh::P_LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int G = RT / S;                      // segments per block
  const int seg0 = blockIdx.x * G;
  const int R = min(G, n_seg - seg0) * S;    // live rows of this block
  const long row0 = (long)seg0 * S;
  const int H = C / D;

  load_head<RT>(sQKV, qkv, 0, row0, R, C);
  cp_async_commit();
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H)
      load_head<RT>(sQKV + ((h + 1) & 1) * RT * QKV_LD, qkv, h + 1, row0, R,
                    C);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* sq = sQKV + (h & 1) * RT * QKV_LD;
    // scores q k^T over the RT x RT tile (float32)
    for (int task = warp; task < MT * MT; task += WARPS) {
      const int mt = task % MT, nt = task / MT;
      float c[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_a(a, sq + mt * 16 * QKV_LD + k0, QKV_LD, lane);
        ldsm_bt2(b, sq + nt * 16 * QKV_LD + D + k0, QKV_LD, lane);
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
    // softmax within each row's segment, bf16 p (zeros elsewhere)
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
        if (c < RT) sP[r * Sh::P_LD + c] = __float2bfloat16(e[u] * inv);
      }
    }
    __syncthreads();
    // o = P V, rounded once, to out (live rows)
    for (int task = warp; task < MT * (D / 16); task += WARPS) {
      const int mt = task % MT, nt = task / MT;
      float c[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < RT; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_a(a, sP + mt * 16 * Sh::P_LD + k0, Sh::P_LD, lane);
        ldsm_b2(b, sq + k0 * QKV_LD + 2 * D + nt * 16, QKV_LD, lane);
        mma16816(c[0], a, b[0], b[1]);
        mma16816(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mt * 16 + gq + 8 * hr;
          if (row < R)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (row0 + row) * C + h * D + nt * 16 + n * 8 + 2 * t) =
                __floats2bfloat162_rn(c[n][2 * hr], c[n][2 * hr + 1]);
        }
    }
    __syncthreads();     // this buffer is loaded again for head h + 2
  }
}

template <int RT>
cudaError_t launch(const bf16* qkv, bf16* out, int n_seg, int S, int C,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<RT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      block_diag_attention_kernel<RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = RT / S;
  block_diag_attention_kernel<RT><<<(n_seg + G - 1) / G, THREADS, smem,
                                    stream>>>(qkv, out, n_seg, S, C, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success). Arguments are
// checked by the Python wrapper: n_seg >= 1, S in 1..64, C a positive
// multiple of 64 (head width 64), qkv and out 16-byte aligned.
int launch_block_diag_attention(const void* qkv, void* out, int n_seg, int S,
                                int C, float scale, void* stream) {
  if (n_seg < 1 || S < 1 || S > 64 || C <= 0 || C % D != 0)
    return (int)cudaErrorInvalidValue;
  if (S <= 48)
    return (int)launch<48>((const bf16*)qkv, (bf16*)out, n_seg, S, C, scale,
                           (cudaStream_t)stream);
  return (int)launch<64>((const bf16*)qkv, (bf16*)out, n_seg, S, C, scale,
                         (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
