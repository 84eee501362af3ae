// The attention residual branch in float32 for Hopper (sm_90a):
//
//     y = [x +] proj( block-diagonal softmax attention( qkv( [LN](x) ) ) )
//
// x is [n_seg, S, C] float32, S <= 64; each segment of S tokens attends
// only within itself. Weights are float32 in (in, out) layout: wqkv
// [C, 3C] (columns q | k | v, head h at h*64), wproj [C, C]; the
// LayerNorm scale/bias and both biases float32.
//
// Replaces: duoformer_tcga_tpu/ops/pallas_attention.py, _fused_block_kernel
// (driven by _fused_block_impl) at dtype float32, inert: the full form
// (LN + residual) in every ScaleBlock of the release model built with
// dtype float32 (S=6 at 2 scales, 22 at 3), the bare form (use_ln =
// use_residual = 0) in every PatchBlock (S=50). In float32 each of the
// TPU kernel's casts to x's dtype is a no-op, so it computes in float32
// throughout, with row tiles halved by _f32_shrink; so does this chain,
// with no rounding point below float32.
//
// Design: one C entry a call, a chain of launches on the caller's stream
// into one float32 scratch the wrapper allocates:
//   1. the weights' TF32 split (f32_tile.cuh's tf32_split), transposed
//      into K-major hi and lo planes, wqkv^T [3C, C] and wproj^T [C, C]
//      (wgmma reads 32-bit operands K-major only); one launch for both;
//   2. the LayerNorm of x as its hi and lo planes [rows, C] (full form),
//      or x's split (bare form);
//   3. qkv = A wqkv + bqkv [rows, 3C] on gemm_sm90.cuh's EPI_X3: 3xTF32
//      wgmma products, hi·lo + lo·hi + hi·hi a k-step into one float32
//      accumulator, in one fixed order (a second launch gives the same
//      bits);
//   4. the attention core (f32_tile.cuh, FMA: 3% of the flops at S=50),
//      one block per head and 64 / S whole segments, on 4 x 4 register
//      tiles, writing o's hi and lo planes over step 2's (the qkv product
//      has read them);
//   5. y = o wproj + bproj [+ x] on EPI_X3, bias and residual added in
//      float32 in its epilogue; rows past rows are never stored.
//
// What bounds it on this card: the two products, 2*rows*C*4C flops at
// three TF32 products a multiply-add (495 / 3 = 165 TFLOP/s of float32
// work); the chain moves the planes, qkv and o through device memory
// (the TPU kernel keeps them in VMEM), ~44 bytes a row and column more
// than the 8 the function must move, and each product stage brings 64 KB
// from L2 for 3.1 MFLOP (48 flops a byte).

#include "f32_tile.cuh"
#include "gemm_sm90.cuh"

namespace {

// the TF32 split of one weight w [K, N] (in, out) into K-major planes
// hi, lo [N, K]
struct SplitJob {
  const float* w;
  float* hi;
  float* lo;
  int N;
};

// Both weights' splits, blockIdx.z the weight: 32 x 32 tiles of w through
// shared memory, read along N and written along K.
__global__ void __launch_bounds__(256)
split_weights_kernel(const SplitJob j0, const SplitJob j1, int K) {
  const SplitJob j = blockIdx.z ? j1 : j0;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  if (n0 >= j.N) return;
  __shared__ float t[32][33];
  for (int r = threadIdx.y; r < 32; r += 8)
    t[r][threadIdx.x] = j.w[(long)(k0 + r) * j.N + n0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {   // row n0 + r of the planes
    float hi, lo;
    f32::tf32_split(t[threadIdx.x][r], hi, lo);
    const long at = (long)(n0 + r) * K + k0 + threadIdx.x;
    j.hi[at] = hi;
    j.lo[at] = lo;
  }
}

// x's TF32 split, four floats a thread: the bare form's A.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                  float4* __restrict__ lo, long n4) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 v = x[i];
  float4 h, l;
  f32::tf32_split(v.x, h.x, l.x);
  f32::tf32_split(v.y, h.y, l.y);
  f32::tf32_split(v.z, h.z, l.z);
  f32::tf32_split(v.w, h.w, l.w);
  hi[i] = h;
  lo[i] = l;
}

cudaError_t split_weights(SplitJob j0, SplitJob j1, int K,
                          cudaStream_t stream) {
  const int n = std::max(j0.N, j1.N);
  split_weights_kernel<<<dim3(n / 32, K / 32, j1.w != nullptr ? 2 : 1),
                         dim3(32, 8), 0, stream>>>(j0, j1, K);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(const float* x, const float* lns, const float* lnb,
                   const float* wqkv, const float* bqkv, const float* wproj,
                   const float* bproj, float* out, float* scratch, int n_seg,
                   int S, float scale, float eps, int use_ln,
                   int use_residual, cudaStream_t stream) {
  const int rows = n_seg * S;
  float* wq_hi = scratch;
  float* wq_lo = wq_hi + 3 * C * C;
  float* wp_hi = wq_lo + 3 * C * C;
  float* wp_lo = wp_hi + C * C;
  float* a_hi = wp_lo + C * C;
  float* a_lo = a_hi + (long)rows * C;
  float* qkv = a_lo + (long)rows * C;
  cudaError_t err = split_weights(SplitJob{wqkv, wq_hi, wq_lo, 3 * C},
                                  SplitJob{wproj, wp_hi, wp_lo, C}, C,
                                  stream);
  if (err != cudaSuccess) return err;
  if (use_ln) {
    err = f32::ln_fwd_split<C>(x, lns, lnb, eps, a_hi, a_lo, rows, stream);
  } else {
    const long n4 = (long)rows * C / 4;
    split_rows_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(a_hi),
        reinterpret_cast<float4*>(a_lo), n4);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  GemmArgs g{};
  g.M = rows;
  g.N = 3 * C;
  g.K = C;
  g.bias = bqkv;
  g.out = qkv;
  err = run_gemm<EPI_X3, false, true>(a_hi, wq_hi, nullptr, nullptr, g,
                                      stream, a_lo, wq_lo);
  if (err != cudaSuccess) return err;
  err = f32::attention_core(qkv, a_hi, a_lo, n_seg, S, C, scale, stream);
  if (err != cudaSuccess) return err;
  g.N = C;
  g.bias = bproj;
  g.out = out;
  g.xf = use_residual ? x : nullptr;
  return run_gemm<EPI_X3, false, true>(a_hi, wp_hi, nullptr, nullptr, g,
                                       stream, a_lo, wp_lo);
}

}  // namespace

extern "C" {

// Returns the first failing launch's cudaGetLastError() (0 on success).
// Arguments are checked by the Python wrapper: S in 1..64, C = 64 *
// num_heads with C in {256, 512, 768}, every pointer 32-byte aligned;
// scratch holds 8 C^2 + 5 rows C floats (rows = n_seg * S): the weights'
// planes, A's planes [rows, C] (the LayerNorm or x, then o) and qkv
// [rows, 3C].
int launch_fused_attention_residual_f32(
    const void* x, const void* lns, const void* lnb, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, void* out,
    void* scratch, int n_seg, int S, int C, int num_heads, float scale,
    float eps, int use_ln, int use_residual, void* stream) {
  if (n_seg < 1 || S < 1 || S > 64 || C != num_heads * 64)
    return (int)cudaErrorInvalidValue;
#define ARGS                                                                 \
  (const float*)x, (const float*)lns, (const float*)lnb, (const float*)wqkv, \
      (const float*)bqkv, (const float*)wproj, (const float*)bproj,          \
      (float*)out, (float*)scratch, n_seg, S, scale, eps, use_ln,            \
      use_residual, (cudaStream_t)stream
  switch (C) {
    case 256: return (int)launch<256>(ARGS);
    case 512: return (int)launch<512>(ARGS);
    case 768: return (int)launch<768>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// The weights' split alone (step 1, for the checks): w [K, N] float32 ->
// its K-major planes hi, lo [N, K]; K and N multiples of 32.
int launch_tf32_split_weight(const void* w, void* hi, void* lo, int K, int N,
                             void* stream) {
  if (K < 32 || N < 32 || K % 32 != 0 || N % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)split_weights(SplitJob{(const float*)w, (float*)hi,
                                     (float*)lo, N},
                            SplitJob{nullptr, nullptr, nullptr, 0}, K,
                            (cudaStream_t)stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
