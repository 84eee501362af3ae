// The dropout keep-mask every reg kernel of the port uses (sm_90a): a
// counter hash of (seed, site, row, column), murmur3's fmix32 applied twice
// over a linear mix of the two position counters. It is the JAX package's
// keep_mask_from_counters (duoformer_tcga_tpu/ops/pallas_attention.py:
// 56-125) bit for bit, and ops/dropout.py's plain version: 32-bit words
// with wrap-around (unsigned here, where signed overflow is undefined),
// logical shifts, keep iff the top 24 bits fall under thr = round((1 -
// rate) * 2^24), which the host computes, and a kept value times
// float32(1 / (1 - rate)), also from the host. The hash exists once on the
// card, in this header, so a backward regenerates its forward's masks.
//
// Counters are global positions, never block-local ones: the attention
// site takes the global token index (segment * S + t) for row and column,
// the row-space sites (proj, MLP hidden, MLP output) the global flat row
// and the column. Site salts: attention of head h 4h, proj 1, MLP hidden 2,
// MLP output 3.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t HASH_K_ROW = 0x9E3779B1u;
constexpr uint32_t HASH_K_COL = 0x85EBCA77u;
constexpr uint32_t HASH_FMIX1 = 0x85EBCA6Bu;
constexpr uint32_t HASH_FMIX2 = 0xC2B2AE35u;
constexpr uint32_t HASH_K_SITE = 0x27D4EB2Fu;

constexpr uint32_t SITE_ATTN = 0;   // + 4 * head
constexpr uint32_t SITE_PROJ = 1;
constexpr uint32_t SITE_MLP_HID = 2;
constexpr uint32_t SITE_MLP_OUT = 3;

__host__ __device__ __forceinline__ uint32_t hash_fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= HASH_FMIX1;
  x ^= x >> 13;
  x *= HASH_FMIX2;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t site_seed(uint32_t seed,
                                                       uint32_t salt) {
  return seed + salt * HASH_K_SITE;
}

// keep_mask_from_counters for one element; seed_plus has the site folded in.
__device__ __forceinline__ bool keep_mask(uint32_t seed_plus, uint32_t row,
                                          uint32_t col, uint32_t thr) {
  uint32_t x = row * HASH_K_ROW + col * HASH_K_COL + seed_plus;
  x = hash_fmix32(x);
  x = hash_fmix32(x + seed_plus);
  return (x >> 8) < thr;
}

// One dropout site of a kernel call. on = 0: no dropout at this site.
struct Drop {
  uint32_t seed_plus;
  uint32_t thr;
  float scale;
  int on;

  __device__ __forceinline__ float apply(float v, uint32_t row,
                                         uint32_t col) const {
    return keep_mask(seed_plus, row, col, thr) ? v * scale : 0.f;
  }
};

// The site `salt` of a call whose dropout is (seed, thr, scale); thr < 0
// switches it off.
__host__ __device__ __forceinline__ Drop make_drop(int seed, uint32_t salt,
                                                   int thr, float scale) {
  Drop d;
  d.seed_plus = site_seed((uint32_t)seed, salt);
  d.thr = thr < 0 ? 0u : (uint32_t)thr;
  d.scale = scale;
  d.on = thr >= 0;
  return d;
}

}  // namespace
