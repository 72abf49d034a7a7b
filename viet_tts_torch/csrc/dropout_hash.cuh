// Attention-weight dropout bits shared by the flash-attention forward (K1)
// and both backward kernels (K3a bwd_q, K3b bwd_kv).
//
// keep(seed, b, h, i, j) depends on the seed and the element's coordinates
// only (batch row b, head h, query i, key j), never on a tile size, so three
// kernels with three tilings regenerate the same mask without it ever
// reaching device memory. The TPU kernel drew per-tile bits from the
// on-core PRNG (viet_tts_tpu/ops/pallas_attention.py:_tile_dropout_mask);
// those bits cannot be reproduced here, so this is a counter-based hash of
// the same kind: two rounds of murmur3's 32-bit finaliser over the packed
// coordinates, keyed by the 64-bit seed. The plain PyTorch version
// (viet_tts_torch/ops/flash_attention.py:dropout_keep_mask) computes the
// same bits with 64-bit integer tensors.
//
// An element is kept when its 32-bit hash is below
// thresh = min(floor((1 - p) * 2^32), 2^32 - 1), the JAX package's rule.

#pragma once

#include <stdint.h>

__host__ __device__ __forceinline__ uint32_t vt_fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// The stream key of one (seed, batch row, head); b and h below 2^16.
__host__ __device__ __forceinline__ uint32_t vt_dropout_key(uint64_t seed,
                                                            int b, int h) {
  uint32_t k = vt_fmix32((uint32_t)seed ^ 0x9e3779b9u);
  k = vt_fmix32(k ^ (uint32_t)(seed >> 32));
  return vt_fmix32(k ^ (((uint32_t)b << 16) | (uint32_t)h));
}

// Whether weight (i, j) of the stream `key` is kept; i and j below 2^16.
__host__ __device__ __forceinline__ bool vt_dropout_keep(uint32_t key, int i,
                                                         int j,
                                                         uint32_t thresh) {
  uint32_t x = vt_fmix32(key ^ (((uint32_t)i << 16) | (uint32_t)j));
  x = vt_fmix32(x + key);
  return x < thresh;
}

__host__ __device__ __forceinline__ uint32_t vt_dropout_thresh(double p) {
  const double keep = 1.0 - p;
  const double t = keep * 4294967296.0;
  return t >= 4294967295.0 ? 4294967295u : (uint32_t)t;
}
