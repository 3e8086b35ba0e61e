// Counter-based dropout hash, shared by the forward and backward kernels.
//
// Device twin of flash_attn_tpu_torch/kernels/prng.py, which ports
// flash_attn_tpu/kernels/prng.py (hash_coords, keep_mask). The decision for
// attention element (b, h, i, j) is a pure hash of (seed, b * h_q + h, i, j),
// so every kernel regenerates the same mask whatever its tiling and only the
// integer seed crosses from the forward to the backward. The hash is
// separable: the row half (one full mixing round) is computed once per row,
// and each element pays one more round. Drop iff hash < threshold, with
// threshold = min(floor(p * 2^32), 2^32 - 1) computed by the wrapper.
#pragma once

#include <stdint.h>

namespace fattn {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The row half of the hash: depends on (seed, bh, row) only.
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, uint32_t bh,
                                             uint32_t row) {
  return mix32((row * 0x9E3779B1u) ^ (bh * 0xC2B2AE3Du) ^ seed);
}

__device__ __forceinline__ bool keep_elem(uint32_t row_hash, uint32_t col,
                                          uint32_t threshold) {
  return mix32(row_hash ^ (col * 0x85EBCA77u)) >= threshold;
}

// Dropout parameters as the kernels take them; threshold 0 keeps all.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float rp;  // 1 / (1 - p)
  __device__ __forceinline__ bool on() const { return threshold != 0u; }
};

}  // namespace fattn
