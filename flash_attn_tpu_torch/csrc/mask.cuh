// Dense-attention visibility, shared by the forward and backward kernels.
//
// Counterpart of the masking algebra that flash_attn_tpu/kernels/common.py
// shares between the Pallas forward and backward (block_mask_predicates,
// attention_mask): one definition, so the two cannot diverge. Causal
// masking is top-left aligned (key j is visible from query i iff j <= i),
// also when sq != sk, as in the JAX package; keys past sk are never visible.
#pragma once

#include <cuda_runtime.h>

namespace fattn {

__device__ __forceinline__ bool key_visible(int row, int col, int sk,
                                            bool causal) {
  return col < sk && (!causal || col <= row);
}

// Segment form (flash_fwd.py:326-333 and flash_bwd.py:75-84 there): key k
// is visible from query q iff both carry the same non-negative segment id
// and, under causal masking, the query's position is not before the key's.
// x is the segment id, y the position (per segment, so causal is top-left
// inside each segment); rows and keys out of bounds carry id -1. K1 and K2
// walk only the tiles their plan calls live (csrc/segments.cuh).
__device__ __forceinline__ bool seg_visible(int2 q, int2 k, bool causal) {
  return q.x >= 0 && q.x == k.x && (!causal || q.y >= k.y);
}

// Keys a query tile [q0, q0 + block_q) can see at all: the loop bound of the
// forward's key walk.
__device__ __forceinline__ int keys_for_rows(int q0, int block_q, int sk,
                                             bool causal) {
  return causal ? min(sk, q0 + block_q) : sk;
}

// First query row that can see key k0: where the backward's walk over query
// tiles starts for the key tile at k0.
__device__ __forceinline__ int first_row_for_keys(int k0, bool causal) {
  return causal ? k0 : 0;
}

}  // namespace fattn
