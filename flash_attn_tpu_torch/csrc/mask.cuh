// Dense-attention visibility, shared by the forward and backward kernels.
//
// Counterpart of the masking algebra that flash_attn_tpu/kernels/common.py
// shares between the Pallas forward and backward (block_mask_predicates,
// attention_mask): one definition, so the two cannot diverge. Causal
// masking is top-left aligned (key j is visible from query i iff j <= i),
// also when sq != sk, as in the JAX package; keys past sk are never visible.
#pragma once

namespace fattn {

__device__ __forceinline__ bool key_visible(int row, int col, int sk,
                                            bool causal) {
  return col < sk && (!causal || col <= row);
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
