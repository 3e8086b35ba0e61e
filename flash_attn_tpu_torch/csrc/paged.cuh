// Paged-cache visibility, shared by the paged attention kernels K5
// (paged_decode.cu) and K6 (paged_chunk.cu).
//
// Counterpart of flash_attn_tpu/kernels/common.py paged_block_live and
// paged_visibility_mask, which the JAX package shares between _decode_kernel
// and _chunk_kernel so the two cannot diverge; the plain-torch twins are
// flash_attn_tpu_torch/kernels/common.py. Key position j of a sequence is
// visible from a query at global position qpos iff it is cached (j < length)
// and causal (j <= qpos). Decode is the case qpos = length - 1. The window
// and sink terms are ROADMAP port item M4.
#pragma once

namespace fattn {

// The keys a sequence has in its page table: a length past the table is cut
// to the table's capacity, and a negative one (an inactive slot) to 0.
__device__ __forceinline__ int paged_length(int length, int pages_max,
                                            int page_size) {
  return max(0, min(length, pages_max * page_size));
}

__device__ __forceinline__ bool paged_key_visible(int kpos, int qpos,
                                                  int length) {
  return kpos < length && kpos <= qpos;
}

// Keys that query rows whose last position is last_qpos can see at all: the
// bound of the key walk. A key block starting at k0 is live iff k0 < this.
__device__ __forceinline__ int paged_live_keys(int length, int last_qpos) {
  return max(0, min(length, last_qpos + 1));
}

}  // namespace fattn
