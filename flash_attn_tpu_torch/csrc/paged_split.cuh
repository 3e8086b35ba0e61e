// Split-KV for the paged attention kernels K5 (paged_decode.cu) and K6
// (paged_chunk.cu): the device side of one algorithm, so the two cannot
// diverge.
//
// A small grid (decode at small batch, verification at sq = 5) leaves most
// SMs idle while each block walks a whole sequence. The host then cuts the
// page table into n_splits ranges of split_keys keys (whole pages, whole
// 64-key tiles; kernels/common.py paged_num_splits picks the count from
// shapes alone, never from the device-resident lengths), and one block per
// (split, ...) walks its range alone. Each writes a partial for each of its
// query rows: o normalised by its own sum, fp32, and its lse in log2 units,
// -inf where the split saw no key (a split that starts at or past the
// sequence's keys writes only that). paged_merge_kernel then merges the
// partials of each row in split order, so the result is deterministic; a
// partial of lse -inf contributes exactly 0 and its o is never read. The
// plain-torch twin is kernels/common.py merge_partials, the counterpart of
// flash_attn_tpu/parallel/ring.py _merge_partials.
//
// Partials, one fp32 scratch tensor from the caching allocator: o
// (n_splits, rows, D), then lse (n_splits, rows). rows are the output's
// rows, contiguous rows of D elements in the output's layout.
#pragma once

#include "common.cuh"

namespace fattn {

// How a launch splits the keys: n_splits ranges of split_keys keys each.
// o_part is nullptr when n_splits == 1: the kernel then writes the output.
struct SplitKV {
  float* o_part;
  int n_splits, split_keys, rows;
};

// The lse, in log2 units, of a row with running max m (log2 units) and
// sum l: -inf where the row saw no key.
__device__ __forceinline__ float partial_lse2(float m, float l) {
  return l > 0.f ? m + log2f(l) : -INFINITY;
}

// One row's partial: o (already normalised) where the split saw a key,
// and the lse.
__device__ __forceinline__ float* partial_o(const SplitKV& sp, int split,
                                           int row, int d) {
  return sp.o_part + ((size_t)split * sp.rows + row) * d;
}
__device__ __forceinline__ float* partial_lse(const SplitKV& sp, int split,
                                              int row, int d) {
  return sp.o_part + (size_t)sp.n_splits * sp.rows * d +
         (size_t)split * sp.rows + row;
}

namespace {  // each source that includes this header has its own copy

// One warp per output row; lane owns D / 32 consecutive columns.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    paged_merge_kernel(const SplitKV sp, T* out) {
  constexpr int kPer = D / 32;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= sp.rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < sp.n_splits; ++s) {
    mx = fmaxf(mx, *partial_lse(sp, s, row, D));
  }
  float acc[kPer], w_sum = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  for (int s = 0; s < sp.n_splits && mx != -INFINITY; ++s) {
    const float lse = *partial_lse(sp, s, row, D);
    if (lse == -INFINITY) continue;
    const float w = exp2f(lse - mx);
    const float* o = partial_o(sp, s, row, D) + lane * kPer;
    w_sum += w;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] += w * o[e];
  }
  const float inv = w_sum > 0.f ? 1.f / w_sum : 0.f;
  T* dst = out + (size_t)row * D + lane * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) dst[e] = from_float<T>(acc[e] * inv);
}

template <typename T, int D>
cudaError_t launch_merge(const SplitKV& sp, T* out, cudaStream_t st) {
  paged_merge_kernel<T, D><<<(sp.rows + 7) / 8, 256, 0, st>>>(sp, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fattn
