// Paged-cache visibility, shared by the paged attention kernels K5
// (paged_decode.cu) and K6 (paged_chunk.cu).
//
// Counterpart of flash_attn_tpu/kernels/common.py paged_block_live,
// paged_visibility_mask and paged_block_softmax, which the JAX package
// shares between _decode_kernel and _chunk_kernel so the two cannot
// diverge; the plain-torch twins are flash_attn_tpu_torch/kernels/common.py.
// Key position j of a sequence is visible from a query at global position
// qpos iff it is cached (j < length), causal (j <= qpos) and, with a window
// of left L, inside the band (j >= qpos - L) or a sink (j < sinks). Decode
// is the case qpos = length - 1.
//
// The walk (paged_walk): a launch serves rows whose loosest band floor is
// that of its first row (common.py:245: a tighter row's floor drops keys
// earlier rows need), so it walks the sink tiles [0, front) and then the
// band from that floor, rounded down to a 64-key tile, to its causal end.
// Keys are numbered along the walk ("walk index" v: positions [0, front)
// keep their index, the band's start at front), and K5's and K6's splits
// cut the walk, not the table, so pages wholly below the band are never
// fetched and a window's cost follows the band, not the context.
#pragma once

#include "common.cuh"

namespace fattn {

// The keys a sequence has in its page table: a length past the table is cut
// to the table's capacity, and a negative one (an inactive slot) to 0.
__device__ __forceinline__ int paged_length(int length, int pages_max,
                                            int page_size) {
  return max(0, min(length, pages_max * page_size));
}

// The M4 terms of a paged launch (host-filled).
struct PagedBand {
  int left = -1;  // window: -1 unbounded
  int sinks = 0;  // leading positions kept visible (only with a window)
  float cap = 0.f;  // softcap on the scaled score (0: none)
  const float* alibi = nullptr;  // (h_kv * group,) slopes, not over scale

  __host__ __device__ bool logits() const {
    return cap != 0.f || alibi != nullptr;
  }
};

inline bool make_paged_band(PagedBand* pb, int left, int sinks, float cap,
                            const void* alibi) {
  if (left < -1 || sinks < 0 || !(cap >= 0.f)) return false;
  pb->left = left;
  pb->sinks = left >= 0 ? sinks : 0;
  pb->cap = cap;
  pb->alibi = static_cast<const float*>(alibi);
  return true;
}

__device__ __forceinline__ bool paged_key_visible(int kpos, int qpos,
                                                  int length,
                                                  const PagedBand& pb) {
  return kpos < length && kpos <= qpos &&
         (pb.left < 0 || kpos >= qpos - pb.left || kpos < pb.sinks);
}

// Keys that query rows whose last position is last_qpos can see at all: the
// end of the key walk.
__device__ __forceinline__ int paged_live_keys(int length, int last_qpos) {
  return max(0, min(length, last_qpos + 1));
}

// The score in log2 units from the scaled score u (scale * q . k): the
// softcap, then the ALiBi bias slope * (kpos - qpos), as paged_block_softmax
// there orders them.
__device__ __forceinline__ float paged_logit(float u, const PagedBand& pb,
                                             float slope, int rel) {
  if (pb.cap != 0.f) u = pb.cap * tanhf(u / pb.cap);
  if (pb.alibi != nullptr) u += slope * (float)rel;
  return u * kLog2e;
}

constexpr int kWalkTile = 64;  // the walk's pieces are whole 64-key tiles

struct PagedWalk {
  int end;       // positions past the walk
  int floor;     // the loosest band floor (0 without a window)
  int sink_end;  // sink positions [0, sink_end)
  int front;     // walk indices [0, front) are positions [0, front)
  int band0;     // position of walk index front (a multiple of 64)
  int n;         // walk indices

  __device__ __forceinline__ int pos(int v) const {
    return v < front ? v : band0 + (v - front);
  }
  __device__ __forceinline__ int index(int pos) const {
    return pos < front ? pos : front + (pos - band0);
  }
  // Some row of the launch may see position pos: a key that is not is
  // never fetched (zero-filled or skipped).
  __device__ __forceinline__ bool loads(int pos) const {
    return pos < end && (pos < sink_end || pos >= floor);
  }
  // Some position of [pos, pos + n) loads.
  __device__ __forceinline__ bool loads_any(int pos, int n) const {
    return pos < end && pos + n > 0 &&
           (pos < sink_end || pos + n > floor);
  }
};

// The walk of rows whose positions start at first_qpos and whose keys end
// at `end` (paged_live_keys of the last row).
__device__ __forceinline__ PagedWalk paged_walk(int end, int first_qpos,
                                                const PagedBand& pb) {
  PagedWalk w;
  w.end = max(end, 0);
  w.floor = pb.left >= 0 ? max(0, first_qpos - pb.left) : 0;
  w.sink_end = min(pb.sinks, w.end);
  w.front = (w.sink_end + kWalkTile - 1) / kWalkTile * kWalkTile;
  w.band0 = w.floor / kWalkTile * kWalkTile;
  if (w.front >= w.band0) {  // the sink tiles reach the band: one run
    w.front = 0;
    w.band0 = 0;
  }
  w.n = w.front + max(0, w.end - w.band0);
  return w;
}

}  // namespace fattn
