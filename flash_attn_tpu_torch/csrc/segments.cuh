// The segment (varlen) form of K1 and K2: the tile plan that a pre-pass
// (csrc/segments.cu seg_plan_kernel) builds from the segment ids and
// positions, and the per-element visibility test.
//
// Replaces the segment branch of the Pallas kernels (flash_fwd.py:314-333
// and :474-485, flash_bwd.py:63-90 and :322-327 there) and their block
// classification (kernels/common.py:205 classify_segment_block). The JAX
// kernels classify each grid step at run time, after its K/V tile has been
// fetched (flash_fwd.py:785-787). Here the plan is known before a tile is
// put into a TMA ring: for every (64-row query tile, 128-key tile) pair it
// holds a class, and the kernels walk lists of the live pairs only:
//   - dead: no visible pair; neither loaded nor computed;
//   - full: one shared non-negative segment on both sides, fully past under
//     causal masking, every row and key in bounds: no per-element test;
//   - partial: anything else; every element is tested (against the row's
//     interval in the interval form below, else csrc/mask.cuh
//     seg_visible).
// Classes come from per-tile (min, max) summaries, so they are
// conservative: a tile called partial may still hold no visible pair, and
// then its elements all test false.
//
// Interval form. Where every segment's tokens are one run on each side,
// runs in increasing id order, padding only at the end and positions 0, 1,
// ... inside each run (padded batches, and packed sequences from
// cu_seqlens), the keys a query row sees are one interval [lo, hi) of key
// indices (causal: cut at the run's start + the query's position), and
// the queries that see a key one interval of query indices. The plan then
// holds those intervals and a flag per batch row, and a partial tile tests
// each element against two bounds held in registers instead of loading
// the (id, position) pairs. Other layouts take the pairwise test.
//
// K2's deterministic dQ (csrc/flash_bwd.cu) ranks the blocks that add into
// a query tile by launch order. A block skips the query tiles its key tile
// cannot see, so the ranks are counted over live pairs only: the plan
// holds, for each live pair, the number of blocks launched earlier that
// are live on the same query tile. A block then waits only for blocks
// that really add there. K2's segment form launches the key tiles last
// first: in packed sequences key tile kt meets a query tile it shares
// with tile kt - 1 at the start of its walk and kt - 1 at the end of its
// own, so the higher tile adds first and neither waits long (in the other
// order each tile would wait for the previous one's whole walk, down the
// packed sequence: 10x slower at 32 sequences, PERF.md).
//
// Plan layout (int32 words; every section starts on a 16-byte boundary),
// for b rows, sq queries and sk keys:
//   qsp   int2 [b][sq128]          (segment id, position) per query row;
//                                  id -1 past sq
//   ksp   int2 [b][sk128]          the same per key; id -1 past sk
//   qsum  int  [b][n_q64][8]       per 64-row query tile: segment min and
//                                  max, position min and max over its valid
//                                  rows, and whether the tile is pure (all
//                                  rows valid, one segment)
//   ksum  int  [b][n_k128][8]      the same per 128-key tile
//   cls   u32  [b][n_q64][n_k128]  class | (dQ rank << 2)
//   fwd_n int  [b][n_q128]         live key tiles of each 128-row tile
//   fwd   u32  [b][n_q128][n_k128] key tile | class of rows 0-63 << 28 |
//                                  class of rows 64-127 << 30
//   bwd_n int  [b][n_k128]         live query tiles of each key tile
//   bwd   int2 [b][n_k128][n_q64]  (query tile | class << 30, dQ rank)
//   ivf   int  [b]                 1: the row is in interval form
//   qiv   int2 [b][sq128]          per query row: its keys [lo, hi)
//   kiv   int2 [b][sk128]          per key: its queries [lo, hi)
// (an empty interval is (0, 0); both are 0 where ivf is 0).
// kernels/common.py segment_plan_plain builds the same words in plain
// torch.
#pragma once

#include <stdint.h>

#include "mask.cuh"

namespace fattn {

enum TileClass : int { kTileDead = 0, kTilePartial = 1, kTileFull = 2 };
constexpr uint32_t kTileIndex = 0x0FFFFFFFu;  // a fwd list entry's key tile
constexpr int kSumWords = 8;                  // words of a tile summary

__host__ __device__ inline long long round4(long long n) {
  return (n + 3) / 4 * 4;
}

// Pointers into one plan buffer; nullptr qsp: no segments.
template <typename W>
struct SegPlanT {
  int n_q64, n_q128, n_k128, sq128, sk128;
  W* qsp;  // int2
  W* ksp;  // int2
  W* qsum;
  W* ksum;
  W* cls;
  W* fwd_n;
  W* fwd;
  W* bwd_n;
  W* bwd;  // int2
  W* ivf;
  W* qiv;  // int2
  W* kiv;  // int2
  long long words;  // the buffer's size

  __host__ __device__ static SegPlanT at(W* base, int b, int sq, int sk) {
    SegPlanT p;
    p.n_q64 = (sq + 63) / 64;
    p.n_q128 = (sq + 127) / 128;
    p.n_k128 = (sk + 127) / 128;
    p.sq128 = p.n_q128 * 128;
    p.sk128 = p.n_k128 * 128;
    long long off = 0;
    // Each section in turn: its pointer, then its rounded size.
    auto section = [&](long long size) {
      W* ptr = base == nullptr ? nullptr : base + off;
      off += round4(size);
      return ptr;
    };
    p.qsp = section(2ll * b * p.sq128);
    p.ksp = section(2ll * b * p.sk128);
    p.qsum = section(1ll * kSumWords * b * p.n_q64);
    p.ksum = section(1ll * kSumWords * b * p.n_k128);
    p.cls = section(1ll * b * p.n_q64 * p.n_k128);
    p.fwd_n = section(1ll * b * p.n_q128);
    p.fwd = section(1ll * b * p.n_q128 * p.n_k128);
    p.bwd_n = section(1ll * b * p.n_k128);
    p.bwd = section(2ll * b * p.n_k128 * p.n_q64);
    p.ivf = section(b);
    p.qiv = section(2ll * b * p.sq128);
    p.kiv = section(2ll * b * p.sk128);
    p.words = off;
    return p;
  }

  __device__ __forceinline__ const int2* q_rows(int bb) const {
    return reinterpret_cast<const int2*>(qsp) + (size_t)bb * sq128;
  }
  __device__ __forceinline__ const int2* k_rows(int bb) const {
    return reinterpret_cast<const int2*>(ksp) + (size_t)bb * sk128;
  }
  __device__ __forceinline__ bool interval_form(int bb) const {
    return ivf[bb] != 0;
  }
  // Per query row (q_rows) or key (k_rows): the interval form's bounds.
  __device__ __forceinline__ const int2* q_bounds(int bb) const {
    return reinterpret_cast<const int2*>(qiv) + (size_t)bb * sq128;
  }
  __device__ __forceinline__ const int2* k_bounds(int bb) const {
    return reinterpret_cast<const int2*>(kiv) + (size_t)bb * sk128;
  }
  // The class (TileClass) of query tile qt64 against key tile kt.
  __device__ __forceinline__ int tile_class(int bb, int qt64, int kt) const {
    return (int)(reinterpret_cast<const uint32_t*>(
                     cls)[((size_t)bb * n_q64 + qt64) * n_k128 + kt] &
                 3u);
  }
};
using SegPlan = SegPlanT<const int>;

// (segment id, position) of two consecutive rows or keys i, i + 1 (i even).
__device__ __forceinline__ int4 seg_pair(const int2* rows, int i) {
  return __ldg(reinterpret_cast<const int4*>(rows + i));
}

}  // namespace fattn
