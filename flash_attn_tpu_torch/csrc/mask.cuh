// Dense-attention visibility, shared by the forward and backward kernels.
//
// Counterpart of the masking algebra that flash_attn_tpu/kernels/common.py
// shares between the Pallas forward and backward (block_mask_predicates,
// window_band_mask, attention_mask): one definition, so the two cannot
// diverge. Causal masking is top-left aligned (key j is visible from query i
// iff j <= i), also when sq != sk, as in the JAX package; keys past sk are
// never visible.
//
// The band (M4; ops/attention.py:76 _parse_window there): with a window
// (left L, right R; -1 = unbounded) key j is visible from query i iff
// i - L <= j <= i + R, global indices in the dense form and per-segment
// positions in the segment form; with sinks (dense only, and only with a
// band) the first `sinks` key columns are visible from every row as well.
// The walks below visit the band's tiles and the sink tiles only, so a
// band-dead tile is never loaded.
#pragma once

#include <cuda_runtime.h>

namespace fattn {

// The window band, logit softcap and ALiBi of one call (host-filled).
struct Band {
  int left = -1, right = -1;  // -1: unbounded
  int sinks = 0;              // leading key columns always visible
  // Softcap on the scaled score u = scale * s: cap * tanh(u / cap). The
  // kernels carry s before the scale, so s' = cap_out * tanh(cap_in * s)
  // with cap_in = scale / cap, cap_out = cap / scale (flash_fwd.py:241-251
  // there). cap_in == 0: no softcap.
  float cap_in = 0.f, cap_out = 0.f;
  // (b, h) fp32 ALiBi slopes divided by the softmax scale, or nullptr.
  const float* alibi = nullptr;

  __host__ __device__ bool windowed() const {
    return left >= 0 || right >= 0;
  }
  __host__ __device__ bool logits() const {
    return cap_in != 0.f || alibi != nullptr;
  }
};

// Fills a Band from an entry point's arguments; false for values the
// kernels refuse (sinks need a band and the dense form).
inline bool make_band(Band* bd, int left, int right, int sinks, float softcap,
                      float scale, const void* alibi, bool segments) {
  if (left < -1 || right < -1 || sinks < 0 || !(softcap >= 0.f) ||
      (sinks > 0 && (segments || (left < 0 && right < 0)))) {
    return false;
  }
  bd->left = left;
  bd->right = right;
  bd->sinks = sinks;
  if (softcap > 0.f) {
    bd->cap_in = scale / softcap;
    bd->cap_out = softcap / scale;
  }
  bd->alibi = static_cast<const float*>(alibi);
  return true;
}

// Inside the band (or a sink column), by global indices or positions.
__device__ __forceinline__ bool band_visible(int row, int col,
                                             const Band& bd) {
  return ((bd.left < 0 || col >= row - bd.left) &&
          (bd.right < 0 || col <= row + bd.right)) ||
         col < bd.sinks;
}

__device__ __forceinline__ bool key_visible(int row, int col, int sk,
                                            bool causal) {
  return col < sk && (!causal || col <= row);
}

__device__ __forceinline__ bool key_visible(int row, int col, int sk,
                                            bool causal, const Band& bd) {
  return col < sk && (!causal || col <= row) && band_visible(row, col, bd);
}

// Segment form (flash_fwd.py:314-333 and flash_bwd.py:75-84 there): key k
// is visible from query q iff both carry the same non-negative segment id
// and, under causal masking, the query's position is not before the key's,
// and the key's position lies in the query's band. x is the segment id, y
// the position (per segment, so causal is top-left inside each segment);
// rows and keys out of bounds carry id -1. K1 and K2 walk only the tiles
// their plan calls live (csrc/segments.cuh).
__device__ __forceinline__ bool seg_visible(int2 q, int2 k, bool causal,
                                            const Band& bd) {
  return q.x >= 0 && q.x == k.x && (!causal || q.y >= k.y) &&
         (bd.left < 0 || k.y >= q.y - bd.left) &&
         (bd.right < 0 || k.y <= q.y + bd.right);
}

// The score of query row `row` and key `col` after the softcap and the
// ALiBi bias, before the scale (flash_fwd.py:241-284 there): the distance
// is col - row under causal masking and -|row - col| otherwise (global
// indices, or positions in the segment form). `slope` is this head's slope
// over the scale.
__device__ __forceinline__ float band_logit(float s, int row, int col,
                                            bool causal, const Band& bd,
                                            float slope) {
  if (bd.cap_in != 0.f) s = bd.cap_out * tanhf(s * bd.cap_in);
  if (bd.alibi != nullptr) {
    const int dist = causal ? col - row : -abs(row - col);
    s += slope * (float)dist;
  }
  return s;
}

// The tiles of `tile` keys that query rows [q0, q0 + rows) walk: the sink
// tiles (those holding a key below `sinks`), then the band's tiles up to
// the causal or right-band bound. Key tile of step j: tile(j).
struct TileWalk {
  int first;   // the band's first tile
  int n_sink;  // sink tiles walked before it (0 when they overlap it)
  int n;       // steps
  __device__ __forceinline__ int tile(int j) const {
    return j < n_sink ? j : first + j - n_sink;
  }
};

__device__ __forceinline__ TileWalk key_walk(int q0, int rows, int tile,
                                             int sk, bool causal,
                                             const Band& bd) {
  const int hi_c = causal ? min(sk, q0 + rows) : sk;  // sk's and causal
  const int hi =
      bd.right >= 0 ? min(hi_c, q0 + rows + bd.right) : hi_c;  // the band's
  const int lo = bd.left >= 0 ? max(0, q0 - bd.left) : 0;
  int last = hi > 0 ? (hi + tile - 1) / tile : 0;  // past the band's last
  int first = min(lo / tile, last);
  // Sink columns are visible past either band edge (band | sinks).
  int n_sink = bd.sinks > 0 ? (min(bd.sinks, hi_c) + tile - 1) / tile : 0;
  if (n_sink >= first) {  // the sink tiles reach the band: one run from 0
    last = max(last, n_sink);
    first = 0;
    n_sink = 0;
  }
  return TileWalk{first, n_sink, n_sink + last - first};
}

// Whether a (rows [r0, r1], keys [c0, c1]) tile crosses a mask edge (sk's,
// the causal diagonal, a band edge or the sink boundary) and must test
// elements (common.py block_mask_predicates there: needs_mask).
__device__ __forceinline__ bool tile_masked(int r0, int r1, int c0, int c1,
                                            int sk, bool causal,
                                            const Band& bd) {
  if (c1 >= sk || (causal && c1 > r0)) return true;
  const bool in_band = (bd.left < 0 || c0 >= r1 - bd.left) &&
                       (bd.right < 0 || c1 <= r0 + bd.right);
  return !in_band && c1 >= bd.sinks;
}

// Query rows [x, y) that see some key of [n0, n0 + keys): where the
// backward's walk over query tiles runs for that key tile.
__device__ __forceinline__ int2 rows_for_keys(int n0, int keys, int sq,
                                              bool causal, const Band& bd) {
  int lo = causal ? n0 : 0;
  int hi = sq;
  if (n0 >= bd.sinks) {  // not a sink tile: the band bounds its rows
    if (bd.right >= 0) lo = max(lo, n0 - bd.right);
    if (bd.left >= 0) hi = min(hi, n0 + keys + bd.left);
  }
  return make_int2(lo, hi);
}

// The query tiles of `rows` rows that key tile kt (of `keys` keys) walks:
// [x, y) (empty when no row sees it).
__device__ __forceinline__ int2 row_tiles_for_keys(int kt, int keys, int rows,
                                                   int sq, bool causal,
                                                   const Band& bd) {
  const int2 r = rows_for_keys(kt * keys, keys, sq, causal, bd);
  const int x = r.x / rows;
  return make_int2(x, r.y > r.x ? (r.y + rows - 1) / rows : x);
}

// Deterministic dQ (csrc/flash_bwd.cu): the rank of key tile kt among the
// key tiles that walk query tile mt, in launch order (last_first: the last
// key tile launches first). nk key tiles in all. Over the tiles past the
// sink tiles a query tile's walkers are one run of key tiles (both ends of
// a walk rise with kt), and the sink tiles that reach it are a run from 0,
// so each run is found by bisection on the walk's own bounds.
__device__ __forceinline__ int dq_rank(int kt, int mt, int nk, int keys,
                                       int rows, int sq, bool causal,
                                       bool last_first, const Band& bd) {
  const int n_sink = min(nk, (bd.sinks + keys - 1) / keys);
  // The first tile in [lo, hi) whose walk is empty or, by `end`, ends past
  // mt, or else starts past mt (empty walks come last).
  auto first_past = [&](int lo, int hi, bool end) {
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      const int2 w = row_tiles_for_keys(mid, keys, rows, sq, causal, bd);
      if (w.y <= w.x || (end ? w.y > mt : w.x > mt)) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    return lo;
  };
  // Runs [0, a) (sink tiles) and [b, c) (the rest).
  const int a = first_past(0, n_sink, false);
  const int b = first_past(n_sink, nk, true);
  int c = b;
  if (b < nk) {
    const int2 w = row_tiles_for_keys(b, keys, rows, sq, causal, bd);
    if (w.y > w.x) c = first_past(b, nk, false);
  }
  auto before = [&](int x, int y) {  // walkers in [x, y) launched earlier
    return last_first ? max(0, y - max(x, kt + 1)) : max(0, min(y, kt) - x);
  };
  return before(0, a) + before(b, c);
}

}  // namespace fattn
