// The tile plan of K1's and K2's segment form (csrc/segments.cuh): one
// launch before the attention kernels, one block per batch row.
//
// Counterpart of flash_attn_tpu/kernels/common.py:205
// classify_segment_block, which the Pallas kernels evaluate per grid step
// after the step's K/V tile has been fetched. Here the classes are known
// before any tile is loaded, and turned into the lists the kernels walk.
// The block runs four phases, each over all of its row's tiles and
// separated by barriers (global writes of a block are visible to its
// threads after __syncthreads):
//   1. the (segment id, position) pairs of every query row and key, with
//      id -1 past sq / sk, padded to whole 128-row tiles, and whether the
//      row is in interval form (csrc/segments.cuh); if it is, each query
//      row's key interval and each key's query interval, by binary search
//      over the other side's sorted valid prefix;
//   2. per-tile summaries: (min, max) of segment id and position over the
//      valid rows, and whether the tile is pure (every row valid, one id);
//   3. per (64-row query tile, 128-key tile) pair its class, and for the
//      live pairs the dQ rank: how many key tiles launched before this one
//      by K2 (last first) are live on the query tile;
//   4. per 128-row query tile the list of its live key tiles (K1), and per
//      key tile the list of its live 64-row query tiles with their ranks
//      (K2).
// Work per block is O(n_q64 x n_k128) small integer comparisons.
#include <climits>

#include "common.cuh"
#include "segments.cuh"

namespace fattn {
namespace {

constexpr int kPlanThreads = 512;

struct TileSum {
  int seg_min, seg_max, pos_min, pos_max, pure;
};

__device__ TileSum summarize(const int2* rows, int n) {
  TileSum s{INT_MAX, INT_MIN, INT_MAX, INT_MIN, 1};
  for (int i = 0; i < n; ++i) {
    const int2 r = rows[i];
    if (r.x < 0) {
      s.pure = 0;
      continue;
    }
    s.seg_min = min(s.seg_min, r.x);
    s.seg_max = max(s.seg_max, r.x);
    s.pos_min = min(s.pos_min, r.y);
    s.pos_max = max(s.pos_max, r.y);
  }
  if (s.seg_min != s.seg_max) s.pure = 0;
  return s;
}

// One token of the interval form's test: a valid token follows a valid
// one, and either continues its run (position + 1) or starts the next run
// (a higher id, position 0).
__device__ bool in_interval_form(const int* seg, const int* pos, int i) {
  const int s = seg[i], p = pos[i];
  if (s < 0) return true;
  if (i == 0) return p == 0;
  const int s0 = seg[i - 1];
  if (s0 < 0) return false;
  return s0 == s ? p == pos[i - 1] + 1 : (s > s0 && p == 0);
}

// [first, end) of the run with segment id s in rows[0, n), sorted by id.
__device__ int2 run_of(const int2* rows, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {  // first id >= s
    const int mid = (lo + hi) / 2;
    if (rows[mid].x < s) lo = mid + 1; else hi = mid;
  }
  int end = lo;
  hi = n;
  while (end < hi) {  // first id > s
    const int mid = (end + hi) / 2;
    if (rows[mid].x <= s) end = mid + 1; else hi = mid;
  }
  return make_int2(lo, end);
}

__device__ TileSum load_sum(const int* w) {
  return TileSum{w[0], w[1], w[2], w[3], w[4]};
}

// common.py:205 classify_segment_block over tile summaries: dead when the
// id ranges do not meet or, under causal masking, every query position is
// before every key position, or every key position lies outside every
// query's band (left L, right R; -1 unbounded); full when both tiles are
// pure in one id and, under causal masking, every query position is at or
// after every key position, and every key position lies inside every
// query's band.
__device__ int classify(const TileSum& q, const TileSum& k, bool causal,
                        int left, int right) {
  if (q.seg_min > q.seg_max || k.seg_min > k.seg_max) return kTileDead;
  if (q.seg_max < k.seg_min || k.seg_max < q.seg_min) return kTileDead;
  if (causal && q.pos_max < k.pos_min) return kTileDead;
  if (left >= 0 && k.pos_max < q.pos_min - left) return kTileDead;
  if (right >= 0 && k.pos_min > q.pos_max + right) return kTileDead;
  if (q.pure && k.pure && q.seg_min == k.seg_min &&
      (!causal || q.pos_min >= k.pos_max) &&
      (left < 0 || k.pos_min >= q.pos_max - left) &&
      (right < 0 || k.pos_max <= q.pos_min + right)) {
    return kTileFull;
  }
  return kTilePartial;
}

__global__ void __launch_bounds__(kPlanThreads)
    seg_plan_kernel(const int* q_seg, const int* kv_seg, const int* q_pos,
                    const int* kv_pos, int* plan, int sq, int sk,
                    bool causal, int left, int right) {
  const int bb = blockIdx.x;
  const SegPlanT<int> pl = SegPlanT<int>::at(plan, gridDim.x, sq, sk);
  const int nq = pl.n_q64, nk = pl.n_k128;
  int2* qsp = reinterpret_cast<int2*>(pl.qsp) + (size_t)bb * pl.sq128;
  int2* ksp = reinterpret_cast<int2*>(pl.ksp) + (size_t)bb * pl.sk128;
  __shared__ int valid_q, valid_k;
  if (threadIdx.x == 0) valid_q = valid_k = 0;
  __syncthreads();
  q_seg += (size_t)bb * sq;
  q_pos += (size_t)bb * sq;
  kv_seg += (size_t)bb * sk;
  kv_pos += (size_t)bb * sk;
  bool form = true;
  int nvq = 0, nvk = 0;
  for (int i = threadIdx.x; i < pl.sq128; i += blockDim.x) {
    qsp[i] = i < sq ? make_int2(q_seg[i], q_pos[i]) : make_int2(-1, 0);
    if (i < sq) {
      form = form && in_interval_form(q_seg, q_pos, i);
      nvq += q_seg[i] >= 0;
    }
  }
  for (int i = threadIdx.x; i < pl.sk128; i += blockDim.x) {
    ksp[i] = i < sk ? make_int2(kv_seg[i], kv_pos[i]) : make_int2(-1, 0);
    if (i < sk) {
      form = form && in_interval_form(kv_seg, kv_pos, i);
      nvk += kv_seg[i] >= 0;
    }
  }
  atomicAdd(&valid_q, nvq);
  atomicAdd(&valid_k, nvk);
  form = __syncthreads_and(form);
  // The interval form: a query's keys [lo, hi) (causal: up to the run's
  // start + its position); a key's queries [lo, hi) (causal: from the
  // run's start + its position); a band cuts both to the positions in it
  // (positions are indices from the run's start). The valid tokens are a
  // sorted prefix, so
  // a run is found by binary search; each thread takes a contiguous span
  // of tokens and searches once per id it meets.
  int2* qiv = reinterpret_cast<int2*>(pl.qiv) + (size_t)bb * pl.sq128;
  int2* kiv = reinterpret_cast<int2*>(pl.kiv) + (size_t)bb * pl.sk128;
  const int n_tok = pl.sq128 + pl.sk128;
  const int span = (n_tok + blockDim.x - 1) / blockDim.x;
  int last_id = -1;
  int2 run = make_int2(0, 0);
  for (int i = threadIdx.x * span; i < min(n_tok, (threadIdx.x + 1) * span);
       ++i) {
    const bool is_q = i < pl.sq128;
    const int2 r = is_q ? qsp[i] : ksp[i - pl.sq128];
    int2 iv = make_int2(0, 0);
    if (form && r.x >= 0) {
      if (r.x != last_id || i == pl.sq128) {
        run = is_q ? run_of(ksp, valid_k, r.x) : run_of(qsp, valid_q, r.x);
        last_id = r.x;
      }
      iv = run;
      const int start = run.x;
      if (causal && is_q) iv.y = min(iv.y, start + r.y + 1);
      if (causal && !is_q) iv.x += r.y;
      // A query at position y sees key positions [y - L, y + R]; a key at
      // y is seen from query positions [y - R, y + L].
      const int below = is_q ? left : right, above = is_q ? right : left;
      if (below >= 0) iv.x = max(iv.x, start + r.y - below);
      if (above >= 0) iv.y = min(iv.y, start + r.y + above + 1);
      if (iv.y <= iv.x) iv = make_int2(0, 0);
    }
    (is_q ? qiv[i] : kiv[i - pl.sq128]) = iv;
  }
  if (threadIdx.x == 0) pl.ivf[bb] = form;
  __syncthreads();

  int* qsum = pl.qsum + (size_t)bb * nq * kSumWords;
  int* ksum = pl.ksum + (size_t)bb * nk * kSumWords;
  for (int t = threadIdx.x; t < nq + nk; t += blockDim.x) {
    const bool is_q = t < nq;
    const TileSum s = is_q ? summarize(qsp + 64 * t, 64)
                           : summarize(ksp + 128 * (t - nq), 128);
    int* w = is_q ? qsum + t * kSumWords : ksum + (t - nq) * kSumWords;
    w[0] = s.seg_min;
    w[1] = s.seg_max;
    w[2] = s.pos_min;
    w[3] = s.pos_max;
    w[4] = s.pure;
    w[5] = w[6] = w[7] = 0;
  }
  __syncthreads();

  uint32_t* cls =
      reinterpret_cast<uint32_t*>(pl.cls) + (size_t)bb * nq * nk;
  for (int qt = threadIdx.x; qt < nq; qt += blockDim.x) {
    const TileSum qs = load_sum(qsum + qt * kSumWords);
    uint32_t rank = 0;
    for (int x = 0; x < nk; ++x) {  // K2's launch order: last tile first
      const int kt = nk - 1 - x;
      const int c = classify(qs, load_sum(ksum + kt * kSumWords), causal,
                             left, right);
      cls[qt * nk + kt] = (uint32_t)c | (rank << 2);
      rank += c != kTileDead;
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < pl.n_q128 + nk; t += blockDim.x) {
    if (t < pl.n_q128) {  // K1: the key tiles of 128 query rows
      uint32_t* list = reinterpret_cast<uint32_t*>(pl.fwd) +
                       ((size_t)bb * pl.n_q128 + t) * nk;
      int n = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const uint32_t c0 = cls[(2 * t) * nk + kt] & 3u;
        const uint32_t c1 = 2 * t + 1 < nq ? cls[(2 * t + 1) * nk + kt] & 3u
                                           : (uint32_t)kTileDead;
        if (c0 != kTileDead || c1 != kTileDead) {
          list[n++] = (uint32_t)kt | (c0 << 28) | (c1 << 30);
        }
      }
      pl.fwd_n[(size_t)bb * pl.n_q128 + t] = n;
    } else {  // K2: the query tiles of one key tile, with their ranks
      const int kt = t - pl.n_q128;
      int2* list = reinterpret_cast<int2*>(pl.bwd) +
                   ((size_t)bb * nk + kt) * nq;
      int n = 0;
      for (int qt = 0; qt < nq; ++qt) {
        const uint32_t e = cls[qt * nk + kt];
        if ((e & 3u) != kTileDead) {
          list[n++] = make_int2(qt | (int)((e & 3u) << 30), (int)(e >> 2));
        }
      }
      pl.bwd_n[(size_t)bb * nk + kt] = n;
    }
  }
}

}  // namespace
}  // namespace fattn

// Words (int32) of the plan buffer for b rows of sq queries and sk keys.
extern "C" long long fattn_seg_plan_words(int b, int sq, int sk) {
  return fattn::SegPlanT<int>::at(nullptr, b, sq, sk).words;
}

// q_seg, q_pos (b, sq) and kv_seg, kv_pos (b, sk): int32 contiguous; plan:
// fattn_seg_plan_words(b, sq, sk) int32 words, 16-byte aligned;
// window_left / window_right: the band by positions, -1 unbounded.
extern "C" int fattn_seg_plan(const void* q_seg, const void* kv_seg,
                              const void* q_pos, const void* kv_pos,
                              void* plan, int b, int sq, int sk, int causal,
                              int window_left, int window_right,
                              void* stream) {
  using namespace fattn;
  if (b <= 0 || sq <= 0 || sk <= 0 || window_left < -1 || window_right < -1) {
    return cudaErrorInvalidValue;
  }
  seg_plan_kernel<<<b, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
      static_cast<int*>(plan), sq, sk, causal != 0, window_left,
      window_right);
  return cudaGetLastError();
}
