// The cache appends' device side, shared by the standalone appends (K7a
// append_token and K7b append_span in cache_write.cu) and by the paged
// attention kernels that append inside their own launch (K5
// paged_decode.cu for decode, K6 paged_chunk.cu for verification).
//
// The new rows: token t of sequence b, kv head h starts at vector
// b * sb + t * st + h * sh of new_k (and of new_v, which shares the
// strides), in 16-byte vectors; the head dimension is contiguous. So the
// models hand over views of their projections, with no copy. A row is
// copied as raw bits, 16 bytes at a time: one routine for every dtype.
//
// Where a row goes (the JAX package's serving/cache.py semantics):
//   - K7a (token_slot): slot len % page_size of page page_table[b, len /
//     page_size], len the length before the append. An inactive slot (len <
//     0), or a position past the page table, goes to slot 0 of the
//     reserved scratch page 0. Several sequences may write it at once: page
//     0 is never read unmasked by an active sequence, so the race is
//     harmless.
//   - K7b (span_slot): token t at position len + t for t < new_lens[b].
//     Inactive sequences, padding rows and positions past the table write
//     nothing.
#pragma once

#include "common.cuh"

namespace fattn {

struct NewRows {
  const uint4* k;  // nullptr: no append
  const uint4* v;
  long long sb, st, sh;  // strides of batch, token and head, in vectors
  int vecs;              // 16-byte vectors of one row
};

struct Slot {
  int page, slot;
};

__device__ __forceinline__ Slot token_slot(int len, const int* tbl,
                                           int pages_max, int page_size) {
  if (len < 0 || len / page_size >= pages_max) return Slot{0, 0};
  return Slot{tbl[len / page_size], len % page_size};
}

// Position pos of a sequence's table: false (write nothing) past it.
__device__ __forceinline__ bool span_slot(int pos, const int* tbl,
                                          int pages_max, int page_size,
                                          Slot* at) {
  if (pos / page_size >= pages_max) return false;
  *at = Slot{tbl[pos / page_size], pos % page_size};
  return true;
}

// Threads lane, lane + n_lanes, ... of a group of n_lanes copy the K and V
// row (token t of sequence bb, kv head hk) to `at`: item i < vecs is K's
// vector i, the others V's. Caches (h_kv, num_pages, page_size, vecs).
__device__ __forceinline__ void store_new_row(const NewRows& nr,
                                              uint4* k_pages, uint4* v_pages,
                                              int bb, int t, int hk,
                                              int num_pages, int page_size,
                                              Slot at, int lane,
                                              int n_lanes) {
  const long long src = bb * nr.sb + t * nr.st + hk * nr.sh;
  const size_t dst =
      (((size_t)hk * num_pages + at.page) * page_size + at.slot) * nr.vecs;
  for (int i = lane; i < 2 * nr.vecs; i += n_lanes) {
    if (i < nr.vecs) {
      k_pages[dst + i] = nr.k[src + i];
    } else {
      v_pages[dst + i - nr.vecs] = nr.v[src + i - nr.vecs];
    }
  }
}

// The host side: the rows at new_k / new_v with element strides sb, st, sh
// and head dim d; false where they are not whole 16-byte vectors.
inline bool make_new_rows(const void* new_k, const void* new_v, long long sb,
                          long long st, long long sh, int d, int elem_bytes,
                          NewRows* nr) {
  if (elem_bytes <= 0 || 16 % elem_bytes != 0) return false;
  const long long vec = 16 / elem_bytes;
  if (d <= 0 || d % vec || sb % vec || st % vec || sh % vec ||
      reinterpret_cast<uintptr_t>(new_k) % 16 ||
      reinterpret_cast<uintptr_t>(new_v) % 16) {
    return false;
  }
  *nr = NewRows{static_cast<const uint4*>(new_k),
                static_cast<const uint4*>(new_v),
                sb / vec,
                st / vec,
                sh / vec,
                static_cast<int>(d / vec)};
  return true;
}

}  // namespace fattn
