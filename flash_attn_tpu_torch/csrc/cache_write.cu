// Paged KV-cache writes for Hopper (sm_90a). All update the cache in place.
//
// append_token replaces flash_attn_tpu/serving/cache.py:_append_kernel: one
// new token's K/V per sequence goes to slot length % page_size of page
// page_table[b, length / page_size]. A sequence with length < 0 is inactive
// and writes to slot 0 of the reserved scratch page 0 (cache.py:169-174).
// The TPU kernel read-modified-wrote the whole page, because Mosaic has no
// dynamic row store; here a warp per (sequence, kv head) copies the row in
// 16-byte vectors.
//
// append_span replaces cache.py:_append_span_kernel: up to sq tokens per
// sequence, token t of sequence b to slot lengths[b] + t for t <
// new_lens[b]. Inactive sequences (length < 0), padding rows and positions
// past the page table write nothing: unlike append_token nothing goes to
// page 0, so this kernel has no scratch-page race. The TPU launcher staged
// each chunk page-aligned and the kernel RMW'd whole pages by row select
// (Mosaic's workaround); here a warp per (token, kv head, sequence) copies
// its row in 16-byte vectors.
//
// Both read the new rows through strides and share store_new_row
// (cache_write.cuh) with the serving path's own form of these appends,
// which runs inside the paged attention launch that next reads the rows
// (K5 in paged_decode.cu, K6 in paged_chunk.cu): that form saves the
// launch, which is all these kernels cost (a few microseconds for 24-32 KB
// at serving sizes). The standalone kernels stay for callers of the
// public append_token / append_span.
//
// write_pages replaces cache.py:_write_pages_kernel: a prompt's K/V
// (prompt_len, h, d) is copied page by page to the given page ids, with the
// tail of the last page zero-filled. One launch writes a whole batch: row r
// of k/v (b, prompt_len, h, d) goes to the pages of page_table[r], as the
// JAX package's loop of write_prompt over the rows would (chunked and
// single-shot prefill write every row of a layer at once). The engine pads
// every page list with page 0, so one launch may write page 0 from several
// blocks at once; the TPU ran those writes in order, here they race. Page 0
// is scratch that is never read unmasked, so the race is harmless, and
// tests compare caches outside page 0.
//
// Bound: device-memory bytes, each source byte read once and each page
// byte written once. write_pages moves megabytes per launch (Llama-3-8B's
// chunk of 8 x 512 tokens: 33.6 MB), so it is built to reach the
// bandwidth: every thread moves 16-byte vectors, two of K and two of V in
// flight, with one index division per vector (not per element); the grid
// is (slab of a page, page x kv head, row), so a launch fills the card.
// Payloads are copied as raw bits, so every dtype whose rows are whole
// 16-byte vectors shares one kernel.
#include "cache_write.cuh"
#include "common.cuh"

namespace fattn {
namespace {

// Block (sequence, kv head): one warp copies the row.
__global__ void __launch_bounds__(32)
    append_token_kernel(const NewRows nr, uint4* k_pages, uint4* v_pages,
                        const int* page_table, const int* lengths,
                        int num_pages, int page_size, int pages_max) {
  const int bb = blockIdx.x, hk = blockIdx.y;
  const Slot at = token_slot(lengths[bb],
                             page_table + (size_t)bb * pages_max, pages_max,
                             page_size);
  store_new_row(nr, k_pages, v_pages, bb, 0, hk, num_pages, page_size, at,
                threadIdx.x, 32);
}

// Block (token, kv head, sequence): one warp copies the row, if it has a
// slot.
__global__ void __launch_bounds__(32)
    append_span_kernel(const NewRows nr, uint4* k_pages, uint4* v_pages,
                       const int* page_table, const int* lengths,
                       const int* new_lens, int num_pages, int page_size,
                       int pages_max) {
  const int t = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  const int len = lengths[bb];
  Slot at;
  if (len < 0 || t >= new_lens[bb] ||
      !span_slot(len + t, page_table + (size_t)bb * pages_max, pages_max,
                 page_size, &at)) {
    return;
  }
  store_new_row(nr, k_pages, v_pages, bb, t, hk, num_pages, page_size, at,
                threadIdx.x, 32);
}

constexpr int kWriteThreads = 256;
constexpr int kWriteUnroll = 2;  // vectors of K, and of V, per thread

// Block (slab, j + n_pages * hh, bb) copies vectors [slab * 512, slab * 512
// + 512) of page j of row bb, kv head hh: page row i / vecs, vector i % vecs.
// Source strides sb, st, sh (row, token, head) are in 16-byte vectors.
__global__ void __launch_bounds__(kWriteThreads)
    write_pages_kernel(const uint4* k, const uint4* v, uint4* k_pages,
                       uint4* v_pages, const int* page_table, long long sb,
                       long long st, long long sh, int len, int n_pages,
                       int num_pages, int page_size, int vecs) {
  const int per_page = page_size * vecs;  // vectors of one (page, head)
  const int j = blockIdx.y % n_pages, hh = blockIdx.y / n_pages;
  const int bb = blockIdx.z;
  const int page = page_table[(size_t)bb * n_pages + j];
  const size_t dst = ((size_t)hh * num_pages + page) * per_page;
  const size_t src = bb * sb + hh * sh;
  int idx[kWriteUnroll];
  uint4 kx[kWriteUnroll], vx[kWriteUnroll];
#pragma unroll
  for (int u = 0; u < kWriteUnroll; ++u) {
    idx[u] = (blockIdx.x * kWriteUnroll + u) * kWriteThreads + threadIdx.x;
    kx[u] = vx[u] = make_uint4(0u, 0u, 0u, 0u);  // past the prompt: zeros
    const int row = idx[u] / vecs;
    const int tok = j * page_size + row;
    if (idx[u] < per_page && tok < len) {
      const size_t at = src + tok * st + (idx[u] - row * vecs);
      kx[u] = k[at];
      vx[u] = v[at];
    }
  }
#pragma unroll
  for (int u = 0; u < kWriteUnroll; ++u) {
    if (idx[u] < per_page) {
      k_pages[dst + idx[u]] = kx[u];
      v_pages[dst + idx[u]] = vx[u];
    }
  }
}

}  // namespace
}  // namespace fattn

// new_k / new_v (b, sq, h, d) through element strides sb, st, sh (shared;
// d contiguous, whole 16-byte vectors) into the (h, num_pages, page_size,
// d) caches.
extern "C" int fattn_append_span(const void* new_k, const void* new_v,
                                 void* k_pages, void* v_pages,
                                 const void* page_table, const void* lengths,
                                 const void* new_lens, int b, int sq, int h,
                                 int num_pages, int page_size, int pages_max,
                                 int d, long long sb, long long st,
                                 long long sh, int elem_bytes, void* stream) {
  using namespace fattn;
  NewRows nr;
  if (b <= 0 || b > 65535 || sq <= 0 || h <= 0 || h > 65535 ||
      page_size <= 0 || pages_max <= 0 ||
      !make_new_rows(new_k, new_v, sb, st, sh, d, elem_bytes, &nr)) {
    return cudaErrorInvalidValue;
  }
  append_span_kernel<<<dim3(sq, h, b), 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      nr, static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<const int*>(new_lens), num_pages, page_size, pages_max);
  return cudaGetLastError();
}

// new_k / new_v (b, h, d) through element strides sb, sh (shared; d
// contiguous, whole 16-byte vectors).
extern "C" int fattn_append_token(const void* new_k, const void* new_v,
                                  void* k_pages, void* v_pages,
                                  const void* page_table, const void* lengths,
                                  int b, int h, int num_pages, int page_size,
                                  int pages_max, int d, long long sb,
                                  long long sh, int elem_bytes,
                                  void* stream) {
  using namespace fattn;
  NewRows nr;
  if (b <= 0 || h <= 0 || h > 65535 || page_size <= 0 || pages_max <= 0 ||
      !make_new_rows(new_k, new_v, sb, 0, sh, d, elem_bytes, &nr)) {
    return cudaErrorInvalidValue;
  }
  append_token_kernel<<<dim3(b, h), 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      nr, static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      num_pages, page_size, pages_max);
  return cudaGetLastError();
}

// Row r of k/v (b, len, h, d) into the n_pages pages page_table[r] of the
// (h, num_pages, page_size, d) caches. k and v share their element strides
// (sb, st, sh) of row, token and head; d is contiguous.
extern "C" int fattn_write_pages(const void* k, const void* v, void* k_pages,
                                 void* v_pages, const void* page_table, int b,
                                 int len, int n_pages, int h, int num_pages,
                                 int page_size, int d, long long sb,
                                 long long st, long long sh, int elem_bytes,
                                 void* stream) {
  using namespace fattn;
  const long long vec = 16 / (elem_bytes > 0 ? elem_bytes : 1);
  if (b <= 0 || len < 0 || n_pages <= 0 || h <= 0 || d <= 0 ||
      page_size <= 0 || elem_bytes <= 0 || 16 % elem_bytes != 0 ||
      d % vec != 0 || sb % vec != 0 || st % vec != 0 || sh % vec != 0 ||
      len > n_pages * page_size || (long long)n_pages * h > 65535 ||
      b > 65535) {
    return cudaErrorInvalidValue;
  }
  const int vecs = (int)(d / vec);
  const int per_block = kWriteThreads * kWriteUnroll;
  const dim3 grid((page_size * vecs + per_block - 1) / per_block, n_pages * h,
                  b);
  write_pages_kernel<<<grid, kWriteThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const int*>(page_table), sb / vec, st / vec, sh / vec, len,
      n_pages, num_pages, page_size, vecs);
  return cudaGetLastError();
}

extern "C" const char* fattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
