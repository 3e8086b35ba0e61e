// Paged KV-cache writes for Hopper (sm_90a). Both update the cache in place.
//
// append_token replaces flash_attn_tpu/serving/cache.py:_append_kernel: one
// new token's K/V per sequence goes to slot length % page_size of page
// page_table[b, length / page_size]. A sequence with length < 0 is inactive
// and writes to slot 0 of the reserved scratch page 0 (cache.py:169-174).
// The TPU kernel read-modified-wrote the whole page, because Mosaic has no
// dynamic row store; here each thread stores its elements directly.
//
// append_span replaces cache.py:_append_span_kernel: up to sq tokens per
// sequence, token t of sequence b to slot lengths[b] + t for t <
// new_lens[b]. Inactive sequences (length < 0), padding rows and positions
// past the page table write nothing: unlike append_token nothing goes to
// page 0, so this kernel has no scratch-page race. The TPU launcher staged
// each chunk page-aligned and the kernel RMW'd whole pages by row select
// (Mosaic's workaround); here each thread stores one 16-byte vector.
//
// write_pages replaces cache.py:_write_pages_kernel: a prompt's K/V
// (prompt_len, h, d) is copied page by page to the given page ids, with the
// tail of the last page zero-filled. The engine pads every page list with
// page 0, so one launch may write page 0 from several blocks at once; the
// TPU ran those writes in order, here they race. Page 0 is scratch that is
// never read unmasked, so the race is harmless, and tests compare caches
// outside page 0.
//
// Bound: device-memory bytes written (and read from the source). Both are a
// few microseconds at serving sizes; the copy is elementwise with
// consecutive threads on consecutive addresses. Payloads are copied as raw
// bits (2- or 4-byte units), so every dtype of that width shares one kernel.
#include "common.cuh"

namespace fattn {
namespace {

template <typename U>
__global__ void append_token_kernel(const U* new_k, const U* new_v,
                                    U* k_pages, U* v_pages,
                                    const int* page_table, const int* lengths,
                                    int h, int num_pages, int page_size,
                                    int pages_max, int d) {
  const int bb = blockIdx.x;
  const int len = lengths[bb];
  int page = 0, slot = 0;
  if (len >= 0 && len / page_size < pages_max) {
    page = page_table[(size_t)bb * pages_max + len / page_size];
    slot = len % page_size;
  }
  for (int i = threadIdx.x; i < h * d; i += blockDim.x) {
    const int hh = i / d, dd = i % d;
    const size_t dst =
        (((size_t)hh * num_pages + page) * page_size + slot) * d + dd;
    k_pages[dst] = new_k[(size_t)bb * h * d + i];
    v_pages[dst] = new_v[(size_t)bb * h * d + i];
  }
}

template <typename U>
__global__ void write_pages_kernel(const U* k, const U* v, U* k_pages,
                                   U* v_pages, const int* page_ids,
                                   int prompt_len, int h, int num_pages,
                                   int page_size, int d) {
  const int j = blockIdx.x, hh = blockIdx.y;
  const size_t base =
      ((size_t)hh * num_pages + page_ids[j]) * page_size * d;
  for (int i = threadIdx.x; i < page_size * d; i += blockDim.x) {
    const int tok = j * page_size + i / d;
    U kv = U(0), vv = U(0);
    if (tok < prompt_len) {
      const size_t src = ((size_t)tok * h + hh) * d + i % d;
      kv = k[src];
      vv = v[src];
    }
    k_pages[base + i] = kv;
    v_pages[base + i] = vv;
  }
}

// One thread per 16-byte vector of (sequence, chunk row, kv head): it finds
// its slot and page itself and stores directly.
__global__ void append_span_kernel(const uint4* new_k, const uint4* new_v,
                                   uint4* k_pages, uint4* v_pages,
                                   const int* page_table, const int* lengths,
                                   const int* new_lens, int b, int sq, int h,
                                   int num_pages, int page_size,
                                   int pages_max, int vecs) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)b * sq * h * vecs) return;
  const int vec = i % vecs;
  const int hh = (i / vecs) % h;
  const int t = (i / ((size_t)vecs * h)) % sq;
  const int bb = i / ((size_t)vecs * h * sq);
  const int len = lengths[bb];
  if (len < 0 || t >= new_lens[bb]) return;  // inactive or padding: nothing
  const int pos = len + t;
  if (pos / page_size >= pages_max) return;  // past the table: nothing
  const int page = page_table[(size_t)bb * pages_max + pos / page_size];
  const size_t dst =
      (((size_t)hh * num_pages + page) * page_size + pos % page_size) * vecs +
      vec;
  k_pages[dst] = new_k[i];
  v_pages[dst] = new_v[i];
}

}  // namespace
}  // namespace fattn

extern "C" int fattn_append_span(const void* new_k, const void* new_v,
                                 void* k_pages, void* v_pages,
                                 const void* page_table, const void* lengths,
                                 const void* new_lens, int b, int sq, int h,
                                 int num_pages, int page_size, int pages_max,
                                 int d, int elem_bytes, void* stream) {
  using namespace fattn;
  if (b <= 0 || sq <= 0 || h <= 0 || d <= 0 || page_size <= 0 ||
      pages_max <= 0 || elem_bytes <= 0 || (d * elem_bytes) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int vecs = d * elem_bytes / 16;
  const size_t n = (size_t)b * sq * h * vecs;
  const int threads = 256;
  append_span_kernel<<<(n + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(new_k), static_cast<const uint4*>(new_v),
      static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<const int*>(new_lens), b, sq, h, num_pages, page_size,
      pages_max, vecs);
  return cudaGetLastError();
}

extern "C" int fattn_append_token(const void* new_k, const void* new_v,
                                  void* k_pages, void* v_pages,
                                  const void* page_table, const void* lengths,
                                  int b, int h, int num_pages, int page_size,
                                  int pages_max, int d, int elem_bytes,
                                  void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || d <= 0 || page_size <= 0 || pages_max <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  if (elem_bytes == 2) {
    append_token_kernel<uint16_t><<<b, 256, 0, st>>>(
        static_cast<const uint16_t*>(new_k), static_cast<const uint16_t*>(new_v),
        static_cast<uint16_t*>(k_pages), static_cast<uint16_t*>(v_pages), tbl,
        lens, h, num_pages, page_size, pages_max, d);
  } else if (elem_bytes == 4) {
    append_token_kernel<uint32_t><<<b, 256, 0, st>>>(
        static_cast<const uint32_t*>(new_k), static_cast<const uint32_t*>(new_v),
        static_cast<uint32_t*>(k_pages), static_cast<uint32_t*>(v_pages), tbl,
        lens, h, num_pages, page_size, pages_max, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int fattn_write_pages(const void* k, const void* v, void* k_pages,
                                 void* v_pages, const void* page_ids,
                                 int prompt_len, int n_pages, int h,
                                 int num_pages, int page_size, int d,
                                 int elem_bytes, void* stream) {
  using namespace fattn;
  if (n_pages <= 0 || h <= 0 || d <= 0 || page_size <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(page_ids);
  const dim3 grid(n_pages, h);
  if (elem_bytes == 2) {
    write_pages_kernel<uint16_t><<<grid, 256, 0, st>>>(
        static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
        static_cast<uint16_t*>(k_pages), static_cast<uint16_t*>(v_pages), ids,
        prompt_len, h, num_pages, page_size, d);
  } else if (elem_bytes == 4) {
    write_pages_kernel<uint32_t><<<grid, 256, 0, st>>>(
        static_cast<const uint32_t*>(k), static_cast<const uint32_t*>(v),
        static_cast<uint32_t*>(k_pages), static_cast<uint32_t*>(v_pages), ids,
        prompt_len, h, num_pages, page_size, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* fattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
