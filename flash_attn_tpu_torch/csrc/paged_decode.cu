// Paged decode attention for Hopper (sm_90a).
//
// Replaces both TPU routes of one computation:
// flash_attn_tpu/kernels/decode.py:_decode_kernel (BlockSpec pipeline, taken
// for head_dim 64) and :_decode_dma_kernel (manual DMA, taken when head_dim
// % 128 == 0). One query token per sequence attends to its keys, which lie
// in pages scattered over the cache and are found through the page table.
// The visibility predicates are csrc/paged.cuh, shared with K6.
//
// Layout: q (b, h_kv, group, d); k_pages and v_pages (h_kv, num_pages,
// page_size, d); lengths (b,) int32; page_table (b, pages_max) int32;
// out (b, h_kv, group, d). The query sits at position length - 1, so every
// key below length is visible; a sequence with length <= 0 gives out = 0
// (decode.py:168, l == 0).
//
// Grid: one block per (kv head, sequence), serving all `group` query rows
// of that kv head, so each K/V row is read once for the whole group. The
// block walks the keys in tiles of 64: warps score keys (a warp reads one
// K row coalesced and reduces the dot by shuffles), then update the fp32
// online-softmax state of each row, then every thread folds P @ V into the
// (row, dim) accumulators it owns, reading V rows coalesced.
// Bound: device-memory bytes of the live pages. With one block per
// (sequence, kv head) a small batch fills few SMs; splitting the keys over
// several blocks with a combine step is the later performance work.
#include "common.cuh"
#include "paged.cuh"

namespace fattn {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;
constexpr int kMaxGroup = 16;

struct DecodeParams {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_table;
  void* out;
  int h_kv, group, num_pages, page_size, pages_max;
  float scale_log2;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const DecodeParams p) {
  constexpr int kAcc = kMaxGroup * D / kThreads;
  __shared__ float q_s[kMaxGroup * D];
  __shared__ float s_s[kMaxGroup * kTile];
  __shared__ size_t row_s[kTile];  // element offset of each tile key's row
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int hk = blockIdx.x, bb = blockIdx.y;
  const int G = p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ps = p.page_size;
  // The query sits at position lengths[bb] - 1: every cached key is
  // visible, so the key walk's bound is the whole visibility test.
  const int length = paged_live_keys(
      paged_length(p.lengths[bb], p.pages_max, ps), p.lengths[bb] - 1);

  const T* q = static_cast<const T*>(p.q) + (size_t)(bb * p.h_kv + hk) * G * D;
  const T* kh =
      static_cast<const T*>(p.k_pages) + (size_t)hk * p.num_pages * ps * D;
  const T* vh =
      static_cast<const T*>(p.v_pages) + (size_t)hk * p.num_pages * ps * D;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(q[i]) * p.scale_log2;  // scores come out in log2 units
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < length; k0 += kTile) {
    const int n = min(kTile, length - k0);
    if (tid < n) {
      const int pos = k0 + tid;
      row_s[tid] = ((size_t)tbl[pos / ps] * ps + pos % ps) * D;
    }
    __syncthreads();

    for (int j = warp; j < n; j += kThreads / 32) {
      const T* kr = kh + row_s[j];
      float kv[D / 32];
#pragma unroll
      for (int i = 0; i < D / 32; ++i) kv[i] = to_float(kr[lane + 32 * i]);
      for (int r = 0; r < G; ++r) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) a += q_s[r * D + lane + 32 * i] * kv[i];
        a = warp_sum(a);
        if (lane == 0) s_s[r * kTile + j] = a;
      }
    }
    __syncthreads();

    for (int r = warp; r < G; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[r * kTile + j]);
      const float m_new = fmaxf(m_s[r], warp_max(mx));  // finite: n >= 1
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = exp2f(s_s[r * kTile + j] - m_new);
        s_s[r * kTile + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_s[r] - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < kAcc; ++jj) {
      const int idx = tid + jj * kThreads;
      if (idx < G * D) {
        const int r = idx / D, dd = idx % D;
        float a = acc[jj] * alpha_s[r];
        for (int j = 0; j < n; ++j) {
          a += s_s[r * kTile + j] * to_float(vh[row_s[j] + dd]);
        }
        acc[jj] = a;
      }
    }
    __syncthreads();  // the next tile rewrites row_s and s_s
  }

  T* out = static_cast<T*>(p.out) + (size_t)(bb * p.h_kv + hk) * G * D;
#pragma unroll
  for (int jj = 0; jj < kAcc; ++jj) {
    const int idx = tid + jj * kThreads;
    if (idx < G * D) {
      const float l = l_s[idx / D];
      out[idx] = from_float<T>(l > 0.f ? acc[jj] / l : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const DecodeParams& p, int d, int b, cudaStream_t st) {
  const dim3 grid(p.h_kv, b);
  if (d == 64) {
    paged_decode_kernel<T, 64><<<grid, kThreads, 0, st>>>(p);
  } else if (d == 128) {
    paged_decode_kernel<T, 128><<<grid, kThreads, 0, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace fattn

extern "C" int fattn_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* lengths,
                                  const void* page_table, void* out, int b,
                                  int h_kv, int group, int num_pages,
                                  int page_size, int pages_max, int d,
                                  float scale, int dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || h_kv <= 0 || group <= 0 || group > kMaxGroup ||
      num_pages <= 0 || page_size <= 0 || pages_max <= 0) {
    return cudaErrorInvalidValue;
  }
  const DecodeParams p{q,
                       k_pages,
                       v_pages,
                       static_cast<const int*>(lengths),
                       static_cast<const int*>(page_table),
                       out,
                       h_kv,
                       group,
                       num_pages,
                       page_size,
                       pages_max,
                       scale * kLog2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(p, d, b, st);
    case kF16:
      return launch<__half>(p, d, b, st);
    case kBF16:
      return launch<__nv_bfloat16>(p, d, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}
