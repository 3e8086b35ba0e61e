// Multi-token paged attention for Hopper (sm_90a).
//
// Replaces flash_attn_tpu/kernels/chunk.py:_chunk_kernel (launcher
// paged_chunk_attention there): a chunk of sq query tokens per sequence
// attends to its keys, which lie in pages scattered over the cache and are
// found through the page table. The compute core of chunked prefill and of
// speculative verification.
//
// Layout: q and out (b, sq, h_kv * group, d), the JAX layout, read and
// written in place; k_pages and v_pages (h_kv, num_pages, page_size, d);
// lengths, chunk_lens (b,) int32; page_table (b, pages_max) int32. Row t of
// sequence b sits at global position lengths[b] - chunk_lens[b] + t
// (tail-aligned: the chunk is the end of the cached sequence). Rows t >=
// chunk_lens[b] are padding; they, and rows that see no key, give out = 0
// (chunk.py:207, l == 0). The visibility predicates are csrc/paged.cuh,
// shared with K5.
//
// Grid: one block per (tile of query rows, kv head, sequence). A block's 64
// rows are the group's query heads x tile_t = 64 / group chunk rows, block
// row r = (t - t0) * group + g, so a K/V tile read from the pages serves the
// whole group, as in K5. sq is not padded: the ragged tail is masked.
// Key walk: tiles of 64 keys (32 for fp32); the ids of the pages a tile
// touches are read from the table once per tile into shared memory. The
// walk ends at the key of the block's last live row, min(length,
// first_qpos + t_last + 1): the TPU kernel could not bound its grid per row
// tile, this one skips the keys its rows cannot see. A block whose first row
// is padding walks nothing and writes its zeros.
// Arithmetic: online softmax with fp32 (m, l, acc), scores in the log2
// domain. bf16 / fp16: four warps of 16 rows on mma.sync m16n8k16, the score
// fragment reused as the A operand of P @ V (as K1). fp32: four threads per
// row with FMA on the CUDA cores.
// Bound: the tensor-core products at prefill chunks over long contexts, the
// bytes of the live pages at small sq (verification, sq 1-5). This first
// version loads each tile with plain 16-byte loads into one buffer, so loads
// and math do not overlap; cp.async, TMA and wgmma are the later work, and at
// small sq the 64-row tile is mostly empty (a narrower tile is the fix).
#include "common.cuh"
#include "mma.cuh"
#include "paged.cuh"

namespace fattn {
namespace {

constexpr int kRows = 64;  // query rows per block

struct ChunkParams {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* chunk_lens;
  const int* page_table;
  void* out;
  int sq, h_kv, group, tile_t, num_pages, page_size, pages_max;
  float scale_log2;
};

// What a block knows about its sequence and its chunk rows.
struct BlockRows {
  int length;      // keys in the page table (paged_length)
  int first_qpos;  // global position of chunk row 0
  int chunk_len;   // valid chunk rows
  int t0;          // the block's first chunk row
  int n_keys;      // keys its rows can see at all: the walk's bound
};

__device__ __forceinline__ BlockRows block_rows(const ChunkParams& p,
                                                int bb) {
  BlockRows br;
  const int raw = p.lengths[bb];
  br.chunk_len = p.chunk_lens[bb];
  br.length = paged_length(raw, p.pages_max, p.page_size);
  br.first_qpos = raw - br.chunk_len;
  br.t0 = blockIdx.x * p.tile_t;
  const int t_end = min(br.t0 + p.tile_t, min(br.chunk_len, p.sq));
  br.n_keys = t_end > br.t0
                  ? paged_live_keys(br.length, br.first_qpos + t_end - 1)
                  : 0;
  return br;
}

// Global position of block row r, or -1 (sees no key) for a padding row or
// a row past those the block holds.
__device__ __forceinline__ int row_qpos(const ChunkParams& p,
                                        const BlockRows& br, int r) {
  const int tt = br.t0 + r / p.group;
  const bool live =
      r < p.group * p.tile_t && tt < p.sq && tt < br.chunk_len;
  return live ? br.first_qpos + tt : -1;
}

// Element offset of block row r in q and out, or -1 for a row past those
// the block holds.
template <int D>
__device__ __forceinline__ long long row_offset(const ChunkParams& p,
                                                const BlockRows& br, int bb,
                                                int hk, int r) {
  const int tt = br.t0 + r / p.group;
  if (r >= p.group * p.tile_t || tt >= p.sq) return -1;
  return ((long long)(bb * p.sq + tt) * p.h_kv * p.group + hk * p.group +
          r % p.group) *
         D;
}

// The page ids of the keys [k0, k0 + n), read from the table once per tile.
__device__ __forceinline__ void load_page_ids(int* page_s, const int* tbl,
                                              int k0, int n, int ps) {
  const int pg0 = k0 / ps;
  const int npg = (k0 + n - 1) / ps - pg0 + 1;  // <= n
  for (int i = threadIdx.x; i < npg; i += blockDim.x) page_s[i] = tbl[pg0 + i];
}

// Element offset of key position pos within a kv head's pages.
template <int D>
__device__ __forceinline__ size_t key_offset(const int* page_s, int k0,
                                             int pos, int ps) {
  return ((size_t)page_s[pos / ps - k0 / ps] * ps + pos % ps) * D;
}

// ---------------------------------------------------------------- mma path

// Fragment layouts: csrc/mma.cuh.
template <typename T, int D>
__global__ void __launch_bounds__(128)
    paged_chunk_mma_kernel(const ChunkParams p) {
  constexpr int kBlockK = 64;
  constexpr int kStride = D + 8;  // shared row stride in elements: no bank conflicts
  __shared__ __align__(16) uint16_t k_s[kBlockK * kStride];
  __shared__ __align__(16) uint16_t v_s[kBlockK * kStride];
  __shared__ int page_s[kBlockK];

  const int hk = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ps = p.page_size;
  const BlockRows br = block_rows(p, bb);
  const int row0 = warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const long long off[2] = {row_offset<D>(p, br, bb, hk, row0),
                            row_offset<D>(p, br, bb, hk, row0 + 8)};
  const int qpos[2] = {row_qpos(p, br, row0), row_qpos(p, br, row0 + 8)};

  const size_t head = (size_t)hk * p.num_pages * ps * D;
  const uint16_t* kh = static_cast<const uint16_t*>(p.k_pages) + head;
  const uint16_t* vh = static_cast<const uint16_t*>(p.v_pages) + head;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;
  const uint16_t* q = static_cast<const uint16_t*>(p.q);

  auto q_pair = [&](int i, int col) -> uint32_t {
    return off[i] >= 0 && br.n_keys > 0
               ? *reinterpret_cast<const uint32_t*>(q + off[i] + col)
               : 0u;
  };
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = q_pair(0, kk * 16 + 2 * t);
    qa[kk][1] = q_pair(1, kk * 16 + 2 * t);
    qa[kk][2] = q_pair(0, kk * 16 + 8 + 2 * t);
    qa[kk][3] = q_pair(1, kk * 16 + 8 + 2 * t);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  for (int k0 = 0; k0 < br.n_keys; k0 += kBlockK) {
    const int n = min(kBlockK, br.n_keys - k0);
    __syncthreads();  // the previous tile is no longer read
    load_page_ids(page_s, tbl, k0, n, ps);
    __syncthreads();
    constexpr int kVecPerRow = D / 8;  // 16-byte vectors
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += blockDim.x) {
      const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < n) {
        const size_t src = key_offset<D>(page_s, k0, k0 + r, ps) + c;
        kv = *reinterpret_cast<const uint4*>(kh + src);
        vv = *reinterpret_cast<const uint4*>(vh + src);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = k_s + (nb * 8 + g) * kStride + kk * 16 + 2 * t;
        Mma<T>::run(s[nb], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // Keys past n_keys were loaded as zeros; none is visible (paged.cuh).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        float x = s[nb][e] * p.scale_log2;
        if (!paged_key_visible(col, qpos[e >> 1], br.length)) x = -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with nothing visible yet keeps m = -inf; exp2 against 0
      // then gives p = 0 and alpha = 0 instead of NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - base[e >> 1]);
        rs[e >> 1] += s[nb][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the C fragments of two key n-blocks form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vr = v_s + (kk * 16 + 2 * t) * kStride + dn * 8 + g;
        Mma<T>::run(o[dn], pa, ld_col_pair(vr, kStride),
                    ld_col_pair(vr + 8 * kStride, kStride));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  uint16_t* out = static_cast<uint16_t*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (off[r] < 0) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + off[r] + dn * 8 + 2 * t) =
          Mma<T>::pack(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
  }
}

// --------------------------------------------------------------- fp32 path

// Four threads per query row; thread t4 owns dims t4, t4 + 4, ... of q and of
// the accumulator, so a quad reads four consecutive floats of a K/V row.
template <int D>
__global__ void __launch_bounds__(256)
    paged_chunk_f32_kernel(const ChunkParams p) {
  constexpr int kBlockK = 32;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float k_s[kBlockK * D];
  __shared__ __align__(16) float v_s[kBlockK * D];
  __shared__ int page_s[kBlockK];

  const int hk = blockIdx.y, bb = blockIdx.z;
  const int t4 = threadIdx.x & 3;
  const int row = threadIdx.x >> 2;
  const int ps = p.page_size;
  const BlockRows br = block_rows(p, bb);
  const long long off = row_offset<D>(p, br, bb, hk, row);
  const int qpos = row_qpos(p, br, row);

  const size_t head = (size_t)hk * p.num_pages * ps * D;
  const float* kh = static_cast<const float*>(p.k_pages) + head;
  const float* vh = static_cast<const float*>(p.v_pages) + head;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;
  const float* q = static_cast<const float*>(p.q);

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = off >= 0 && br.n_keys > 0 ? q[off + i * 4 + t4] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < br.n_keys; k0 += kBlockK) {
    const int n = min(kBlockK, br.n_keys - k0);
    __syncthreads();
    load_page_ids(page_s, tbl, k0, n, ps);
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < n) {
        const size_t src = key_offset<D>(page_s, k0, k0 + r, ps) + c;
        kv = *reinterpret_cast<const float4*>(kh + src);
        vv = *reinterpret_cast<const float4*>(vh + src);
      }
      *reinterpret_cast<float4*>(k_s + r * D + c) = kv;
      *reinterpret_cast<float4*>(v_s + r * D + c) = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) a += qr[i] * k_s[j * D + i * 4 + t4];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      s[j] = paged_key_visible(k0 + j, qpos, br.length) ? a * p.scale_log2
                                                         : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - base);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = exp2f(s[j] - base);
      rs += s[j];
    }
    l = l * alpha + rs;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) a += s[j] * v_s[j * D + i * 4 + t4];
      acc[i] = a;
    }
  }

  if (off < 0) return;
  float* out = static_cast<float*>(p.out);
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[off + i * 4 + t4] = acc[i] * inv;
}

template <int D>
cudaError_t launch(const ChunkParams& p, int dtype, int b, cudaStream_t st) {
  const dim3 grid((p.sq + p.tile_t - 1) / p.tile_t, p.h_kv, b);
  switch (dtype) {
    case kBF16:
      paged_chunk_mma_kernel<__nv_bfloat16, D><<<grid, 128, 0, st>>>(p);
      break;
    case kF16:
      paged_chunk_mma_kernel<__half, D><<<grid, 128, 0, st>>>(p);
      break;
    case kF32:
      paged_chunk_f32_kernel<D><<<grid, 256, 0, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace fattn

extern "C" int fattn_paged_chunk(const void* q, const void* k_pages,
                                 const void* v_pages, const void* lengths,
                                 const void* chunk_lens,
                                 const void* page_table, void* out, int b,
                                 int sq, int h_kv, int group, int num_pages,
                                 int page_size, int pages_max, int d,
                                 float scale, int dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || sq <= 0 || h_kv <= 0 || group <= 0 || group > kRows ||
      num_pages <= 0 || page_size <= 0 || pages_max <= 0) {
    return cudaErrorInvalidValue;
  }
  const ChunkParams p{q,
                      k_pages,
                      v_pages,
                      static_cast<const int*>(lengths),
                      static_cast<const int*>(chunk_lens),
                      static_cast<const int*>(page_table),
                      out,
                      sq,
                      h_kv,
                      group,
                      kRows / group,
                      num_pages,
                      page_size,
                      pages_max,
                      scale * kLog2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, dtype, b, st);
  if (d == 128) return launch<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}
