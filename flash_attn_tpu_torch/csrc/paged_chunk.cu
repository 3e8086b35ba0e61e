// Multi-token paged attention for Hopper (sm_90a): K6.
//
// Replaces flash_attn_tpu/kernels/chunk.py:_chunk_kernel (launcher
// paged_chunk_attention there): a chunk of sq query tokens per sequence
// attends to its keys, which lie in pages scattered over the cache and are
// found through the page table. The compute core of chunked prefill and of
// speculative verification.
//
// Layout: q (b, sq, h_kv * group, d), the JAX layout, read in place through
// its strides (last dimension contiguous), so the models hand over a view
// of their fused projection; out the same shape, contiguous, written in
// place; k_pages and v_pages (h_kv, num_pages, page_size, d) contiguous;
// lengths, chunk_lens (b,) int32; page_table (b, pages_max) int32. Row t of
// sequence b sits at global position lengths[b] - chunk_lens[b] + t
// (tail-aligned: the chunk is the end of the cached sequence). Rows t >=
// chunk_lens[b] are padding; they, and rows that see no key, give out = 0
// (chunk.py:207, l == 0). The visibility predicates are csrc/paged.cuh,
// shared with K5.
//
// Rows: a block holds the group's query heads x tile_t chunk rows, block
// row r = (t - t0) * group + g, so a K/V tile read from the pages serves the
// whole group, as in K5. sq is not padded: the ragged tail is masked.
// Key walk: the walk ends at the key of the block's last live row,
// min(length, first_qpos + t_last + 1): the TPU kernel could not bound its
// grid per row tile, this one skips the keys its rows cannot see. A block
// whose rows are all padding walks nothing and writes its zeros.
// Split-KV (csrc/paged_split.cuh, shared with K5): when the grid of (row
// tile, kv head, sequence) blocks is below about two waves (verification
// at sq 5), the host cuts the keys into ranges of whole 64-key tiles, one
// block per (split, row tile, ...) walks its range, and a merge kernel
// combines the partials in split order.
// Bound: the tensor-core products at prefill chunks over long contexts, the
// bytes of the live pages at small sq (verification, sq 1-5).
//   - bf16 / fp16 (paged_chunk_wgmma_kernel): 128 rows per block, two
//     warpgroups of 64, 256 threads (K1's register budget; see
//     csrc/hopper.cuh on larger blocks). q sits in registers as the wgmma A
//     operand. 64-key K and V tiles stream by TMA through a ring of 3
//     stages: a 4-D map over each of k_pages and v_pages, (d, page_size,
//     num_pages, h_kv), whose box is one 64-column block of min(page_size,
//     64) rows, so a tile takes one box per page it touches and column
//     block, at (column, offset in page, page id, kv head), the page ids
//     read from the table once per tile; a page past the table maps past
//     the cache, which TMA fills with zeros. Page sizes that are multiples
//     of 64, or divisors of 64 from 8 on, tile this way; the wrapper raises
//     for others. S = Q K^T by register-A wgmma m64n64k16 from the
//     128-byte-swizzled tile, the online softmax in fp32 registers in the
//     log2 domain (only tiles crossing a row's diagonal or the length test
//     elements), P rounded in registers and O += P V by register-A wgmma
//     reading V as stored (transpose bit). The warpgroup that releases a
//     stage second refills it; a warpgroup with no live row only keeps
//     that protocol.
//   - fp32 (paged_chunk_f32_kernel): 64 rows per block, four threads per
//     row with FMA on the CUDA cores, 32-key tiles by 16-byte loads; never
//     split.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "paged.cuh"
#include "paged_split.cuh"

namespace fattn {
namespace {

struct ChunkParams {
  const void* q;
  long long q_sb, q_st, q_sh;  // element strides of q's batch, row, head
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* chunk_lens;
  const int* page_table;
  void* out;
  SplitKV sp;
  int sq, h_kv, group, tile_t, row_tiles, num_pages, page_size, pages_max;
  int box_rows;  // rows of a TMA box: min(page_size, 64)
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

__device__ __forceinline__ BlockRows block_rows(const ChunkParams& p, int bb,
                                                int row_tile) {
  BlockRows br;
  const int raw = p.lengths[bb];
  br.chunk_len = p.chunk_lens[bb];
  br.length = paged_length(raw, p.pages_max, p.page_size);
  br.first_qpos = raw - br.chunk_len;
  br.t0 = row_tile * p.tile_t;
  const int t_end = min(br.t0 + p.tile_t, min(br.chunk_len, p.sq));
  br.n_keys = t_end > br.t0
                  ? paged_live_keys(br.length, br.first_qpos + t_end - 1)
                  : 0;
  return br;
}

// Chunk row of block row r, or -1 for a row past those the block holds.
__device__ __forceinline__ int row_t(const ChunkParams& p,
                                     const BlockRows& br, int r) {
  const int tt = br.t0 + r / p.group;
  return r < p.group * p.tile_t && tt < p.sq ? tt : -1;
}

// Block row r is a chunk row that is not padding.
__device__ __forceinline__ bool row_live(const ChunkParams& p,
                                         const BlockRows& br, int r) {
  const int tt = row_t(p, br, r);
  return tt >= 0 && tt < br.chunk_len;
}

// Global position of block row r; -1 (sees no key) for a row that is not
// live.
__device__ __forceinline__ int row_qpos(const ChunkParams& p,
                                        const BlockRows& br, int r) {
  return row_live(p, br, r) ? br.first_qpos + row_t(p, br, r) : -1;
}

// Element offset of block row r in q, or -1 for a row past the block's.
__device__ __forceinline__ long long q_offset(const ChunkParams& p,
                                              const BlockRows& br, int bb,
                                              int hk, int r) {
  const int tt = row_t(p, br, r);
  if (tt < 0) return -1;
  return bb * p.q_sb + tt * p.q_st + (hk * p.group + r % p.group) * p.q_sh;
}

// Output row (b, t, query head) of block row r, or -1 for a row past the
// block's.
__device__ __forceinline__ int out_row(const ChunkParams& p,
                                       const BlockRows& br, int bb, int hk,
                                       int r) {
  const int tt = row_t(p, br, r);
  if (tt < 0) return -1;
  return (bb * p.sq + tt) * p.h_kv * p.group + hk * p.group + r % p.group;
}

// ---------------------------------------------------------------- wgmma path

constexpr int kRows = 128;     // query rows per block, 64 per warpgroup
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // two warpgroups

template <int D>
struct ChunkLayout {
  static constexpr int kStages = 3;          // 48 KB (d = 64), 96 KB (128)
  static constexpr int kTile = kKeys * D;    // elements of a K or V tile
  // The K ring, the V ring, kStages mbarriers and release counts,
  // alignment slack.
  static constexpr int kBytes = 2 * 2 * kStages * kTile + 12 * kStages + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    paged_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const ChunkParams p) {
  using L = ChunkLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_aligned(smem_raw));
  uint16_t* v_s = k_s + kStages * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * L::kTile);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + kStages);

  const int row_tile = blockIdx.x % p.row_tiles;
  const int split = blockIdx.x / p.row_tiles;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int ps = p.page_size;
  const BlockRows br = block_rows(p, bb, row_tile);
  const int k_lo = split * p.sp.split_keys;  // a multiple of kKeys
  const int k_hi = min(br.n_keys, k_lo + p.sp.split_keys);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;

  // Tile j (keys k_lo + 64 j on) into ring stage j % kStages: one TMA box
  // per page it touches and 64-column block.
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_lo + j * kKeys;
    mbar_arrive_expect_tx(&full[s], 2 * 2 * L::kTile);
    for (int r = 0; r < kKeys; r += p.box_rows) {
      const int pos = k0 + r;
      const int id = pos / ps < p.pages_max ? tbl[pos / ps] : p.num_pages;
      for (int c = 0; c < D / 64; ++c) {
        const int off = s * L::kTile + c * kKeys * 64 + r * 64;
        tma_load_4d(k_s + off, &map_k, &full[s], c * 64, pos % ps, id, hk);
        tma_load_4d(v_s + off, &map_v, &full[s], c * 64, pos % ps, id, hk);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0u;
    }
    mbar_fence_init();
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_wg = wg * 64;                // this warpgroup's first row
  const int row0 = r_wg + warp * 16 + g;  // this thread's rows: +0, +8
  const int rows[2] = {row0, row0 + 8};
  const int qpos[2] = {row_qpos(p, br, rows[0]), row_qpos(p, br, rows[1])};
  // Rows rise with t: a warpgroup whose first row is not live has none.
  const bool live = row_live(p, br, r_wg);
  const int wg_qpos = row_qpos(p, br, r_wg);  // its smallest position

  // q as the A operand of S = Q K^T (csrc/mma.cuh fragment layout).
  const uint16_t* q = static_cast<const uint16_t*>(p.q);
  uint32_t qa[D / 16][4];
  {
    const long long off[2] = {q_offset(p, br, bb, hk, rows[0]),
                              q_offset(p, br, bb, hk, rows[1])};
    auto q_pair = [&](int i, int col) -> uint32_t {
      return live && off[i] >= 0 ? ld_pair(q + off[i] + col) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = q_pair(0, kk * 16 + 2 * t);
      qa[kk][1] = q_pair(1, kk * 16 + 2 * t);
      qa[kk][2] = q_pair(0, kk * 16 + 8 + 2 * t);
      qa[kk][3] = q_pair(1, kk * 16 + 8 + 2 * t);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = k_lo + j * kKeys;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (live) {
      // S = Q K^T: 64 rows x 64 keys; sc[4 nb + e] as in csrc/hopper.cuh.
      float sc[kKeys / 2];
      const uint32_t kb = opaque(k_base) + s * L::kTile * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // Column block kk / 4, 16-element (32-byte) step kk % 4 inside it.
        const int c = kk / 4, step = (kk % 4) * 32;
        Wgmma<T, kKeys>::template rs<0>(
            sc, qa[kk], sw128_desc(kb + c * kKeys * 128 + step, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Only a tile crossing the length or this warpgroup's diagonal (its
      // first row has the smallest position) tests elements.
      if (k0 + kKeys > br.length || k0 + kKeys - 1 > wg_qpos) {
#pragma unroll
        for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nb * 8 + 2 * t + (e & 1);
            if (!paged_key_visible(col, qpos[e >> 1], br.length)) {
              sc[nb * 4 + e] = -INFINITY;
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float base[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r] * p.scale_log2);
        // A row with nothing visible yet keeps m = -inf; exp2 against 0
        // then gives p = 0 and alpha = 0 instead of NaN.
        base[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = exp2f(m[r] - base[r]);
        m[r] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], p.scale_log2, -base[r]));
        rs[r] += sc[i];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: the C fragments of two key n-blocks form one A fragment.
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
      const uint32_t vb = opaque(v_base) + s * L::kTile * 2;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        Wgmma<T, D>::template rs<1>(
            o, pa[kk], sw128_desc(vb + kk * 16 * 128, kKeys * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(o);
    }
    // Tile j's stage is free once both warpgroups are done with it.
    named_barrier(1 + wg, 128);
    if (tid == 0 && stage_released_by_both(&released[s]) &&
        j + kStages < n_tiles) {
      load_tile(j + kStages);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int orow = out_row(p, br, bb, hk, rows[r]);
    if (orow < 0) continue;
    // Padding rows (and rows that saw no key) give 0.
    const float lr = qpos[r] >= 0 ? l[r] : 0.f;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    if (p.sp.o_part == nullptr) {
      uint16_t* out = static_cast<uint16_t*>(p.out) + (size_t)orow * D;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(out + nb * 8 + 2 * t) =
            Mma<T>::pack(o[nb * 4 + 2 * r] * inv, o[nb * 4 + 2 * r + 1] * inv);
      }
      continue;
    }
    if (lr > 0.f) {
      float* po = partial_o(p.sp, split, orow, D);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        *reinterpret_cast<float2*>(po + nb * 8 + 2 * t) = make_float2(
            o[nb * 4 + 2 * r] * inv, o[nb * 4 + 2 * r + 1] * inv);
      }
    }
    if (t == 0) *partial_lse(p.sp, split, orow, D) = partial_lse2(m[r], lr);
  }
}

// --------------------------------------------------------------- fp32 path

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
  const BlockRows br = block_rows(p, bb, blockIdx.x);
  const long long off = q_offset(p, br, bb, hk, row);
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

  const int orow = out_row(p, br, bb, hk, row);
  if (orow < 0) return;
  float* out = static_cast<float*>(p.out) + (size_t)orow * D;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[i * 4 + t4] = acc[i] * inv;
}

template <typename T, int D>
cudaError_t launch_wgmma(const ChunkParams& p, int b, cudaStream_t st) {
  using L = ChunkLayout<D>;
  // Each cache as (h_kv, num_pages, page_size, d): 4-D maps whose box is
  // one 64-column block of box_rows rows of one page.
  const Strides pages{(long long)p.num_pages * p.page_size * D,
                      (long long)p.page_size * D, D};
  CUtensorMap map_k, map_v;
  cudaError_t err = make_tile_map(&map_k, p.k_pages, p.h_kv, p.num_pages,
                                  p.page_size, D, pages, p.box_rows);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v_pages, p.h_kv, p.num_pages, p.page_size,
                        D, pages, p.box_rows);
  }
  if (err != cudaSuccess) return err;
  const auto kernel = paged_chunk_wgmma_kernel<T, D>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(p.row_tiles * p.sp.n_splits, p.h_kv, b), kThreads,
           L::kBytes, st>>>(map_k, map_v, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.sp.o_part == nullptr) return err;
  return launch_merge<T, D>(p.sp, static_cast<T*>(p.out), st);
}

template <int D>
cudaError_t launch(const ChunkParams& p, int dtype, int b, cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      return launch_wgmma<__nv_bfloat16, D>(p, b, st);
    case kF16:
      return launch_wgmma<__half, D>(p, b, st);
    case kF32:
      paged_chunk_f32_kernel<D><<<dim3(p.row_tiles, p.h_kv, b), 256, 0, st>>>(p);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fattn

// q_sb, q_st, q_sh: q's batch, row and head element strides (its last
// dimension contiguous, rows 16-byte aligned). partials: fp32 scratch of
// n_splits * b * sq * h * (d + 1) floats (csrc/paged_split.cuh), or nullptr
// when n_splits == 1 (always for fp32); split_keys: keys per split, a
// multiple of 64 and of page_size.
extern "C" int fattn_paged_chunk(const void* q, long long q_sb,
                                 long long q_st, long long q_sh,
                                 const void* k_pages, const void* v_pages,
                                 const void* lengths, const void* chunk_lens,
                                 const void* page_table, void* out,
                                 void* partials, int b, int sq, int h_kv,
                                 int group, int num_pages, int page_size,
                                 int pages_max, int n_splits, int split_keys,
                                 int d, float scale, int dtype,
                                 void* stream) {
  using namespace fattn;
  const bool f32 = dtype == kF32;
  const int rows = f32 ? 64 : kRows;  // query rows per block
  const bool tiles_pages = page_size % kKeys == 0 ||
                           (kKeys % page_size == 0 && page_size >= 8);
  if (b <= 0 || sq <= 0 || h_kv <= 0 || group <= 0 || group > 64 ||
      num_pages <= 0 || page_size <= 0 || pages_max <= 0 || n_splits <= 0 ||
      split_keys <= 0 || split_keys % kKeys != 0 ||
      split_keys % page_size != 0 || (n_splits > 1) != (partials != nullptr) ||
      (f32 && n_splits != 1) || (!f32 && !tiles_pages)) {
    return cudaErrorInvalidValue;
  }
  const int tile_t = rows / group;
  const ChunkParams p{q,
                      q_sb,
                      q_st,
                      q_sh,
                      k_pages,
                      v_pages,
                      static_cast<const int*>(lengths),
                      static_cast<const int*>(chunk_lens),
                      static_cast<const int*>(page_table),
                      out,
                      SplitKV{static_cast<float*>(partials), n_splits,
                              split_keys, b * sq * h_kv * group},
                      sq,
                      h_kv,
                      group,
                      tile_t,
                      (sq + tile_t - 1) / tile_t,
                      num_pages,
                      page_size,
                      pages_max,
                      page_size < kKeys ? page_size : kKeys,
                      scale * kLog2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, dtype, b, st);
  if (d == 128) return launch<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_paged_chunk_smem(int d) {
  using namespace fattn;
  return d == 64 ? ChunkLayout<64>::kBytes : d == 128 ? ChunkLayout<128>::kBytes : 0;
}
