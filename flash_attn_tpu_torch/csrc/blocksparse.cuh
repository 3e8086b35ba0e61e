// Blocksparse attention: what the forward (K8a) and the two backward kernels
// (K8b dK/dV, K8c dQ) share.
//
// A (sq/16, sk/256) cell mask gates the attention matrix. The layout
// compiler (flash_attn_tpu_torch/kernels/blocksparse.py build_layout) cuts
// it into tiles of kTileQ query rows x kTileK keys and gives each q tile the
// list of its live kv tiles, each kv tile the list of its live q tiles, and a
// FULL flag per pair (every cell live, wholly below the diagonal when
// causal, inside sk). A kv tile of 64 keys lies inside one 256-column cell,
// so within a tile a row's cell bit is one byte of the per-row mask
// rowmask (sq_pad, ncells).
//
// Visibility of (row, col), row < sq_pad and col < sk_pad:
//   - key padding, on EVERY tile: the row and the key are valid
//     (q_valid / k_valid, nullptr = all valid) and col < sk;
//   - on a partial tile also the row's cell bit and top-left causality
//     (col <= row). A FULL tile skips these two.
// The JAX kernels apply the padding (their segment mask) only on partial
// tiles, so padded keys of a full tile are attended there; the port follows
// the oracle (ROADMAP C9).
//
// The bf16 / fp16 kernels are wgmma kernels of one warpgroup per 64-row q
// tile (K8a, K8c) or 64-key kv tile (K8b): neighbouring tiles have
// different lists, so a block of two tiles would walk the union with one
// warpgroup idle on the other's dead tiles. K8a and K8c share the K/V ring
// below and the per-tile key-validity bits.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mask.cuh"
#include "prng.cuh"

namespace fattn {

constexpr int kTileQ = 64;  // query rows per layout tile
constexpr int kTileK = 64;  // keys per layout tile
constexpr int kBsThreads = 128;  // one warpgroup: K8a-c's bf16 / fp16 block

// Operands are read and written through Strides (csrc/common.cuh), so
// the kernels take the op's (b, s, h, d) tensors and the packed qkv's q, k
// and v in place.
struct BsParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward only
  const float* lse;  // backward: the forward's lse (b, h, sq)
  const float* di;   // backward: rowsum(dout * out) - dlse (b, h, sq)
  void* o;           // forward: out; dq kernel: dq
  float* lse_out;    // forward: lse (b, h, sq)
  void* dk;
  void* dv;
  // The walk: per q tile its kv tiles (K8a, K8c) or per kv tile its q tiles
  // (K8b); (n_tiles, max_n) int32 ids and FULL flags, (n_tiles,) counts.
  const int* idx;
  const int* cnt;
  const int* full;
  const uint8_t* rowmask;  // (sq_pad, ncells): 1 = the row's cell is live
  const uint8_t* rowmask_t;  // K8b: the same, transposed (ncells, sq_pad)
  const uint8_t* q_valid;  // (b, sq) or nullptr
  const uint8_t* k_valid;  // (b, sk) or nullptr
  // K8a, K8c: (b, ceil(sk / 64)) words, bit i of word t = key 64 t + i is
  // valid and inside sk; nullptr without key padding.
  const uint64_t* key_bits;
  int h, sq, sk, max_n, ncells;
  float scale_log2;  // softmax scale * log2(e)
  float scale;
  bool causal;
  Dropout drop;
  Strides st[kNumOps];  // o: out (K8a) or dq (K8c); kOpDQ unused
};

// Operand `op`'s rows of (batch bb, head hh); row r starts r * st[op].s on.
template <typename E>
__device__ __forceinline__ const E* bs_rows(const BsParams& p, const void* x, int op, int bb,
                                            int hh) {
  return static_cast<const E*>(x) + bb * p.st[op].b + hh * p.st[op].h;
}
template <typename E>
__device__ __forceinline__ E* bs_rows(const BsParams& p, void* x, int op, int bb, int hh) {
  return static_cast<E*>(x) + bb * p.st[op].b + hh * p.st[op].h;
}

// The row is a real, unpadded query.
__device__ __forceinline__ bool bs_row_ok(const BsParams& p, int bb, int row) {
  return row < p.sq && (p.q_valid == nullptr || p.q_valid[(size_t)bb * p.sq + row]);
}

// The key is in bounds and unpadded.
__device__ __forceinline__ bool bs_key_ok(const BsParams& p, int bb, int col) {
  return col < p.sk && (p.k_valid == nullptr || p.k_valid[(size_t)bb * p.sk + col]);
}

// The row's cell in the 256-column cell holding key col is live.
__device__ __forceinline__ bool bs_cell_on(const BsParams& p, int row, int col) {
  return p.rowmask[(size_t)row * p.ncells + (col >> 8)] != 0;
}

// Visibility of (row, col) given the padding terms row_ok and key_ok (which
// hold on every tile); a FULL tile needs nothing more, a partial one the cell
// bit and the dense mask of csrc/mask.cuh.
__device__ __forceinline__ bool bs_visible(const BsParams& p, bool full,
                                           bool cell_on, bool row_ok,
                                           bool key_ok, int row, int col) {
  return row_ok && key_ok &&
         (full || (cell_on && key_visible(row, col, p.sk, p.causal)));
}

// ------------------------------------------------- K8a and K8c: the walk

// The q tile of this block. Under causal masking a q tile's list grows
// with its index, so block 0 takes the last tile: the longest lists start
// first and the short ones fill the tail.
__device__ __forceinline__ int bs_q_tile(const BsParams& p) {
  return p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// Whether a warp whose 16 rows start at warp_row0 tests the elements of
// the kv tile at k0 one by one (its cell bit is tested per warp): under key
// padding, or on a partial tile that crosses sk or the warp's causal
// diagonal. Elsewhere the cell bit alone decides.
__device__ __forceinline__ bool bs_test_elements(const BsParams& p, bool full,
                                                 int k0, int warp_row0) {
  return p.key_bits != nullptr ||
         (!full && (k0 + kTileK > p.sk ||
                    (p.causal && k0 + kTileK - 1 > warp_row0)));
}

// The validity bits of kv tile `tile`'s 64 keys under key padding (the
// wrapper's key_bits; padding and keys past sk are 0). Without padding a
// full tile tests nothing and a partial one tests col < sk itself.
__device__ __forceinline__ uint64_t bs_key_bits(const BsParams& p, int bb,
                                                int tile) {
  return p.key_bits[(size_t)bb * ((p.sk + kTileK - 1) / kTileK) + tile];
}

// Shared memory of K8a and K8c: kResident tiles of 64 rows that stay for
// the whole walk (Q; Q and dO), then a ring of kStages stages, each the K
// and the V tile of one entry of the q tile's live kv list. One thread
// loads them by TMA; the entry is the box's row coordinate (list entry j
// -> stage j % kStages, mbarrier phase (j / kStages) & 1), so dead tiles
// are never read. Tiles are 64-column blocks with the 128-byte swizzle of
// csrc/hopper.cuh.
template <int D, int kResident, int kStages_>
struct KvRing {
  static constexpr int kStages = kStages_;
  static constexpr int kRes = kTileQ * D;  // elements of a resident tile
  static constexpr int kKV = kTileK * D;   // of a K or a V tile
  // The tiles (16-bit), kStages + 1 mbarriers, alignment slack.
  static constexpr int kBytes =
      2 * (kResident * kRes + 2 * kStages * kKV) + 8 * (kStages + 1) + 1024;

  uint16_t* res;       // resident tile i at + i * kRes
  uint16_t* k;         // stage s at + s * kKV
  uint16_t* v;
  uint64_t* full;      // one mbarrier per stage
  uint64_t* res_full;  // the resident tiles'

  __device__ explicit KvRing(uint8_t* raw) {
    res = reinterpret_cast<uint16_t*>(smem_aligned(raw));
    k = res + kResident * kRes;
    v = k + kStages * kKV;
    full = reinterpret_cast<uint64_t*>(v + kStages * kKV);
    res_full = full + kStages;
  }

  // One thread, first: the barriers, and the resident tiles' byte count.
  __device__ void init() {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(res_full, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(res_full, 2 * kResident * kRes);
  }
  // Resident tile i: rows q0 .. q0 + 63 of (head hh, batch bb) of `map`.
  __device__ void load_resident(int i, const CUtensorMap* map, int q0, int hh,
                                int bb) {
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(res + i * kRes + c * kTileQ * 64, map, res_full, c * 64, q0,
                  hh, bb);
    }
  }
  // The K and V tiles of list entry j, kv tile `tile`.
  __device__ void load(int j, int tile, const CUtensorMap* map_k,
                       const CUtensorMap* map_v, int hh, int bb) {
    const int s = j % kStages;
    mbar_arrive_expect_tx(&full[s], 2 * 2 * kKV);
    for (int c = 0; c < D / 64; ++c) {
      const int off = s * kKV + c * kTileK * 64;
      tma_load_4d(k + off, map_k, &full[s], c * 64, tile * kTileK, hh, bb);
      tma_load_4d(v + off, map_v, &full[s], c * 64, tile * kTileK, hh, bb);
    }
  }
  __device__ void wait_resident() const { mbar_wait(res_full, 0); }
  __device__ void wait(int j) const {
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
  }
  // Shared byte addresses of resident tile i and of entry j's K and V.
  __device__ uint32_t res_addr(int i) const { return smem_u32(res + i * kRes); }
  __device__ uint32_t k_addr(int j) const {
    return smem_u32(k + (j % kStages) * kKV);
  }
  __device__ uint32_t v_addr(int j) const {
    return smem_u32(v + (j % kStages) * kKV);
  }
};

// The TMA map of operand `op` (q, dout: sq rows; k, v: sk rows) with boxes
// of 64 rows, over its strides.
inline cudaError_t bs_map(CUtensorMap* map, const BsParams& p, int op, int b,
                          int d) {
  const void* base = op == kOpQ ? p.q : op == kOpK ? p.k
                   : op == kOpV ? p.v : p.dout;
  const bool rows_q = op == kOpQ || op == kOpDO;
  return make_tile_map(map, base, b, p.h, rows_q ? p.sq : p.sk, d, p.st[op],
                       rows_q ? kTileQ : kTileK);
}

}  // namespace fattn
