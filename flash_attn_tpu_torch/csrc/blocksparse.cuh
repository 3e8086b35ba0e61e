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
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mask.cuh"
#include "prng.cuh"

namespace fattn {

constexpr int kTileQ = 64;  // query rows per layout tile
constexpr int kTileK = 64;  // keys per layout tile
constexpr int kMmaThreads = 128;  // four warps: the bf16 / fp16 kernels' block

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
  const uint8_t* q_valid;  // (b, sq) or nullptr
  const uint8_t* k_valid;  // (b, sk) or nullptr
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

}  // namespace fattn
