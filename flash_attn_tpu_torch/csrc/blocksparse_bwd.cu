// Blocksparse attention backward for Hopper (sm_90a): dK/dV (K8b) and dQ
// (K8c).
//
// Replace the Pallas kernels flash_attn_tpu/kernels/blocksparse.py
// :_bs_dkv_kernel (:855, launched at :1223) and :_bs_dq_kernel (:988,
// launched at :1287) of blocksparse_attention_bwd. As there, the backward is
// split in two kernels, so that neither needs atomics: K8b walks, for each kv
// tile, the transposed list of its live q tiles and holds dK and dV in
// registers; K8c walks, for each q tile, its list of live kv tiles and holds
// dQ. So neither needs K2's turn counters (csrc/flash_bwd.cu) to be
// deterministic. Both rebuild
// the probabilities p = exp(scale * q.k - lse) from the forward's lse, with
// the visibility of csrc/blocksparse.cuh (full tiles skip the cell and causal
// masks; key padding applies on every tile) and the dropout hash of K1/K2:
//   dV = (keep * p / (1 - p_drop))^T dO
//   dP = keep * (dO V^T) / (1 - p_drop)
//   dS = p * (dP - di),   di = rowsum(dO * O) - dlse (the wrapper's, in torch)
//   dK = scale * dS^T Q,  dQ = scale * dS K.
//
// Layout: q, dout, dq (b, h, sq, d); k, v, dk, dv (b, h, sk, d), each with
// its own strides (csrc/common.cuh Strides); lse and di (b, h, sq) fp32
// contiguous; MHA.
//   - K8b, bf16 / fp16 (bs_dkv_wgmma_kernel): K2's K/V-stationary design
//     (csrc/flash_bwd.cu) without dQ, one warpgroup per 64-key tile. K and V
//     are loaded once by TMA; the Q and dO tiles of the kv tile's live q-tile
//     list, with their row stats (bs_stats_kernel: lse in the log2 domain
//     with the row's padding folded in, di, the dropout row hash; one 1 KB
//     record per tile), stream by TMA through a ring of 3 (d = 64) or 2
//     (d = 128) stages with mbarriers, the list entry as the box's row
//     coordinate. S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 from
//     shared memory, in two groups so p is computed while dP^T runs; dV +=
//     P^T dO and dK += dS^T Q by register-A wgmma reading dO and Q as stored.
//     Only partial tiles (or any tile under key padding) test elements,
//     their rows' cell bits copied beside the stats (64 bytes of the
//     transposed rowmask). A kv tile's list differs from its neighbour's,
//     so a block holds one tile: 128 threads, three blocks to an SM at
//     d = 64 (168 registers) and two at d = 128 (by shared memory).
//   - K8c, bf16 / fp16 (bs_dq_wgmma_kernel): q-stationary, one warpgroup
//     per 64-row q tile, over the K/V ring K8a uses (csrc/blocksparse.cuh
//     KvRing: 2 stages, four blocks to an SM at d = 64, two at d = 128).
//     Q and dO are loaded once by TMA; the K and V tiles of the
//     live kv list stream by TMA. The row terms (lse in the log2 domain,
//     +inf where the row sees nothing, is padded or lies past sq; di; the
//     row hash) are read once per row, so K8c needs no stats launch. S = Q
//     K^T and dP = dO V^T by wgmma m64n64k16 from shared memory in two
//     groups, p computed while dP runs; dQ += dS K by register-A wgmma
//     reading K as stored; the scale applies at the store. The cell bit is
//     one test per warp, as in K8a. No atomics, no
//     turns: bitwise reproducible. Under causal masking the longest lists
//     launch first.
//   - fp32: 16 keys (K8b) or 16 rows (K8c) per block, FMA on the CUDA cores.
// Bound: tensor-core operations. Per visible (q, k) pair and head the
// backward needs 5 products, 10 * d operations; split as here it takes 14
// (K8b 8: S, dP, dV, dK; K8c 6: S, dP, dQ).
#include "blocksparse.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace fattn {
namespace {

// ------------------------------------------------------------- K8b: dK, dV

// The row stats the wgmma kernel streams beside each Q tile: one float4 per
// (b, h, row < sq_pad), {lse * log2(e), 0, di, the dropout row hash} (di and
// the hash as one 8-byte load). The first is +inf (so p = exp2(s - inf) = 0) where the row sees nothing (lse =
// -inf), is padded (q_valid) or lies past sq: the row terms of the
// visibility, folded in once per row instead of tested per element.
__global__ void __launch_bounds__(256)
    bs_stats_kernel(const BsParams p, float4* stats, int sq_pad, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int bh = i / sq_pad, row = i % sq_pad;
  float4 out = make_float4(INFINITY, 0.f, 0.f, 0.f);
  if (row < p.sq) {
    const float l = p.lse[(size_t)bh * p.sq + row];
    if (l != -INFINITY && bs_row_ok(p, bh / p.h, row)) out.x = l * kLog2e;
    out.z = p.di[(size_t)bh * p.sq + row];
    out.w = __uint_as_float(
        p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u);
  }
  stats[i] = out;
}

template <int D>
struct DkvLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;  // 69 KB / 100 KB
  // Three blocks to an SM at d = 64 (168 registers a thread), one at 128.
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int kKV = kTileK * D;            // elements of K or V
  static constexpr int kQ = kTileQ * D;             // of a Q or dO tile
  // K, V, the Q and dO rings (16-bit); the row stats and cell bits rings;
  // kStages + 1 mbarriers; alignment.
  static constexpr int kBytes = 2 * (2 * kKV + 2 * kStages * kQ) +
                                17 * kStages * kTileQ + 8 * (kStages + 1) +
                                1024;
};

// One block per (kv tile, head, batch). In the transposed tiles S^T and
// dP^T a thread's accumulator element [4 nb + e] is key key0 + 8 (e >> 1)
// and query nb * 8 + 2t + (e & 1) of the q tile (csrc/hopper.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kBsThreads, DkvLayout<D>::kMinBlocks)
    bs_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const BsParams p, const float4* stats, int sq_pad) {
  using L = DkvLayout<D>;
  constexpr int kStages = L::kStages;
  const int ik = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int n0 = ik * kTileK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys: +0, +8
  const int n = p.cnt[ik];

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n > 0) {
    extern __shared__ uint8_t smem_raw[];
    uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_aligned(smem_raw));
    uint16_t* v_s = k_s + L::kKV;
    uint16_t* q_s = v_s + L::kKV;  // stage s at + s * L::kQ
    uint16_t* do_s = q_s + kStages * L::kQ;
    float4* stats_s = reinterpret_cast<float4*>(do_s + kStages * L::kQ);
    uint8_t* cells_s = reinterpret_cast<uint8_t*>(stats_s + kStages * kTileQ);
    uint64_t* full = reinterpret_cast<uint64_t*>(cells_s + kStages * kTileQ);
    uint64_t* kv_full = full + kStages;
    const int* tiles = p.idx + (size_t)ik * p.max_n;  // live q tiles
    const int* fulls = p.full + (size_t)ik * p.max_n;
    const float4* stats_bh = stats + (size_t)(bb * p.h + hh) * sq_pad;
    // The rows' bits of this tile's cell column.
    const uint8_t* cells_col = p.rowmask_t + (size_t)(n0 >> 8) * sq_pad;

    // Q, dO, the row stats and the cell bits of list entry j into ring
    // stage j % kStages: the entry is the TMA box's row coordinate.
    auto load_step = [&](int j) {
      const int s = j % kStages;
      const int m0 = tiles[j] * kTileQ;
      mbar_arrive_expect_tx(&full[s], 2 * 2 * L::kQ + 17 * kTileQ);
      for (int c = 0; c < D / 64; ++c) {
        const int off = s * L::kQ + c * kTileQ * 64;
        tma_load_4d(q_s + off, &map_q, &full[s], c * 64, m0, hh, bb);
        tma_load_4d(do_s + off, &map_do, &full[s], c * 64, m0, hh, bb);
      }
      bulk_load(stats_s + s * kTileQ, stats_bh + m0, 16 * kTileQ, &full[s]);
      bulk_load(cells_s + s * kTileQ, cells_col + m0, kTileQ, &full[s]);
    };
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      mbar_init(kv_full, 1);
      mbar_fence_init();
      mbar_arrive_expect_tx(kv_full, 2 * 2 * L::kKV);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(k_s + c * kTileK * 64, &map_k, kv_full, c * 64, n0, hh, bb);
        tma_load_4d(v_s + c * kTileK * 64, &map_v, kv_full, c * 64, n0, hh, bb);
      }
      for (int j = 0; j < kStages && j < n; ++j) load_step(j);
    }
    __syncthreads();

    const bool kok[2] = {bs_key_ok(p, bb, key0), bs_key_ok(p, bb, key0 + 8)};
    const bool pad_keys = p.k_valid != nullptr;  // tested on every tile (C9)
    const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);
    const uint32_t q_base = smem_u32(q_s), do_base = smem_u32(do_s);
    mbar_wait(kv_full, 0);

    for (int j = 0; j < n; ++j) {
      const int s = j % kStages;
      const int m0 = tiles[j] * kTileQ;
      const bool full_tile = fulls[j] != 0;
      const float4* st_t = stats_s + s * kTileQ;
      const uint8_t* cells_t = cells_s + s * kTileQ;
      const uint32_t qb = opaque(q_base) + s * L::kQ * 2;
      const uint32_t dob = opaque(do_base) + s * L::kQ * 2;
      mbar_wait(&full[s], (j / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, as two groups
      // so p can start while dP^T runs.
      float st[kTileQ / 2], dpt[kTileQ / 2];
      {
        const uint32_t kb = opaque(k_base), vb = opaque(v_base);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, step = (kk % 4) * 32;
          Wgmma<T, kTileQ>::template ss<0, 0>(
              st, sw128_desc(kb + c * kTileK * 128 + step, 16, 1024),
              sw128_desc(qb + c * kTileQ * 128 + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, step = (kk % 4) * 32;
          Wgmma<T, kTileQ>::template ss<0, 0>(
              dpt, sw128_desc(vb + c * kTileK * 128 + step, 16, 1024),
              sw128_desc(dob + c * kTileQ * 128 + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      fence_regs(st);

      // st <- p (pre-dropout). The row terms are in the stats' lse; only
      // partial tiles, or any tile under key padding, test elements.
      const bool test = !full_tile || pad_keys;
#pragma unroll
      for (int nb = 0; nb < kTileQ / 8; ++nb) {
        const int ql = nb * 8 + 2 * t;
        const float lse2[2] = {st_t[ql].x, st_t[ql + 1].x};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = fast_exp2(fmaf(st[4 * nb + e], p.scale_log2, -lse2[e & 1]));
          if (test) {
            const bool vis =
                kok[e >> 1] &&
                (full_tile ||
                 (cells_t[ql + (e & 1)] != 0 &&
                  key_visible(m0 + ql + (e & 1), key0 + 8 * (e >> 1), p.sk,
                              p.causal)));
            if (!vis) pv = 0.f;
          }
          st[4 * nb + e] = pv;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // st <- dropped, rescaled p (for dV); dpt <- dS = p * (dP - di).
#pragma unroll
      for (int nb = 0; nb < kTileQ / 8; ++nb) {
        const int ql = nb * 8 + 2 * t;
        // {di, row hash} of rows ql and ql + 1.
        const float2 r0 = reinterpret_cast<const float2*>(st_t + ql)[1];
        const float2 r1 = reinterpret_cast<const float2*>(st_t + ql + 1)[1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2& r = (e & 1) ? r1 : r0;
          const float pv = st[4 * nb + e];
          float pd = pv * p.drop.rp, dpd = dpt[4 * nb + e] * p.drop.rp;
          if (p.drop.on() && !keep_elem(__float_as_uint(r.y),
                                        key0 + 8 * (e >> 1),
                                        p.drop.threshold)) {
            pd = dpd = 0.f;
          }
          st[4 * nb + e] = pd;
          dpt[4 * nb + e] = pv * (dpd - r.x);
        }
      }

      // dV += P^T dO and dK += dS^T Q: A from registers (keys x 16 queries,
      // two query n-blocks each), B read as stored.
      uint32_t pa[kTileQ / 16][4], dsa[kTileQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = Mma<T>::pack(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
          dsa[kk][i] =
              Mma<T>::pack(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
        Wgmma<T, D>::template rs<1>(
            dv, pa[kk], sw128_desc(dob + kk * 16 * 128, kTileQ * 128, 1024), 1);
        Wgmma<T, D>::template rs<1>(
            dk, dsa[kk], sw128_desc(qb + kk * 16 * 128, kTileQ * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(dsa);
      fence_regs(dv);
      fence_regs(dk);
      // Every thread is done with the stage's Q, dO and row stats.
      __syncthreads();
      if (tid == 0 && j + kStages < n) load_step(j + kStages);
    }
  }

  uint16_t* dk_out = bs_rows<uint16_t>(p, p.dk, kOpDK, bb, hh);
  uint16_t* dv_out = bs_rows<uint16_t>(p, p.dv, kOpDV, bb, hh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.sk) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_out + key * p.st[kOpDK].s + c) =
          Mma<T>::pack(dk[nb * 4 + 2 * r] * p.scale,
                       dk[nb * 4 + 2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + key * p.st[kOpDV].s + c) =
          Mma<T>::pack(dv[nb * 4 + 2 * r], dv[nb * 4 + 2 * r + 1]);
    }
  }
}

// 16 keys per block (a quarter of a kv tile); each step takes 16 rows. Thread
// (i16, j16) of the 16 x 16 grid computes score (row i16, key j16); for dK/dV
// it owns key i16 over dims j16, j16 + 16, ... (K2's fp32 path).
template <int D>
__global__ void __launch_bounds__(256) bs_dkv_f32_kernel(const BsParams p) {
  constexpr int kN = 16, kM = 16;
  constexpr int kS = D + 1;  // padded row stride: no bank conflicts
  constexpr int kPer = D / 16;
  __shared__ float k_s[kN * kS];
  __shared__ float v_s[kN * kS];
  __shared__ float q_s[kM * kS];
  __shared__ float do_s[kM * kS];
  __shared__ float p_s[kM * (kN + 1)];  // dropped, rescaled p (row, key)
  __shared__ float ds_s[kM * (kN + 1)];

  const int ik = blockIdx.x / (kTileK / kN);
  const int n0 = blockIdx.x * kN;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int i16 = threadIdx.x >> 4, j16 = threadIdx.x & 15;
  const size_t bh = (size_t)bb * p.h + hh;
  const float* k = bs_rows<float>(p, p.k, kOpK, bb, hh);
  const float* v = bs_rows<float>(p, p.v, kOpV, bb, hh);
  const float* q = bs_rows<float>(p, p.q, kOpQ, bb, hh);
  const float* dout = bs_rows<float>(p, p.dout, kOpDO, bb, hh);
  const long long qs = p.st[kOpQ].s, dos = p.st[kOpDO].s;
  const float* lse = p.lse + bh * p.sq;
  const float* di = p.di + bh * p.sq;
  for (int i = threadIdx.x; i < kN * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = n0 + r < p.sk;
    k_s[r * kS + c] = in ? k[(n0 + r) * p.st[kOpK].s + c] : 0.f;
    v_s[r * kS + c] = in ? v[(n0 + r) * p.st[kOpV].s + c] : 0.f;
  }
  float dk[kPer], dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk[i] = dv[i] = 0.f;
  const int col = n0 + j16;  // this thread's key in the score grid
  const bool kok = bs_key_ok(p, bb, col);

  const int n = p.cnt[ik];
  for (int j = 0; j < n; ++j) {
    const int tile0 = p.idx[ik * p.max_n + j] * kTileQ;
    const bool full = p.full[ik * p.max_n + j] != 0;
    for (int m0 = tile0; m0 < tile0 + kTileQ && m0 < p.sq; m0 += kM) {
      __syncthreads();
      for (int i = threadIdx.x; i < kM * D; i += blockDim.x) {
        const int r = i / D, c = i % D;
        const bool in = m0 + r < p.sq;
        q_s[r * kS + c] = in ? q[(m0 + r) * qs + c] : 0.f;
        do_s[r * kS + c] = in ? dout[(m0 + r) * dos + c] : 0.f;
      }
      __syncthreads();

      const int row = m0 + i16;
      float sc = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        sc += q_s[i16 * kS + c] * k_s[j16 * kS + c];
        dpv += do_s[i16 * kS + c] * v_s[j16 * kS + c];
      }
      float pv = 0.f, di_row = 0.f;
      if (row < p.sq) {
        const float l = lse[row];
        di_row = di[row];
        const bool cell = !full && bs_cell_on(p, row, n0);
        if (l != -INFINITY && bs_visible(p, full, cell, bs_row_ok(p, bb, row), kok, row, col)) {
          pv = exp2f(sc * p.scale_log2 - l * kLog2e);
        }
      }
      float pd = pv * p.drop.rp, dpd = dpv * p.drop.rp;
      if (p.drop.on() &&
          !keep_elem(hash_row(p.drop.seed, (uint32_t)bh, row), col, p.drop.threshold)) {
        pd = dpd = 0.f;
      }
      p_s[i16 * (kN + 1) + j16] = pd;
      ds_s[i16 * (kN + 1) + j16] = pv * (dpd - di_row);
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kM; ++r) {
        const float a = p_s[r * (kN + 1) + i16];
        const float b = ds_s[r * (kN + 1) + i16];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dv[i] += a * do_s[r * kS + j16 + 16 * i];
          dk[i] += b * q_s[r * kS + j16 + 16 * i];
        }
      }
    }
  }

  const int key = n0 + i16;
  if (key >= p.sk) return;
  float* dk_out = bs_rows<float>(p, p.dk, kOpDK, bb, hh) + key * p.st[kOpDK].s;
  float* dv_out = bs_rows<float>(p, p.dv, kOpDV, bb, hh) + key * p.st[kOpDV].s;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk_out[j16 + 16 * i] = dk[i] * p.scale;
    dv_out[j16 + 16 * i] = dv[i];
  }
}

// ------------------------------------------------------------------ K8c: dQ

template <int D>
using DqRing = KvRing<D, 2, 2>;  // 50,200 / 99,352 B  // 66,592 / 99,352 B

// One block per (q tile, head, batch), one warpgroup. Thread (warp w, lane
// 4g + t) owns rows row0 = q0 + 16w + g and row0 + 8; its accumulator
// element [4 nb + e] of S and dP is row + 8 (e >> 1), key 8 nb + 2t + (e & 1)
// of the tile, of dQ row + 8 (e >> 1), dim 8 nb + 2t + (e & 1).
template <typename T, int D>
__global__ void __launch_bounds__(kBsThreads, D == 64 ? 4 : 2)
    bs_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const BsParams p) {
  using R = DqRing<D>;
  const int iq = bs_q_tile(p), hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row0 = iq * kTileQ + warp * 16;
  const int row0 = warp_row0 + g;  // this thread's rows: row0, row0 + 8
  const int n = p.cnt[iq];
  const int* tiles = p.idx + (size_t)iq * p.max_n;  // live kv tiles
  const int* fulls = p.full + (size_t)iq * p.max_n;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n > 0) {
    extern __shared__ uint8_t smem_raw[];
    R ring(smem_raw);
    if (tid == 0) {
      ring.init();
      ring.load_resident(0, &map_q, iq * kTileQ, hh, bb);
      ring.load_resident(1, &map_do, iq * kTileQ, hh, bb);
      for (int j = 0; j < R::kStages && j < n; ++j) {
        ring.load(j, tiles[j], &map_k, &map_v, hh, bb);
      }
    }
    __syncthreads();

    // The row terms, once per row: lse in the log2 domain, +inf where the
    // row sees nothing, is padded or lies past sq (so p = exp2(s - inf) =
    // 0), di and the dropout row hash.
    const size_t bh = (size_t)bb * p.h + hh;
    float lse2[2], di_r[2];
    uint32_t rh[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float l = row < p.sq ? p.lse[bh * p.sq + row] : -INFINITY;
      lse2[r] = l == -INFINITY || !bs_row_ok(p, bb, row) ? INFINITY
                                                         : l * kLog2e;
      di_r[r] = row < p.sq ? p.di[bh * p.sq + row] : 0.f;
      rh[r] = p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u;
    }
    const bool pad = p.key_bits != nullptr;  // tested on every tile (C9)
    const uint32_t q_base = ring.res_addr(0), do_base = ring.res_addr(1);
    ring.wait_resident();

    for (int j = 0; j < n; ++j) {
      const int k0 = tiles[j] * kTileK;
      const bool full = fulls[j] != 0;
      ring.wait(j);
      const uint32_t kb = opaque(ring.k_addr(j));

      // S = Q K^T and dP = dO V^T, 64 rows x 64 keys, as two groups so p
      // can start while dP runs.
      float s[kTileK / 2], dp[kTileK / 2];
      {
        const uint32_t qb = opaque(q_base), dob = opaque(do_base);
        const uint32_t vb = opaque(ring.v_addr(j));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, step = (kk % 4) * 32;
          Wgmma<T, kTileK>::template ss<0, 0>(
              s, sw128_desc(qb + c * kTileQ * 128 + step, 16, 1024),
              sw128_desc(kb + c * kTileK * 128 + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, step = (kk % 4) * 32;
          Wgmma<T, kTileK>::template ss<0, 0>(
              dp, sw128_desc(dob + c * kTileQ * 128 + step, 16, 1024),
              sw128_desc(vb + c * kTileK * 128 + step, 16, 1024), kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      fence_regs(s);

      // s <- p (pre-dropout). A warp's 16 rows are one cell row: a dead
      // cell zeroes the tile for the whole warp, a live one leaves only the
      // per-element tests (bs_test_elements).
      const bool cell = full || bs_cell_on(p, row0, k0);
      const bool test = bs_test_elements(p, full, k0, warp_row0);
      const uint64_t kbits = pad ? bs_key_bits(p, bb, tiles[j]) : ~0ull;
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = fast_exp2(fmaf(s[4 * nb + e], p.scale_log2, -lse2[e >> 1]));
          if (test) {
            const int cl = nb * 8 + 2 * t + (e & 1);
            const bool vis = ((kbits >> cl) & 1ull) &&
                             key_visible(row0 + 8 * (e >> 1), k0 + cl, p.sk,
                                         p.causal);
            if (!vis) pv = 0.f;
          }
          s[4 * nb + e] = cell ? pv : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // s <- dS = p * (dP - di), dP dropped and rescaled.
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dpd = dp[4 * nb + e] * p.drop.rp;
          if (p.drop.on() &&
              !keep_elem(rh[e >> 1], k0 + nb * 8 + 2 * t + (e & 1),
                         p.drop.threshold)) {
            dpd = 0.f;
          }
          s[4 * nb + e] *= dpd - di_r[e >> 1];
        }
      }

      // dQ += dS K: A from registers (the C fragments of two key n-blocks
      // form one A fragment), K read as stored.
      uint32_t dsa[kTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dsa[kk][i] = Mma<T>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        }
      }
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        Wgmma<T, D>::template rs<1>(
            dq, dsa[kk], sw128_desc(kb + kk * 16 * 128, kTileK * 128, 1024),
            1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dsa);
      fence_regs(dq);
      // Every thread's products on entry j's stage are done: refill it.
      __syncthreads();
      if (tid == 0 && j + R::kStages < n) {
        ring.load(j + R::kStages, tiles[j + R::kStages], &map_k, &map_v, hh,
                  bb);
      }
    }
  }

  uint16_t* dq_out = bs_rows<uint16_t>(p, p.o, kOpO, bb, hh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dq_out + row * p.st[kOpO].s + nb * 8 +
                                   2 * t) =
          Mma<T>::pack(dq[nb * 4 + 2 * r] * p.scale,
                       dq[nb * 4 + 2 * r + 1] * p.scale);
    }
  }
}

// 16 rows per block (a quarter of a q tile); each step takes 16 keys. Thread
// (i16, j16) computes score (row i16, key j16) and owns dQ of row i16 over
// dims j16, j16 + 16, ...
template <int D>
__global__ void __launch_bounds__(256) bs_dq_f32_kernel(const BsParams p) {
  constexpr int kN = 16, kM = 16;
  constexpr int kS = D + 1;
  constexpr int kPer = D / 16;
  __shared__ float q_s[kM * kS];
  __shared__ float do_s[kM * kS];
  __shared__ float k_s[kN * kS];
  __shared__ float v_s[kN * kS];
  __shared__ float ds_s[kM * (kN + 1)];

  const int iq = blockIdx.x / (kTileQ / kM);
  const int m0 = blockIdx.x * kM;
  if (m0 >= p.sq) return;  // the whole block lies past sq
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int i16 = threadIdx.x >> 4, j16 = threadIdx.x & 15;
  const size_t bh = (size_t)bb * p.h + hh;
  const float* q = bs_rows<float>(p, p.q, kOpQ, bb, hh);
  const float* dout = bs_rows<float>(p, p.dout, kOpDO, bb, hh);
  const float* k = bs_rows<float>(p, p.k, kOpK, bb, hh);
  const float* v = bs_rows<float>(p, p.v, kOpV, bb, hh);
  const long long ks = p.st[kOpK].s, vs = p.st[kOpV].s;
  for (int i = threadIdx.x; i < kM * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = m0 + r < p.sq;
    q_s[r * kS + c] = in ? q[(m0 + r) * p.st[kOpQ].s + c] : 0.f;
    do_s[r * kS + c] = in ? dout[(m0 + r) * p.st[kOpDO].s + c] : 0.f;
  }
  const int row = m0 + i16;
  const bool rok = bs_row_ok(p, bb, row);
  const float l = row < p.sq ? p.lse[bh * p.sq + row] : -INFINITY;
  const float di_row = row < p.sq ? p.di[bh * p.sq + row] : 0.f;
  const uint32_t rh = p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const int n = p.cnt[iq];
  for (int j = 0; j < n; ++j) {
    const int tile0 = p.idx[iq * p.max_n + j] * kTileK;
    const bool full = p.full[iq * p.max_n + j] != 0;
    const bool cell = !full && bs_cell_on(p, row, tile0);
    for (int k0 = tile0; k0 < tile0 + kTileK && k0 < p.sk; k0 += kN) {
      __syncthreads();
      for (int i = threadIdx.x; i < kN * D; i += blockDim.x) {
        const int r = i / D, c = i % D;
        const bool in = k0 + r < p.sk;
        k_s[r * kS + c] = in ? k[(k0 + r) * ks + c] : 0.f;
        v_s[r * kS + c] = in ? v[(k0 + r) * vs + c] : 0.f;
      }
      __syncthreads();

      const int col = k0 + j16;
      float sc = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        sc += q_s[i16 * kS + c] * k_s[j16 * kS + c];
        dpv += do_s[i16 * kS + c] * v_s[j16 * kS + c];
      }
      float pv = 0.f;
      if (l != -INFINITY && bs_visible(p, full, cell, rok, bs_key_ok(p, bb, col), row, col)) {
        pv = exp2f(sc * p.scale_log2 - l * kLog2e);
      }
      float dpd = dpv * p.drop.rp;
      if (p.drop.on() && !keep_elem(rh, col, p.drop.threshold)) dpd = 0.f;
      ds_s[i16 * (kN + 1) + j16] = pv * (dpd - di_row);
      __syncthreads();

#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float a = 0.f;
#pragma unroll
        for (int jj = 0; jj < kN; ++jj) a += ds_s[i16 * (kN + 1) + jj] * k_s[jj * kS + j16 + 16 * i];
        acc[i] += a;
      }
    }
  }

  if (row >= p.sq) return;
  float* dq = bs_rows<float>(p, p.o, kOpO, bb, hh) + row * p.st[kOpO].s;
#pragma unroll
  for (int i = 0; i < kPer; ++i) dq[j16 + 16 * i] = acc[i] * p.scale;
}

template <typename T, int D>
cudaError_t launch_dkv_wgmma(const BsParams& p, float4* stats, int b,
                             cudaStream_t st) {
  using L = DkvLayout<D>;
  const int sq_pad = (p.sq + kTileQ - 1) / kTileQ * kTileQ;
  const int rows = b * p.h * sq_pad;
  bs_stats_kernel<<<(rows + 255) / 256, 256, 0, st>>>(p, stats, sq_pad, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v, map_do;
  err = bs_map(&map_q, p, kOpQ, b, D);
  if (err == cudaSuccess) err = bs_map(&map_do, p, kOpDO, b, D);
  if (err == cudaSuccess) err = bs_map(&map_k, p, kOpK, b, D);
  if (err == cudaSuccess) err = bs_map(&map_v, p, kOpV, b, D);
  if (err != cudaSuccess) return err;
  const auto kernel = bs_dkv_wgmma_kernel<T, D>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((p.sk + kTileK - 1) / kTileK, p.h, b), kBsThreads, L::kBytes,
           st>>>(map_q, map_k, map_v, map_do, p, stats, sq_pad);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BsParams& p, float4* stats, int dtype, int b,
                       cudaStream_t st) {
  const int nk = (p.sk + kTileK - 1) / kTileK;
  switch (dtype) {
    case kBF16:
      return launch_dkv_wgmma<__nv_bfloat16, D>(p, stats, b, st);
    case kF16:
      return launch_dkv_wgmma<__half, D>(p, stats, b, st);
    case kF32:
      bs_dkv_f32_kernel<D><<<dim3(nk * (kTileK / 16), p.h, b), 256, 0, st>>>(p);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const BsParams& p, int b, cudaStream_t st) {
  using R = DqRing<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err = bs_map(&map_q, p, kOpQ, b, D);
  if (err == cudaSuccess) err = bs_map(&map_do, p, kOpDO, b, D);
  if (err == cudaSuccess) err = bs_map(&map_k, p, kOpK, b, D);
  if (err == cudaSuccess) err = bs_map(&map_v, p, kOpV, b, D);
  if (err != cudaSuccess) return err;
  const auto kernel = bs_dq_wgmma_kernel<T, D>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((p.sq + kTileQ - 1) / kTileQ, p.h, b), kBsThreads, R::kBytes,
           st>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BsParams& p, int dtype, int b, cudaStream_t st) {
  const int nq = (p.sq + kTileQ - 1) / kTileQ;
  switch (dtype) {
    case kBF16:
      return launch_dq_wgmma<__nv_bfloat16, D>(p, b, st);
    case kF16:
      return launch_dq_wgmma<__half, D>(p, b, st);
    case kF32:
      bs_dq_f32_kernel<D><<<dim3(nq * (kTileQ / 16), p.h, b), 256, 0, st>>>(p);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

BsParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, const long long* strides,
                    const void* idx, const void* cnt,
                    const void* full, const void* rowmask, const void* q_valid,
                    const void* k_valid, int h, int sq, int sk, int max_n, int ncells,
                    float scale, int causal, unsigned seed, unsigned threshold, float rp) {
  BsParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.idx = static_cast<const int*>(idx);
  p.cnt = static_cast<const int*>(cnt);
  p.full = static_cast<const int*>(full);
  p.rowmask = static_cast<const uint8_t*>(rowmask);
  p.q_valid = static_cast<const uint8_t*>(q_valid);
  p.k_valid = static_cast<const uint8_t*>(k_valid);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.max_n = max_n;
  p.ncells = ncells;
  p.scale_log2 = scale * kLog2e;
  p.scale = scale;
  p.causal = causal != 0;
  p.drop = Dropout{seed, threshold, rp};
  set_strides(p.st, strides);
  return p;
}

bool bad_sizes(int b, int h, int sq, int sk, int max_n, int ncells) {
  return b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || max_n <= 0 || ncells <= 0;
}

}  // namespace
}  // namespace fattn

// K8b. q_idx, q_cnt, q_full: the layout's per-kv-tile lists of q tiles;
// rowmask_t: the rowmask transposed, (ncells, sq_pad); strides as in
// fattn_blocksparse_fwd (that of o unused). stats: scratch
// the wrapper allocates for bf16 / fp16, fp32 (b, h, sq_pad, 4) with sq_pad
// = sq rounded up to 64 (unused for fp32).
extern "C" int fattn_blocksparse_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, void* stats,
    const long long* strides, const void* q_idx,
    const void* q_cnt, const void* q_full, const void* rowmask,
    const void* rowmask_t, const void* q_valid, const void* k_valid, int b,
    int h, int sq, int sk, int d, int max_q, int ncells, float scale,
    int causal, unsigned seed, unsigned threshold, float rp, int dtype,
    void* stream) {
  using namespace fattn;
  if (bad_sizes(b, h, sq, sk, max_q, ncells)) return cudaErrorInvalidValue;
  BsParams p = bwd_params(q, k, v, dout, lse, di, strides, q_idx, q_cnt, q_full, rowmask,
                          q_valid, k_valid, h, sq, sk, max_q, ncells, scale,
                          causal, seed, threshold, rp);
  p.rowmask_t = static_cast<const uint8_t*>(rowmask_t);
  p.dk = dk;
  p.dv = dv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* s4 = static_cast<float4*>(stats);
  if (d == 64) return launch_dkv<64>(p, s4, dtype, b, st);
  if (d == 128) return launch_dkv<128>(p, s4, dtype, b, st);
  return cudaErrorInvalidValue;
}

// K8c. kv_idx, kv_cnt, kv_full: the layout's per-q-tile lists of kv tiles;
// key_bits and strides as in fattn_blocksparse_fwd (o: dq; those of dk, dv
// unused).
extern "C" int fattn_blocksparse_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const long long* strides,
    const void* kv_idx,
    const void* kv_cnt, const void* kv_full, const void* rowmask,
    const void* q_valid, const void* k_valid, const void* key_bits, int b,
    int h, int sq, int sk, int d, int max_kv, int ncells, float scale,
    int causal, unsigned seed, unsigned threshold, float rp, int dtype,
    void* stream) {
  using namespace fattn;
  if (bad_sizes(b, h, sq, sk, max_kv, ncells)) return cudaErrorInvalidValue;
  BsParams p = bwd_params(q, k, v, dout, lse, di, strides, kv_idx, kv_cnt, kv_full,
                          rowmask, q_valid, k_valid, h, sq, sk, max_kv, ncells,
                          scale, causal, seed, threshold, rp);
  p.o = dq;
  p.key_bits = static_cast<const uint64_t*>(key_bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(p, dtype, b, st);
  if (d == 128) return launch_dq<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of K8b's bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_blocksparse_dkv_smem(int d) {
  using namespace fattn;
  return d == 64 ? DkvLayout<64>::kBytes : d == 128 ? DkvLayout<128>::kBytes : 0;
}

// Dynamic shared memory of K8c's bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_blocksparse_dq_smem(int d) {
  using namespace fattn;
  return d == 64 ? DqRing<64>::kBytes : d == 128 ? DqRing<128>::kBytes : 0;
}
