// Flash-attention backward for Hopper (sm_90a): K2.
//
// Replaces the Pallas kernel flash_attn_tpu/kernels/flash_bwd.py:_fused_kernel
// (launched by flash_attention_bwd there). From q, k, v, dout, the forward's
// lse and di = rowsum(dout * out) - dlse it rebuilds the probabilities
// p = exp(scale * q.k - lse) tile by tile, so neither p nor ds ever reaches
// device memory, and produces
//   dV = (keep * p / (1 - p_drop))^T dO
//   dP = keep * (dO V^T) / (1 - p_drop)
//   dS = p * (dP - di)          (the pre-dropout p)
//   dK = scale * dS^T Q,   dQ = scale * dS K.
// The dropout mask is regenerated from csrc/prng.cuh with the QUERY head in
// bh = b * h + head, as the forward made it; the mask is csrc/mask.cuh.
//
// Layout: q, dout, out, dq (b, h, sq, d); k, v, dk, dv (b, h_kv, sk, d); each
// through its own strides (csrc/common.cuh Strides); lse and dlse (b, h, sq)
// fp32 contiguous. Causal masking is top-left aligned.
//
// Design (FA2's K/V-stationary order): one block per (128-key tile, kv head,
// batch) walks every query tile of every query head in its GQA group,
// holding dK and dV for its keys in registers, so dK/dV are summed over the
// group in fp32 inside the kernel (no per-query-head copies to reduce
// afterwards, as the JAX package does at flash_bwd.py:481-487). dQ gets a
// contribution from every key tile: it accumulates in fp32 into a (b, h,
// sq, d) buffer that the entry point zeroes, and a last pass scales and
// casts it into dq.
// Deterministic dQ: the additions into that buffer happen in a fixed
// order, so dq is bitwise reproducible from run to run, as dk and dv are.
// Each (b, query head, 16-row slice) has an int32 turn counter, zeroed with
// the buffer; a contributor waits until the counter equals its rank among
// the key tiles that touch the slice, adds, waits until its addition has
// completed (not just read shared memory), publishes it and increments the
// counter (csrc/hopper.cuh wait_turn / pass_turn). The bf16/fp16 kernel
// takes turns per warpgroup and 64-row tile, on the counter of the tile's
// first slice (a turn per warp measured 3-12% slower, PERF.md), and the
// waits overlap the tensor cores: one thread polls the turn while the dQ
// product runs, and the warpgroup completes the addition and passes the
// turn on while the next step's first products run. Ranks follow blockIdx.x,
// and the hardware dispatches blocks in blockIdx order, so a rank only ever
// waits for blocks that are resident or done (FA3's deterministic backward
// relies on the same fact). Every block walks its query tiles upwards from
// its first visible row, heads innermost. Under causal masking key tile kt
// starts at query tile kt, so the last key tiles reach a slice first:
// blockIdx.x runs over the key tiles from the last one down (the lightest
// blocks launch first) and a slice's ranks count from the first block that
// reaches it, so the additions come in the order the walks arrive and a
// rank rarely waits.
// Bound: tensor-core math at training sizes (5 products per tile, 10 d
// flops per visible pair).
//   - bf16 / fp16 (flash_bwd_wgmma_kernel): two warpgroups. K and V are
//     loaded once; 64-row Q and dO tiles and their row stats (lse in the
//     log2 domain, di, dropout row hash: one 1 KB record per tile, written
//     by bwd_stats_kernel) stream by TMA through a ring of 3 (d = 64) or 2
//     (d = 128) stages in dynamic shared memory, refilled by the warpgroup that releases a stage second
//     (csrc/hopper.cuh). Warpgroup w owns keys [64 w, 64 w + 64) of the
//     tile (rank 2 order + w): S^T = K Q^T and dP^T = V dO^T by wgmma
//     m64n64k16 from shared
//     memory, in two groups so p is computed while dP^T runs; dS in
//     registers (only tiles crossing the causal diagonal or sk's edge test
//     elements); dV += P^T dO and dK += dS^T Q by register-A wgmma reading
//     dO and Q as stored (transpose bit); dS^T through shared memory once,
//     swizzled, for its dQ contribution dS K by wgmma with both operands
//     transposed; each warp stages its 16 rows of that fp32 tile in shared
//     memory and, on the warpgroup's turn, adds them to dq_acc with one
//     cp.reduce.async.bulk per row (no element atomics). Summing the two
//     warpgroups' tiles in shared memory first halves that traffic but
//     couples the warpgroups every step, and measured slower (PERF.md).
//   - fp32 (flash_bwd_f32_kernel): 16 keys x 16 queries per step, FMA on
//     the CUDA cores; dQ by fp32 atomicAdd, one block at a time per slice
//     (rank: the block's order).
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mask.cuh"
#include "mma.cuh"
#include "prng.cuh"

namespace fattn {
namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  // Per query row, (b, h, sq_pad) contiguous: {lse * log2(e) (+inf where
  // lse = -inf or past sq: p = 0), di, dropout row hash bits, 0}.
  const float4* stats;
  float* dq_acc;  // (b, h, sq, d) fp32 contiguous, zero on entry
  int* dq_turn;   // (b, h, n16) turn counters of dq_acc's 16-row slices, 0
  void* dk;
  void* dv;
  int h, h_kv, sq, sk;
  int sq_pad;  // sq rounded up to kStatRows
  int n16;     // 16-row slices of sq: (sq + 15) / 16
  float scale_log2;
  float scale;
  bool causal;
  Dropout drop;
  Strides st[kNumOps];  // q, k, v, o, dout, dk, dv, dq
};

constexpr int kStatRows = 64;  // the stats rows are padded to this

// The key tile of this block: under causal masking the last (lightest)
// key tiles launch first (see the header).
__device__ __forceinline__ int key_tile(bool causal) {
  return causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// This block's place among the blocks that add into dQ rows [m0, m0 + 16):
// blocks count in launch order from the first one whose keys reach those
// rows (under causal masking key tile kt reaches rows kt * keys_per_block
// on).
__device__ __forceinline__ int dq_order(int m0, int keys_per_block,
                                        bool causal) {
  const int last = gridDim.x - 1;
  return blockIdx.x - (causal ? last - min(last, m0 / keys_per_block) : 0);
}

// The row stats, one warp per row of (b, h, sq_pad): di = rowsum(o * dout)
// - dlse (flash_bwd.py:497-506), the lse in the log2 domain and the dropout
// row hash, so a tile's rows reach shared memory as one bulk copy.
template <typename T, int D>
__global__ void __launch_bounds__(128)
    bwd_stats_kernel(const T* o, const T* dout, const float* lse,
                     const float* dlse, float4* stats, Strides so,
                     Strides sdo, int h, int sq, int sq_pad, int rows,
                     Dropout drop) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / sq_pad, i = row % sq_pad;
  float4 out = make_float4(INFINITY, 0.f, 0.f, 0.f);  // padding: p = 0
  if (i < sq) {
    const T* o_r = head_rows(o, so, bh / h, bh % h) + i * so.s;
    const T* do_r = head_rows(dout, sdo, bh / h, bh % h) + i * sdo.s;
    float acc = 0.f;
#pragma unroll
    for (int c = lane; c < D; c += 32) {
      acc += to_float(o_r[c]) * to_float(do_r[c]);
    }
    acc = warp_sum(acc);
    const size_t r = (size_t)bh * sq + i;
    const float l = lse[r];
    // exp2(x - inf) = 0: rows with no visible key (lse = -inf) give p = 0.
    out.x = l == -INFINITY ? INFINITY : l * kLog2e;
    out.y = acc - (dlse != nullptr ? dlse[r] : 0.f);
    out.z = __uint_as_float(drop.on() ? hash_row(drop.seed, bh, i) : 0u);
  }
  if (lane == 0) stats[row] = out;
}

// dq = scale * dq_acc in the output dtype, four columns per thread.
template <typename T, int D>
__global__ void bwd_dq_kernel(const float* acc, T* dq, Strides sdq, int h,
                              int sq, size_t n4, float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / (D / 4);
    const int c = (int)(i % (D / 4)) * 4;
    const int bb = (int)(row / ((size_t)h * sq)), hh = (int)(row / sq % h);
    const int r = (int)(row % sq);
    const float4 a = reinterpret_cast<const float4*>(acc)[i];
    T* dst = head_rows(dq, sdq, bb, hh) + r * sdq.s + c;
    dst[0] = from_float<T>(a.x * scale);
    dst[1] = from_float<T>(a.y * scale);
    dst[2] = from_float<T>(a.z * scale);
    dst[3] = from_float<T>(a.w * scale);
  }
}

// ---------------------------------------------------------------- wgmma path

constexpr int kBwdN = 128;       // keys per block, 64 per consumer warpgroup
constexpr int kBwdM = 64;        // query rows per ring stage
constexpr int kThreads = 256;    // two warpgroups of 64 keys each

template <int D>
struct BwdLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;  // 138 KB / 220 KB
  static constexpr int kKV = kBwdN * D;        // elements of K or V
  static constexpr int kQ = kBwdM * D;         // elements of a Q or dO tile
  static constexpr int kDS = kBwdN * kBwdM;    // dS^T, keys x queries
  static constexpr int kDQStride = D + 8;      // floats per dQ staging row
  static constexpr int kDQ = 2 * kBwdM * kDQStride;  // one per warpgroup
  // K, V, the Q and dO rings, dS^T (16-bit); dQ staging (fp32); the row
  // stats ring; kStages + 1 mbarriers, kStages release counts; alignment.
  static constexpr int kBytes = 2 * (2 * kKV + 2 * kStages * kQ + kDS) +
                                4 * kDQ + 16 * kStages * kBwdM +
                                12 * (kStages + 1) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const BwdParams p) {
  using L = BwdLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem_aligned(smem_raw));
  uint16_t* v_s = k_s + L::kKV;
  uint16_t* q_s = v_s + L::kKV;  // stage s at + s * L::kQ
  uint16_t* do_s = q_s + kStages * L::kQ;
  uint16_t* ds_s = do_s + kStages * L::kQ;
  float* dq_s = reinterpret_cast<float*>(ds_s + L::kDS);
  float4* stats_s = reinterpret_cast<float4*>(dq_s + L::kDQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats_s + kStages * kBwdM);
  uint64_t* kv_full = full + kStages;
  uint32_t* released = reinterpret_cast<uint32_t*>(kv_full + 1);

  const int n0 = key_tile(p.causal) * kBwdN;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = p.h / p.h_kv;
  const int m_begin = first_row_for_keys(n0, p.causal) / kBwdM * kBwdM;
  // The walk, heads innermost: step it is query head hk * group + it %
  // group, rows m_begin + (it / group) * kBwdM on.
  const int n_m = m_begin < p.sq ? (p.sq - m_begin + kBwdM - 1) / kBwdM : 0;
  const int n_steps = group * n_m;

  // Q, dO and the row stats of step `it` into ring stage it % kStages.
  auto load_step = [&](int it) {
    const int s = it % kStages;
    const int hq = hk * group + it % group;
    const int m0 = m_begin + (it / group) * kBwdM;
    mbar_arrive_expect_tx(&full[s], 2 * 2 * L::kQ + 16 * kBwdM);
    for (int c = 0; c < D / 64; ++c) {
      const int off = s * L::kQ + c * kBwdM * 64;
      tma_load_4d(q_s + off, &map_q, &full[s], c * 64, m0, hq, bb);
      tma_load_4d(do_s + off, &map_do, &full[s], c * 64, m0, hq, bb);
    }
    bulk_load(stats_s + s * kBwdM,
              p.stats + (size_t)(bb * p.h + hq) * p.sq_pad + m0, 16 * kBwdM,
              &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0u;
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(kv_full, 2 * 2 * L::kKV);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(k_s + c * kBwdN * 64, &map_k, kv_full, c * 64, n0, hk, bb);
      tma_load_4d(v_s + c * kBwdN * 64, &map_v, kv_full, c * 64, n0, hk, bb);
    }
    for (int it = 0; it < kStages && it < n_steps; ++it) load_step(it);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = n0 + wg * 64;          // this warpgroup's 64 keys
  const int key0 = kw0 + warp * 16 + g;  // this thread's keys: +0, +8
  // Shared byte addresses: this warpgroup's rows of K, V and dS^T, the Q
  // and dO rings.
  const uint32_t k_base = smem_u32(k_s + wg * 64 * 64);
  const uint32_t v_base = smem_u32(v_s + wg * 64 * 64);
  const uint32_t ds_base = smem_u32(ds_s + wg * 64 * kBwdM);
  const uint32_t q_base = smem_u32(q_s), do_base = smem_u32(do_s);
  uint8_t* ds_wg = reinterpret_cast<uint8_t*>(ds_s + wg * 64 * kBwdM);
  // dQ rows [16 warp, 16 warp + 16) of a tile are this warp's alone: it
  // stages them and its lanes 0-15 reduce one row each.
  float* dq_w = dq_s + (wg * kBwdM + warp * 16) * L::kDQStride;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  // The warpgroup's dQ addition of the last step, until it has completed
  // and its turn is passed on (nullptr: none).
  int* pending = nullptr;
  auto finish_pending = [&]() {
    if (pending == nullptr) return;
    if (lane < 16) {
      bulk_wait();  // the addition is done in global memory
      fence_proxy_async_global();
    }
    named_barrier(1 + wg, 128);
    if (tid == 0) pass_turn(pending);
    pending = nullptr;
  };

  for (int it = 0; it < n_steps; ++it) {
    const int hq = hk * group + it % group;
    const int m0 = m_begin + (it / group) * kBwdM;
    float* dq_acc = p.dq_acc + (size_t)(bb * p.h + hq) * p.sq * D;
    const int s = it % kStages;
    const float4* st_t = stats_s + s * kBwdM;
    const uint32_t qb = opaque(q_base) + s * L::kQ * 2;
    const uint32_t dob = opaque(do_base) + s * L::kQ * 2;
    mbar_wait(&full[s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, as two groups
    // so p can start while dP^T runs. Element [4 nb + e] is key
    // key0 + 8 (e >> 1), query nb * 8 + 2t + (e & 1) of the tile.
    float st[kBwdM / 2], dpt[kBwdM / 2];
    {
      const uint32_t kb = opaque(k_base), vb = opaque(v_base);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, step = (kk % 4) * 32;
        Wgmma<T, kBwdM>::template ss<0, 0>(
            st, sw128_desc(kb + c * kBwdN * 128 + step, 16, 1024),
            sw128_desc(qb + c * kBwdM * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, step = (kk % 4) * 32;
        Wgmma<T, kBwdM>::template ss<0, 0>(
            dpt, sw128_desc(vb + c * kBwdN * 128 + step, 16, 1024),
            sw128_desc(dob + c * kBwdM * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
    }
    // The last step's addition completes while the products run.
    finish_pending();
    wgmma_wait<1>();
    fence_regs(st);

    // st <- p (pre-dropout); only tiles crossing the causal diagonal or
    // sk's edge test elements. Row stats come in pairs of queries.
    const bool edge = kw0 + 64 > p.sk || (p.causal && kw0 + 63 > m0);
#pragma unroll
    for (int nb = 0; nb < kBwdM / 8; ++nb) {
      const int ql = nb * 8 + 2 * t;
      const float lse2[2] = {st_t[ql].x, st_t[ql + 1].x};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = lse2[e & 1];
        float pv = fast_exp2(fmaf(st[4 * nb + e], p.scale_log2, -l2));
        if (edge && !key_visible(m0 + ql + (e & 1), key0 + 8 * (e >> 1),
                                 p.sk, p.causal)) {
          pv = 0.f;
        }
        st[4 * nb + e] = pv;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    // st <- dropped, rescaled p (for dV); dpt <- dS = p * (dP - di).
#pragma unroll
    for (int nb = 0; nb < kBwdM / 8; ++nb) {
      const int ql = nb * 8 + 2 * t;
      const float4 r0 = st_t[ql], r1 = st_t[ql + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4& r = (e & 1) ? r1 : r0;
        const float pv = st[4 * nb + e];
        float pd = pv * p.drop.rp, dpd = dpt[4 * nb + e] * p.drop.rp;
        if (p.drop.on() && !keep_elem(__float_as_uint(r.z),
                                      key0 + 8 * (e >> 1),
                                      p.drop.threshold)) {
          pd = dpd = 0.f;
        }
        st[4 * nb + e] = pd;
        dpt[4 * nb + e] = pv * (dpd - r.y);
      }
    }

    // A fragments (keys x 16 queries) from two query n-blocks each.
    uint32_t pa[kBwdM / 16][4], dsa[kBwdM / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kk][j] = Mma<T>::pack(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1]);
        dsa[kk][j] =
            Mma<T>::pack(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1]);
      }
    }
    // dS^T to shared memory, [key][query] rows of 128 bytes with the
    // 128-byte swizzle: the A operand of dQ = dS K, read transposed.
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = warp * 16 + g + 8 * (j & 1);  // key within the 64
        const int nb = 2 * kk + (j >> 1);           // query chunk
        *reinterpret_cast<uint32_t*>(
            ds_wg + kl * 128 + ((nb ^ (kl & 7)) << 4) + 4 * t) = dsa[kk][j];
      }
    }
    fence_proxy_async();

    // dV += P^T dO and dK += dS^T Q: A from registers, B read as stored.
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdM / 16; ++kk) {
      Wgmma<T, D>::template rs<1>(
          dv, pa[kk], sw128_desc(dob + kk * 16 * 128, kBwdM * 128, 1024), 1);
      Wgmma<T, D>::template rs<1>(
          dk, dsa[kk], sw128_desc(qb + kk * 16 * 128, kBwdM * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dv);
    fence_regs(dk);
    // Every warp's dS^T rows are in place, and the warpgroup is done with
    // the stage's Q, dO and row stats.
    named_barrier(1 + wg, 128);
    if (tid == 0 && stage_released_by_both(&released[s]) &&
        it + kStages < n_steps) {
      load_step(it + kStages);
    }

    // dQ (64 queries x d) = dS K over this warpgroup's 64 keys; the
    // warpgroup's turn for the tile (rank 2 order + wg) is awaited while
    // the product runs.
    float dqa[D / 2];
    {
      const uint32_t dsb = opaque(ds_base), kb = opaque(k_base);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        Wgmma<T, D>::template ss<1, 1>(
            dqa, sw128_desc(dsb + kk * 16 * 128, 64 * 128, 1024),
            sw128_desc(kb + kk * 16 * 128, kBwdN * 128, 1024), kk > 0);
      }
      wgmma_commit();
    }
    int* turn = p.dq_turn + (size_t)(bb * p.h + hq) * p.n16 + m0 / 16;
    if (tid == 0) wait_turn(turn, 2 * dq_order(m0, kBwdN, p.causal) + wg);
    named_barrier(1 + wg, 128);
    wgmma_wait<0>();
    fence_regs(dqa);

    // This warp's 16 rows through shared memory to dq_acc, one bulk
    // reduce-add per row; the last step's addition has completed, so the
    // staging rows are free. It completes, and the turn passes on, during
    // the next step's first products.
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = g + 8 * ((i >> 1) & 1);
      const int col = (i / 4) * 8 + 2 * t;
      *reinterpret_cast<float2*>(dq_w + row * L::kDQStride + col) =
          make_float2(dqa[i], dqa[i + 1]);
    }
    fence_proxy_async();
    __syncwarp();
    const int dq_row = m0 + warp * 16 + lane;
    if (lane < 16 && dq_row < p.sq) {
      fence_proxy_async_global();
      bulk_reduce_add_f32(dq_acc + (size_t)dq_row * D,
                          dq_w + lane * L::kDQStride, D * 4);
      bulk_commit();
    }
    pending = turn;
  }
  finish_pending();

  uint16_t* dk_out = head_rows(static_cast<uint16_t*>(p.dk), p.st[kOpDK], bb, hk);
  uint16_t* dv_out = head_rows(static_cast<uint16_t*>(p.dv), p.st[kOpDV], bb, hk);
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

// --------------------------------------------------------------- fp32 path

// 16 keys per block; each step takes 16 queries. Thread (i, j) of the
// 16 x 16 grid computes score (query i, key j); for dK/dV thread i owns key i
// and for dQ query i, each over dims j, j + 16, ... of the head.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_f32_kernel(const BwdParams p) {
  constexpr int kN = 16, kM = 16;
  constexpr int kS = D + 1;  // padded row stride: no bank conflicts
  constexpr int kPer = D / 16;
  __shared__ float k_s[kN * kS];
  __shared__ float v_s[kN * kS];
  __shared__ float q_s[kM * kS];
  __shared__ float do_s[kM * kS];
  __shared__ float p_s[kM * (kN + 1)];  // dropped, rescaled p (query, key)
  __shared__ float ds_s[kM * (kN + 1)];

  const int n0 = key_tile(p.causal) * kN;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = p.h / p.h_kv;
  const int i16 = threadIdx.x >> 4, j16 = threadIdx.x & 15;

  const float* k =
      head_rows(static_cast<const float*>(p.k), p.st[kOpK], bb, hk);
  const float* v =
      head_rows(static_cast<const float*>(p.v), p.st[kOpV], bb, hk);
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
  const int m_begin = first_row_for_keys(n0, p.causal) / kM * kM;
  // Heads innermost, as the wgmma path.
  const int n_m = m_begin < p.sq ? (p.sq - m_begin + kM - 1) / kM : 0;
  for (int it = 0; it < group * n_m; ++it) {
    const int hq = hk * group + it % group;
    const int m0 = m_begin + (it / group) * kM;
    const uint32_t bh = bb * p.h + hq;
    const float* q =
        head_rows(static_cast<const float*>(p.q), p.st[kOpQ], bb, hq);
    const float* dout =
        head_rows(static_cast<const float*>(p.dout), p.st[kOpDO], bb, hq);
    const long long qs = p.st[kOpQ].s, dos = p.st[kOpDO].s;
    const float4* stats = p.stats + (size_t)bh * p.sq_pad;
    float* dq = p.dq_acc + (size_t)bh * p.sq * D;
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
      const float4 st4 = stats[row];  // lse2 = +inf where lse = -inf
      di_row = st4.y;
      if (key_visible(row, col, p.sk, p.causal)) {
        pv = exp2f(sc * p.scale_log2 - st4.x);
      }
    }
    float pd = pv * p.drop.rp, dpd = dpv * p.drop.rp;
    if (p.drop.on() &&
        !keep_elem(hash_row(p.drop.seed, bh, row), col, p.drop.threshold)) {
      pd = dpd = 0.f;
    }
    p_s[i16 * (kN + 1) + j16] = pd;
    ds_s[i16 * (kN + 1) + j16] = pv * (dpd - di_row);
    __syncthreads();

    // dV, dK for key i16; dQ for query i16.
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
    float dqa[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        a += ds_s[i16 * (kN + 1) + j] * k_s[j * kS + j16 + 16 * i];
      }
      dqa[i] = a;
    }
    // dQ on this block's turn for the slice.
    int* turn = p.dq_turn + (size_t)bh * p.n16 + m0 / 16;
    if (threadIdx.x == 0) wait_turn(turn, dq_order(m0, kN, p.causal));
    __syncthreads();
    if (m0 + i16 < p.sq) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        atomicAdd(dq + (size_t)(m0 + i16) * D + j16 + 16 * i, dqa[i]);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) pass_turn(turn);
  }

  const int key = n0 + i16;
  if (key >= p.sk) return;
  float* dk_out = head_rows(static_cast<float*>(p.dk), p.st[kOpDK], bb, hk) +
                  key * p.st[kOpDK].s;
  float* dv_out = head_rows(static_cast<float*>(p.dv), p.st[kOpDV], bb, hk) +
                  key * p.st[kOpDV].s;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk_out[j16 + 16 * i] = dk[i] * p.scale;
    dv_out[j16 + 16 * i] = dv[i];
  }
}

template <typename T, int D>
cudaError_t launch_wgmma(const BwdParams& p, int b, cudaStream_t st) {
  using L = BwdLayout<D>;
  CUtensorMap map_q, map_k, map_v, map_do;
  cudaError_t err =
      make_tile_map(&map_q, p.q, b, p.h, p.sq, D, p.st[kOpQ], kBwdM);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_do, p.dout, b, p.h, p.sq, D, p.st[kOpDO], kBwdM);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_k, p.k, b, p.h_kv, p.sk, D, p.st[kOpK], kBwdN);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v, b, p.h_kv, p.sk, D, p.st[kOpV], kBwdN);
  }
  if (err != cudaSuccess) return err;
  const auto kernel = flash_bwd_wgmma_kernel<T, D>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((p.sk + kBwdN - 1) / kBwdN, p.h_kv, b), kThreads, L::kBytes,
           st>>>(map_q, map_k, map_v, map_do, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_typed(const BwdParams& p, const void* o, const float* lse,
                         const float* dlse, void* dq, int b,
                         cudaStream_t st) {
  const int stat_rows = b * p.h * p.sq_pad;
  bwd_stats_kernel<T, D><<<(stat_rows + 3) / 4, 128, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(p.dout), lse, dlse,
      const_cast<float4*>(p.stats), p.st[kOpO], p.st[kOpDO], p.h, p.sq,
      p.sq_pad, stat_rows, p.drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) {
    flash_bwd_f32_kernel<D>
        <<<dim3((p.sk + 15) / 16, p.h_kv, b), 256, 0, st>>>(p);
    err = cudaGetLastError();
  } else {
    err = launch_wgmma<T, D>(p, b, st);
  }
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)b * p.h * p.sq * D / 4;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  bwd_dq_kernel<T, D><<<blocks, 256, 0, st>>>(
      p.dq_acc, static_cast<T*>(dq), p.st[kOpDQ], p.h, p.sq, n4, p.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const BwdParams& p, const void* o, const float* lse,
                   const float* dlse, void* dq, int dtype, int b,
                   cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      return launch_typed<__nv_bfloat16, D>(p, o, lse, dlse, dq, b, st);
    case kF16:
      return launch_typed<__half, D>(p, o, lse, dlse, dq, b, st);
    case kF32:
      return launch_typed<float, D>(p, o, lse, dlse, dq, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fattn

// stats and dq_acc are scratch the wrapper allocates, contiguous: fp32
// (b, h, sq_pad, 4) with sq_pad = sq rounded up to 64, and (b, h, sq, d)
// fp32 followed by (b, h, (sq + 15) / 16) int32 turn counters. dq_acc is
// zeroed here, counters included, on the stream, every call. strides: (batch, head,
// row) element strides of every Operand (csrc/common.cuh).
extern "C" int fattn_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* dlse, void* stats,
                               void* dq_acc, void* dq, void* dk, void* dv,
                               const long long* strides, int b, int h,
                               int h_kv, int sq, int sk, int d, float scale,
                               int causal, unsigned seed, unsigned threshold,
                               float rp, int dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || sq <= 0 || sk <= 0 ||
      !(scale > 0.f)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t acc = (size_t)b * h * sq * d;
  const int n16 = (sq + 15) / 16;
  const cudaError_t err = cudaMemsetAsync(
      dq_acc, 0, (acc + (size_t)b * h * n16) * sizeof(float), st);
  if (err != cudaSuccess) return err;
  BwdParams p{q,
              k,
              v,
              dout,
              static_cast<const float4*>(stats),
              static_cast<float*>(dq_acc),
              reinterpret_cast<int*>(static_cast<float*>(dq_acc) + acc),
              dk,
              dv,
              h,
              h_kv,
              sq,
              sk,
              (sq + kStatRows - 1) / kStatRows * kStatRows,
              n16,
              scale * kLog2e,
              scale,
              causal != 0,
              Dropout{seed, threshold, rp}};
  set_strides(p.st, strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dlse);
  if (d == 64) return launch<64>(p, o, l, dl, dq, dtype, b, st);
  if (d == 128) return launch<128>(p, o, l, dl, dq, dtype, b, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_flash_bwd_smem(int d) {
  using namespace fattn;
  return d == 64 ? BwdLayout<64>::kBytes : d == 128 ? BwdLayout<128>::kBytes : 0;
}
