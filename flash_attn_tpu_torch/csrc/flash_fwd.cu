// Flash-attention forward for Hopper (sm_90a): K1.
//
// Replaces the Pallas kernel flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel
// (launched by flash_attention_fwd there). Exact attention with an online
// softmax: for each query row a running (max m, sum l, accumulator o) is kept
// in fp32 while the block walks the K/V tiles, so the (sq, sk) score matrix
// never reaches device memory. Scores are taken in the log2 domain (scale *
// log2(e) folded into one FMA before exp2; scale > 0).
//
// Layout: q (b, h, sq, d), k and v (b, h_kv, sk, d), out (b, h, sq, d), each
// through its own strides (csrc/common.cuh Strides), so the op passes views
// of its (b, s, h, d) tensors and of the packed qkv; lse (b, h, sq) fp32
// contiguous. GQA: query head hh reads kv head hh / (h / h_kv) in place.
// Causal masking is top-left aligned (key j is visible from query i iff
// j <= i), as in the JAX package, also when sq != sk. Ragged sq and sk are
// masked here; d is 64 or 128. Rows with no visible key give out = 0 and
// lse = -inf. The mask is csrc/mask.cuh, shared with the backward.
//
// Segments (flash_fwd.py:314-333 there; csrc/segments.cuh): with a tile
// plan, query row i sees key j only when both carry the same non-negative
// segment id and, under causal masking, i's position is at or after j's
// (positions are per segment, so causal is top-left inside each segment).
// The wgmma kernel walks only the key tiles its plan lists for its 128
// rows: a tile with no visible pair is neither loaded nor computed, and a
// full tile (one shared segment, fully past) skips the per-element test. A
// block with no live key tile writes out = 0 and lse = -inf without loading
// anything.
//
// The band terms (flash_fwd.py:241-284 and common.py:108-185 there;
// csrc/mask.cuh Band): a window (left, right) by global indices (by
// positions in the segment form), sink columns, the logit softcap and ALiBi.
// The dense walk visits the sink tiles and the band's tiles only
// (key_walk); a tile that crosses a band edge or the sink boundary tests
// elements (tile_masked); the softcap and the bias go on the score before
// the mask, in the score's pre-scale units. Kernels without the terms are
// their own instances (kBand), in which every band test folds away.
//
// Dropout (flash_fwd.py:363-377 there): the keep mask is the coordinate hash
// of csrc/prng.cuh on (seed, b * h + head, row, col), its row half computed
// once per row. The normalizer l sums the un-dropped p, dropped p is zeroed
// before P @ V, 1/(1-p) folds into the final scaling, and the lse is that of
// the un-dropped scores, so the backward can rebuild p from it.
//
// Bound: tensor-core math at prefill and training sizes (4 d flops per
// visible pair), and the bytes of q, k, v and out at short sequences.
//   - bf16 / fp16 (flash_fwd_wgmma_kernel): one block per (128-row query
//     tile, head, batch), two warpgroups of 64 rows each. Q is loaded once
//     and 128-key K/V tiles stream through a ring of 3 stages in dynamic
//     shared memory by TMA (cp.async.bulk.tensor
//     on 4-D maps over the strided operands; an mbarrier per stage counts
//     the bytes), so the loads of later tiles overlap the math of this one;
//     the warpgroup that releases a stage second refills it (csrc/hopper.cuh
//     stage_released_by_both). S = Q K^T by wgmma m64n128k16 from shared
//     memory, the online softmax in registers, P rounded to bf16/fp16 in
//     registers and O += P V by register-A wgmma reading V as stored
//     (transpose bit, no transposing copy). The next tile's S is issued
//     right behind P V, so the tensor cores run both while the warpgroup
//     waits once, and the two warpgroups take turns issuing (one's softmax
//     overlaps the other's products). Only tiles that cross the causal diagonal or sk's edge run
//     the per-element visibility test. Under causal masking the heaviest
//     query tiles launch first. See csrc/hopper.cuh for the tile layout.
//   - fp32 (flash_fwd_f32_kernel): 256 threads, four per query row, FMA on
//     the CUDA cores (the tensor cores would round fp32 inputs to tf32).
#include "common.cuh"
#include "hopper.cuh"
#include "mask.cuh"
#include "mma.cuh"
#include "prng.cuh"
#include "segments.cuh"

namespace fattn {
namespace {

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: not written
  int h, h_kv, sq, sk;
  float scale_log2;
  bool causal;
  Dropout drop;
  Strides st[kNumOps];  // q, k, v, o
  SegPlan seg;          // qsp == nullptr: no segments
  Band band;            // window, sinks, softcap, ALiBi (csrc/mask.cuh)
};

// ---------------------------------------------------------------- wgmma path

constexpr int kBlockM = 128;     // query rows per block, 64 per warpgroup
constexpr int kBlockN = 128;     // keys per K/V tile
constexpr int kThreads = 256;    // two warpgroups of 64 rows each

template <int D>
struct FwdLayout {
  static constexpr int kStages = 3;  // 112 KB (d = 64), 225 KB (d = 128)
  static constexpr int kQ = kBlockM * D;     // elements of the Q tile
  static constexpr int kTile = kBlockN * D;  // elements of a K or V tile
  // Q, the K ring, the V ring, kStages + 1 mbarriers, kStages release
  // counts, alignment slack.
  static constexpr int kBytes =
      2 * (kQ + 2 * kStages * kTile) + 12 * (kStages + 1) + 1024;
};

// kBand: the instance with the band terms (csrc/mask.cuh Band); without
// them every band test folds away and the kernel is the plain causal one.
template <typename T, int D, bool kSeg, bool kBand>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const FwdParams p) {
  using L = FwdLayout<D>;
  constexpr int kStages = L::kStages;
  const Band band = kBand ? p.band : Band{};
  extern __shared__ uint8_t smem_raw[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem_aligned(smem_raw));
  uint16_t* k_s = q_s + L::kQ;
  uint16_t* v_s = k_s + kStages * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * L::kTile);
  uint64_t* q_full = full + kStages;
  uint32_t* released = reinterpret_cast<uint32_t*>(q_full + 1);

  // Under causal masking block 0 takes the last (heaviest) query tile.
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kBlockM;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.h_kv);
  // The walk: the sink tiles and the band's key tiles up to the causal
  // bound (csrc/mask.cuh key_walk), or with segments the live key tiles of
  // the plan's list for these rows.
  const uint32_t* list = nullptr;
  TileWalk walk{0, 0, 0};
  int n_tiles;
  if constexpr (kSeg) {
    const size_t t = (size_t)bb * p.seg.n_q128 + tile;
    n_tiles = p.seg.fwd_n[t];
    list = reinterpret_cast<const uint32_t*>(p.seg.fwd) + t * p.seg.n_k128;
  } else {
    walk = key_walk(q0, kBlockM, kBlockN, p.sk, p.causal, band);
    n_tiles = walk.n;
  }
  auto key0_of = [&](int j) -> int {
    if constexpr (kSeg) {
      return (int)(__ldg(list + j) & kTileIndex) * kBlockN;
    } else {
      return walk.tile(j) * kBlockN;
    }
  };
  const float slope =
      band.alibi != nullptr ? band.alibi[bb * p.h + hh] : 0.f;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + g;  // this thread's rows: +0, +8

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  // A block with no live key tile (segments only) writes out = 0 and
  // lse = -inf.
  if (n_tiles > 0) {
    // K and V tile j into ring stage j % kStages, by TMA.
    auto load_kv = [&](int j) {
      const int s = j % kStages;
      const int kr = key0_of(j);
      mbar_arrive_expect_tx(&full[s], 2 * 2 * L::kTile);
      for (int c = 0; c < D / 64; ++c) {
        const int off = s * L::kTile + c * kBlockN * 64;
        tma_load_4d(k_s + off, &map_k, &full[s], c * 64, kr, hk, bb);
        tma_load_4d(v_s + off, &map_v, &full[s], c * 64, kr, hk, bb);
      }
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        released[s] = 0u;
      }
      mbar_init(q_full, 1);
      mbar_fence_init();
      mbar_arrive_expect_tx(q_full, 2 * L::kQ);
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(q_s + c * kBlockM * 64, &map_q, q_full, c * 64, q0, hh, bb);
      }
      for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
    }
    __syncthreads();

    // Shared byte addresses: this warpgroup's rows of Q, the K and V rings.
    const uint32_t q_base = smem_u32(q_s + wg * 64 * 64);
    const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);
    // Segments: this thread's two rows' keys [lo, hi) in the interval
    // form, else their (id, position).
    int2 qr[2];
    int qpos[2] = {row0, row0 + 8};  // ALiBi's query coordinates
    bool iv = false;
    if constexpr (kSeg) {
      iv = p.seg.interval_form(bb);
      const int2* rows = iv ? p.seg.q_bounds(bb) : p.seg.q_rows(bb);
      qr[0] = rows[row0];
      qr[1] = rows[row0 + 8];
      qpos[0] = p.seg.q_rows(bb)[row0].y;
      qpos[1] = p.seg.q_rows(bb)[row0 + 8].y;
    }
    uint32_t rh[2] = {0u, 0u};  // row halves of the dropout hash
    if (p.drop.on()) {
      const uint32_t bh = bb * p.h + hh;
      rh[0] = hash_row(p.drop.seed, bh, row0);
      rh[1] = hash_row(p.drop.seed, bh, row0 + 8);
    }

    // S = Q K_j^T: 64 rows x 128 keys; sc[4 nb + e] as in csrc/hopper.cuh.
    float sc[kBlockN / 2];
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      const uint32_t qb = opaque(q_base);
      const uint32_t kb = opaque(k_base) + s * L::kTile * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // Column block kk / 4, 16-element (32-byte) step kk % 4 inside it.
        const int c = kk / 4, step = (kk % 4) * 32;
        Wgmma<T, kBlockN>::template ss<0, 0>(
            sc, sw128_desc(qb + c * kBlockM * 128 + step, 16, 1024),
            sw128_desc(kb + c * kBlockN * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    issue_s(0);
    if (wg == 1) named_barrier_arrive(3, 256);  // warpgroup 0 goes first
    wgmma_wait<0>();
    fence_regs(sc);
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = key0_of(j);
      if (kBand && band.logits()) {
        // Softcap and ALiBi on the score before the mask (flash_fwd.py:241
        // -284 there); the segment form's distances are positions.
#pragma unroll
        for (int nb = 0; nb < kBlockN / 8; ++nb) {
          int kpos[2] = {k0 + nb * 8 + 2 * t, k0 + nb * 8 + 2 * t + 1};
          if constexpr (kSeg) {
            if (band.alibi != nullptr) {
              const int4 kp = seg_pair(p.seg.k_rows(bb), kpos[0]);
              kpos[0] = kp.y;
              kpos[1] = kp.w;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nb * 4 + e] = band_logit(sc[nb * 4 + e], qpos[e >> 1],
                                        kpos[e & 1], p.causal, band, slope);
          }
        }
      }
      if constexpr (kSeg) {
        // The plan's class of this warpgroup's 64 rows against the tile: a
        // dead one masks every element, a partial one tests each (two
        // bounds per row in the interval form, else the pairs).
        const int cls = (int)(__ldg(list + j) >> (28 + 2 * wg)) & 3;
        if (cls == kTileDead) {
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i) sc[i] = -INFINITY;
        } else if (cls == kTilePartial && iv) {
#pragma unroll
          for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + nb * 8 + 2 * t + (e & 1);
              if (col < qr[e >> 1].x || col >= qr[e >> 1].y) {
                sc[nb * 4 + e] = -INFINITY;
              }
            }
          }
        } else if (cls == kTilePartial) {
          const int2* kr = p.seg.k_rows(bb);
#pragma unroll
          for (int nb = 0; nb < kBlockN / 8; ++nb) {
            const int4 kp = seg_pair(kr, k0 + nb * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int2 key = (e & 1) ? make_int2(kp.z, kp.w)
                                       : make_int2(kp.x, kp.y);
              if (!seg_visible(qr[e >> 1], key, p.causal, band)) {
                sc[nb * 4 + e] = -INFINITY;
              }
            }
          }
        }
      } else if (tile_masked(wg_row0, wg_row0 + 63, k0, k0 + kBlockN - 1,
                             p.sk, p.causal, band)) {
        // Only a tile crossing sk's edge, this warpgroup's causal diagonal, a
        // band edge or the sink boundary tests elements.
#pragma unroll
        for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nb * 8 + 2 * t + (e & 1);
            if (!key_visible(row0 + 8 * (e >> 1), col, p.sk, p.causal,
                             band)) {
              sc[nb * 4 + e] = -INFINITY;
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
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
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], p.scale_log2, -base[r]));
        rs[r] += sc[i];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      if (p.drop.on()) {  // after l: the normalizer keeps the dropped p
#pragma unroll
        for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t col = k0 + nb * 8 + 2 * t + (e & 1);
            if (!keep_elem(rh[e >> 1], col, p.drop.threshold)) {
              sc[nb * 4 + e] = 0.f;
            }
          }
        }
      }

      // O += P V_j: the C fragments of two key n-blocks form one A fragment.
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(o);
      // The two warpgroups take turns on the tensor cores: while one issues
      // its products, the other runs its softmax (barriers 3 and 4).
      named_barrier(3 + wg, 256);
      wgmma_fence();
      const uint32_t vb = opaque(v_base) + (j % kStages) * L::kTile * 2;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        Wgmma<T, D>::template rs<1>(
            o, pa[kk], sw128_desc(vb + kk * 16 * 128, kBlockN * 128, 1024), 1);
      }
      wgmma_commit();
      // S of the next tile queues behind P V (its accumulators are free: P
      // lives in pa now), so the warpgroup waits once for both.
      if (j + 1 < n_tiles) issue_s(j + 1);
      // Hand the tensor cores to the other warpgroup; warpgroup 1's last turn
      // has no successor (each barrier sees n_tiles syncs and arrivals).
      if (wg == 0 || j + 1 < n_tiles) named_barrier_arrive(4 - wg, 256);
      wgmma_wait<0>();
      fence_regs(pa);  // read by P V until the wait: not reused for S
      fence_regs(o);
      fence_regs(sc);
      // Tile j's stage is free once both warpgroups are done with it.
      named_barrier(1 + wg, 128);
      if (tid == 0 && stage_released_by_both(&released[j % kStages]) &&
          j + kStages < n_tiles) {
        load_kv(j + kStages);
      }
    }
  }  // n_tiles > 0

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  uint16_t* out = head_rows(static_cast<uint16_t*>(p.o), p.st[kOpO], bb, hh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.sq) continue;
    const float inv = l[r] > 0.f ? (1.f / l[r]) * p.drop.rp : 0.f;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(out + row * p.st[kOpO].s + nb * 8 + 2 * t) =
          Mma<T>::pack(o[nb * 4 + 2 * r] * inv, o[nb * 4 + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(size_t)(bb * p.h + hh) * p.sq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
    }
  }
}

// --------------------------------------------------------------- fp32 path

constexpr int kF32Rows = 64;  // query rows per block

// Four threads per query row; thread t4 owns dims t4, t4 + 4, ... of q and of
// the accumulator, so a quad reads four consecutive floats of a K/V row.
// With segments the block (one 64-row query tile of the plan) skips the
// 128-key tiles its plan calls dead and tests every element of the rest.
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const FwdParams p) {
  constexpr int kBlockK = 32;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float k_s[kBlockK * D];
  __shared__ __align__(16) float v_s[kBlockK * D];
  __shared__ int2 kseg_s[kBlockK];
  const bool seg = p.seg.qsp != nullptr;

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.h_kv);
  const int t4 = threadIdx.x & 3;
  const int q0 = blockIdx.x * kF32Rows;
  const int row = q0 + (threadIdx.x >> 2);

  const float* q =
      head_rows(static_cast<const float*>(p.q), p.st[kOpQ], bb, hh);
  const float* k =
      head_rows(static_cast<const float*>(p.k), p.st[kOpK], bb, hk);
  const float* v =
      head_rows(static_cast<const float*>(p.v), p.st[kOpV], bb, hk);
  const long long ks = p.st[kOpK].s, vs = p.st[kOpV].s;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < p.sq ? q[row * p.st[kOpQ].s + i * 4 + t4] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint32_t rh =
      p.drop.on() ? hash_row(p.drop.seed, bb * p.h + hh, row) : 0u;
  const int2 qrow = seg ? p.seg.q_rows(bb)[row] : make_int2(0, 0);
  const float slope =
      p.band.alibi != nullptr ? p.band.alibi[bb * p.h + hh] : 0.f;

  // Dense: the sink tiles and the band's tiles (csrc/mask.cuh key_walk);
  // segments: every tile the plan does not call dead.
  const TileWalk walk =
      seg ? TileWalk{0, 0, (p.sk + kBlockK - 1) / kBlockK}
          : key_walk(q0, kF32Rows, kBlockK, p.sk, p.causal, p.band);
  for (int j = 0; j < walk.n; ++j) {
    const int k0 = walk.tile(j) * kBlockK;
    if (seg && p.seg.tile_class(bb, blockIdx.x, k0 / 128) == kTileDead) {
      continue;  // not loaded, not computed
    }
    __syncthreads();
    if (seg && threadIdx.x < kBlockK) {
      kseg_s[threadIdx.x] = p.seg.k_rows(bb)[k0 + threadIdx.x];
    }
    for (int i = threadIdx.x; i < kBlockK * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const float4*>(k + (k0 + r) * ks + c);
        vv = *reinterpret_cast<const float4*>(v + (k0 + r) * vs + c);
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
      const int col = k0 + j;
      const bool vis = seg ? seg_visible(qrow, kseg_s[j], p.causal, p.band)
                           : key_visible(row, col, p.sk, p.causal, p.band);
      if (p.band.logits()) {
        a = seg ? band_logit(a, qrow.y, kseg_s[j].y, p.causal, p.band, slope)
                : band_logit(a, row, col, p.causal, p.band, slope);
      }
      s[j] = vis ? a * p.scale_log2 : -INFINITY;
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
    if (p.drop.on()) {  // after l: the normalizer keeps the dropped p
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        if (!keep_elem(rh, k0 + j, p.drop.threshold)) s[j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) a += s[j] * v_s[j * D + i * 4 + t4];
      acc[i] = a;
    }
  }

  if (row >= p.sq) return;
  float* out = head_rows(static_cast<float*>(p.o), p.st[kOpO], bb, hh) +
               row * p.st[kOpO].s;
  const float inv = l > 0.f ? (1.f / l) * p.drop.rp : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[i * 4 + t4] = acc[i] * inv;
  if (p.lse != nullptr && t4 == 0) {
    p.lse[(size_t)(bb * p.h + hh) * p.sq + row] =
        l > 0.f ? m * kLn2 + logf(l) : -INFINITY;
  }
}

template <typename T, int D, bool kSeg, bool kBand>
cudaError_t launch_wgmma(const FwdParams& p, int b, cudaStream_t st) {
  using L = FwdLayout<D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err =
      make_tile_map(&map_q, p.q, b, p.h, p.sq, D, p.st[kOpQ], kBlockM);
  if (err == cudaSuccess) {
    err = make_tile_map(&map_k, p.k, b, p.h_kv, p.sk, D, p.st[kOpK], kBlockN);
  }
  if (err == cudaSuccess) {
    err = make_tile_map(&map_v, p.v, b, p.h_kv, p.sk, D, p.st[kOpV], kBlockN);
  }
  if (err != cudaSuccess) return err;
  const auto kernel = flash_fwd_wgmma_kernel<T, D, kSeg, kBand>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, p.h, b);
  kernel<<<grid, kThreads, L::kBytes, st>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_typed(const FwdParams& p, int b, cudaStream_t st) {
  const bool seg = p.seg.qsp != nullptr;
  const bool band = p.band.windowed() || p.band.logits();
  if (seg) {
    return band ? launch_wgmma<T, D, true, true>(p, b, st)
                : launch_wgmma<T, D, true, false>(p, b, st);
  }
  return band ? launch_wgmma<T, D, false, true>(p, b, st)
              : launch_wgmma<T, D, false, false>(p, b, st);
}

template <int D>
cudaError_t launch(const FwdParams& p, int dtype, int b, cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      return launch_typed<__nv_bfloat16, D>(p, b, st);
    case kF16:
      return launch_typed<__half, D>(p, b, st);
    case kF32:
      flash_fwd_f32_kernel<D>
          <<<dim3((p.sq + kF32Rows - 1) / kF32Rows, p.h, b), 256, 0, st>>>(p);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fattn

// strides: (batch, head, row) element strides of every Operand
// (csrc/common.cuh); q, k, v and o are read here. seg_plan: the tile plan
// of csrc/segments.cu for (b, sq, sk, causal), or nullptr (no segments).
// window_left / window_right: -1 unbounded; sinks: with a band, dense
// only; softcap: 0 none; alibi: (b, h) fp32 slopes divided by the scale, or
// nullptr (csrc/mask.cuh Band).
extern "C" int fattn_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               const void* seg_plan, int b, int h, int h_kv,
                               int sq, int sk, int d, float scale, int causal,
                               unsigned seed, unsigned threshold, float rp,
                               int window_left, int window_right, int sinks,
                               float softcap, const void* alibi, int dtype,
                               void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || sq <= 0 || sk <= 0 ||
      !(scale > 0.f)) {
    return cudaErrorInvalidValue;
  }
  FwdParams p{q,  k,  v,  o,  static_cast<float*>(lse),
              h,  h_kv, sq, sk, scale * kLog2e,
              causal != 0, Dropout{seed, threshold, rp}};
  set_strides(p.st, strides);
  p.seg = SegPlan::at(static_cast<const int*>(seg_plan), b, sq, sk);
  if (!make_band(&p.band, window_left, window_right, sinks, softcap, scale,
                 alibi, seg_plan != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, dtype, b, st);
  if (d == 128) return launch<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_flash_fwd_smem(int d) {
  using namespace fattn;
  return d == 64 ? FwdLayout<64>::kBytes : d == 128 ? FwdLayout<128>::kBytes : 0;
}
