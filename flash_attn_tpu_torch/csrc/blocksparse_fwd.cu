// Blocksparse attention forward (K8a) for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_attn_tpu/kernels/blocksparse.py
// :_bs_fwd_kernel (:537, launched at :840 by blocksparse_attention_fwd). The
// TPU kernel ran a sequential grid over each q block's padded list of kv
// tiles, fetched by scalar prefetch. Here one block per (64-row q tile, head,
// batch) loops over its own list of live 64-key tiles (csrc/blocksparse.cuh),
// so dead tiles cost neither loads nor math, and keeps K1's online softmax
// (csrc/flash_fwd.cu): fp32 (m, l, acc) per row, scores in the log2 domain.
// Full tiles skip the cell and causal masks; key padding applies on every
// tile. Rows with no visible key give out = 0 and lse = -inf (l == 0), and a
// q tile with an empty list writes them without loading anything.
//
// Dropout is K1's: the csrc/prng.cuh hash of (seed, b * h + head, row, col)
// in absolute coordinates, its row half computed once per row, so the mask
// equals dropout_mask_dense bit for bit; it drops the unnormalised p after l
// is summed, and 1/(1-p) folds into the final scaling.
//
// Layout: q (b, h, sq, d), k and v (b, h, sk, d), out (b, h, sq, d), each
// with its own strides (csrc/common.cuh Strides), lse (b, h, sq) fp32
// contiguous; MHA only (the JAX blocksparse op is).
// Bound: tensor-core operations, 4 * d per visible (q, k) pair per head, at
// 64x64-tile granularity in practice: a live tile costs its whole products.
//   - bf16 / fp16 (bs_fwd_wgmma_kernel): K1's design at one warpgroup per
//     q tile (a neighbour's list differs). Q is loaded once by TMA; the K
//     and V tiles of the live list stream by TMA through the KvRing of
//     csrc/blocksparse.cuh (2 stages: four blocks to an SM at d = 64, two
//     at d = 128), so the next tile loads while this one computes; the
//     softmax, not the loads or the products, bounds the kernel, so warps
//     to hide its latency beat a deeper ring.
//     S = Q K^T by wgmma m64n64k16 from shared memory, the softmax in
//     registers, O += P V by register-A wgmma reading V as stored, and the
//     next tile's S issued right behind P V so the warpgroup waits once for
//     both. A warp's 16 rows are one cell row, so a partial tile's cell bit
//     is one test per warp; elements are tested one by one only on tiles
//     crossing sk or the warp's causal diagonal, or under key padding (one
//     64-bit word of key bits per tile, the wrapper's key_bits). Under
//     causal masking the longest lists launch first.
//   - fp32: 256 threads, four per row, FMA (the tensor cores would round to
//     tf32), each 64-key tile taken as two halves of 32.
#include "blocksparse.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace fattn {
namespace {

template <int D>
using FwdRing = KvRing<D, 1, 2>;  // 41,008 / 82,968 B  // 74,792 / 82,968 B

// Thread (warp w, lane 4g + t) owns rows q0 + 16w + g and + 8; its
// accumulator element [4 nb + e] is row + 8 (e >> 1), key 8 nb + 2t + (e & 1)
// of the tile (csrc/hopper.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kBsThreads, D == 64 ? 4 : 2)
    bs_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const BsParams p) {
  using R = FwdRing<D>;
  const int iq = bs_q_tile(p), hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int warp_row0 = iq * kTileQ + warp * 16;
  const int row0 = warp_row0 + g;  // this thread's rows: row0, row0 + 8
  const int n = p.cnt[iq];
  const int* tiles = p.idx + (size_t)iq * p.max_n;  // live kv tiles
  const int* fulls = p.full + (size_t)iq * p.max_n;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  if (n > 0) {
    extern __shared__ uint8_t smem_raw[];
    R ring(smem_raw);
    if (tid == 0) {
      ring.init();
      ring.load_resident(0, &map_q, iq * kTileQ, hh, bb);
      for (int j = 0; j < R::kStages && j < n; ++j) {
        ring.load(j, tiles[j], &map_k, &map_v, hh, bb);
      }
    }
    __syncthreads();

    // Row padding is tested with key padding (both or neither); rows past
    // sq are computed on TMA's zeros and never stored.
    const bool pad = p.key_bits != nullptr;
    const bool rok[2] = {!pad || bs_row_ok(p, bb, row0),
                         !pad || bs_row_ok(p, bb, row0 + 8)};
    uint32_t rh[2] = {0u, 0u};  // row halves of the dropout hash
    if (p.drop.on()) {
      const uint32_t bh = bb * p.h + hh;
      rh[0] = hash_row(p.drop.seed, bh, row0);
      rh[1] = hash_row(p.drop.seed, bh, row0 + 8);
    }
    const uint32_t q_base = ring.res_addr(0);

    // S = Q K_j^T: 64 rows x 64 keys.
    float sc[kTileK / 2];
    auto issue_s = [&](int j) {
      ring.wait(j);
      const uint32_t qb = opaque(q_base), kb = opaque(ring.k_addr(j));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // Column block kk / 4, 16-element (32-byte) step kk % 4 inside it.
        const int c = kk / 4, step = (kk % 4) * 32;
        Wgmma<T, kTileK>::template ss<0, 0>(
            sc, sw128_desc(qb + c * kTileQ * 128 + step, 16, 1024),
            sw128_desc(kb + c * kTileK * 128 + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    ring.wait_resident();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    for (int j = 0; j < n; ++j) {
      const int k0 = tiles[j] * kTileK;
      const bool full = fulls[j] != 0;
      // A warp's 16 rows are one cell row: a dead cell hides the tile from
      // the whole warp, a live one leaves only the per-element tests.
      if (!full && !bs_cell_on(p, row0, k0)) {
#pragma unroll
        for (int i = 0; i < kTileK / 2; ++i) sc[i] = -INFINITY;
      } else if (bs_test_elements(p, full, k0, warp_row0)) {
        const uint64_t kbits = pad ? bs_key_bits(p, bb, tiles[j]) : ~0ull;
#pragma unroll
        for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = nb * 8 + 2 * t + (e & 1);
            const bool vis = rok[e >> 1] && ((kbits >> cl) & 1ull) &&
                             key_visible(row0 + 8 * (e >> 1), k0 + cl, p.sk,
                                         p.causal);
            if (!vis) sc[nb * 4 + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kTileK / 2; ++i) {
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
      for (int i = 0; i < kTileK / 2; ++i) {
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
        for (int nb = 0; nb < kTileK / 8; ++nb) {
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
      uint32_t pa[kTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = Mma<T>::pack(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        }
      }
      fence_regs(o);
      wgmma_fence();
      const uint32_t vb = opaque(ring.v_addr(j));
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        Wgmma<T, D>::template rs<1>(
            o, pa[kk], sw128_desc(vb + kk * 16 * 128, kTileK * 128, 1024), 1);
      }
      wgmma_commit();
      // S of the next tile queues behind P V (its accumulators are free: P
      // lives in pa now), so the warpgroup waits once for both.
      if (j + 1 < n) issue_s(j + 1);
      wgmma_wait<0>();
      fence_regs(pa);  // read by P V until the wait: not reused for S
      fence_regs(o);
      fence_regs(sc);
      // Every thread's products on entry j's stage are done: refill it.
      __syncthreads();
      if (tid == 0 && j + R::kStages < n) {
        ring.load(j + R::kStages, tiles[j + R::kStages], &map_k, &map_v, hh,
                  bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  uint16_t* out = bs_rows<uint16_t>(p, p.o, kOpO, bb, hh);
  const long long os = p.st[kOpO].s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.sq) continue;
    const float inv = l[r] > 0.f ? (1.f / l[r]) * p.drop.rp : 0.f;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(out + row * os + nb * 8 + 2 * t) =
          Mma<T>::pack(o[nb * 4 + 2 * r] * inv, o[nb * 4 + 2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse_out[(size_t)(bb * p.h + hh) * p.sq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
    }
  }
}

// Four threads per row; thread t4 owns dims t4, t4 + 4, ... (K1's fp32 path).
template <int D>
__global__ void __launch_bounds__(256) bs_fwd_f32_kernel(const BsParams p) {
  constexpr int kHalf = kTileK / 2;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float k_s[kHalf * D];
  __shared__ __align__(16) float v_s[kHalf * D];
  __shared__ bool kok_s[kHalf];

  const int iq = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int t4 = threadIdx.x & 3;
  const int row = iq * kTileQ + (threadIdx.x >> 2);
  const size_t bh = (size_t)bb * p.h + hh;
  const float* q = bs_rows<float>(p, p.q, kOpQ, bb, hh);
  const float* k = bs_rows<float>(p, p.k, kOpK, bb, hh);
  const float* v = bs_rows<float>(p, p.v, kOpV, bb, hh);
  const long long ks = p.st[kOpK].s, vs = p.st[kOpV].s;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < p.sq ? q[row * p.st[kOpQ].s + i * 4 + t4] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const bool rok = bs_row_ok(p, bb, row);
  const uint32_t rh = p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u;

  const int n = p.cnt[iq];
  for (int j = 0; j < n; ++j) {
    const int tile0 = p.idx[iq * p.max_n + j] * kTileK;
    const bool full = p.full[iq * p.max_n + j] != 0;
    const bool cell = !full && bs_cell_on(p, row, tile0);
    for (int k0 = tile0; k0 < tile0 + kTileK; k0 += kHalf) {
      __syncthreads();
      for (int i = threadIdx.x; i < kHalf * D / 4; i += blockDim.x) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (k0 + r < p.sk) {
          kv = *reinterpret_cast<const float4*>(k + (k0 + r) * ks + c);
          vv = *reinterpret_cast<const float4*>(v + (k0 + r) * vs + c);
        }
        *reinterpret_cast<float4*>(k_s + r * D + c) = kv;
        *reinterpret_cast<float4*>(v_s + r * D + c) = vv;
      }
      if (threadIdx.x < kHalf) kok_s[threadIdx.x] = bs_key_ok(p, bb, k0 + threadIdx.x);
      __syncthreads();

      float s[kHalf];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) a += qr[i] * k_s[jj * D + i * 4 + t4];
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        const bool vis = bs_visible(p, full, cell, rok, kok_s[jj], row, k0 + jj);
        s[jj] = vis ? a * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m - base);
      m = mx;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < kHalf; ++jj) {
        s[jj] = exp2f(s[jj] - base);
        rs += s[jj];
      }
      l = l * alpha + rs;
      if (p.drop.on()) {  // after l: the normalizer keeps the dropped p
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj) {
          if (!keep_elem(rh, k0 + jj, p.drop.threshold)) s[jj] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float a = acc[i] * alpha;
#pragma unroll
        for (int jj = 0; jj < kHalf; ++jj) a += s[jj] * v_s[jj * D + i * 4 + t4];
        acc[i] = a;
      }
    }
  }

  if (row >= p.sq) return;
  float* out = bs_rows<float>(p, p.o, kOpO, bb, hh) + row * p.st[kOpO].s;
  const float inv = l > 0.f ? (1.f / l) * p.drop.rp : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[i * 4 + t4] = acc[i] * inv;
  if (t4 == 0) p.lse_out[bh * p.sq + row] = l > 0.f ? m * kLn2 + logf(l) : -INFINITY;
}

template <typename T, int D>
cudaError_t launch_wgmma(const BsParams& p, int b, dim3 grid,
                         cudaStream_t st) {
  using R = FwdRing<D>;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = bs_map(&map_q, p, kOpQ, b, D);
  if (err == cudaSuccess) err = bs_map(&map_k, p, kOpK, b, D);
  if (err == cudaSuccess) err = bs_map(&map_v, p, kOpV, b, D);
  if (err != cudaSuccess) return err;
  const auto kernel = bs_fwd_wgmma_kernel<T, D>;
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kBsThreads, R::kBytes, st>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const BsParams& p, int dtype, int b, dim3 grid,
                   cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      return launch_wgmma<__nv_bfloat16, D>(p, b, grid, st);
    case kF16:
      return launch_wgmma<__half, D>(p, b, grid, st);
    case kF32:
      bs_fwd_f32_kernel<D><<<grid, 256, 0, st>>>(p);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fattn

// kv_idx, kv_cnt, kv_full: the layout's per-q-tile lists of kv tiles;
// rowmask (sq_pad, ncells) uint8; q_valid (b, sq) and k_valid (b, sk) uint8
// or null (no key padding), key_bits (b, ceil(sk / 64)) 64-bit words of
// k_valid (null without padding; read by the bf16 / fp16 kernel, k_valid by
// the fp32 one); strides: host (batch, head, row) element strides of every
// Operand (those of dout, dk and dv unused here).
extern "C" int fattn_blocksparse_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides,
    const void* kv_idx, const void* kv_cnt, const void* kv_full,
    const void* rowmask, const void* q_valid, const void* k_valid,
    const void* key_bits, int b,
    int h, int sq, int sk, int d, int max_kv, int ncells, float scale,
    int causal, unsigned seed, unsigned threshold, float rp, int dtype,
    void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0 || max_kv <= 0 || ncells <= 0) {
    return cudaErrorInvalidValue;
  }
  BsParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  p.idx = static_cast<const int*>(kv_idx);
  p.cnt = static_cast<const int*>(kv_cnt);
  p.full = static_cast<const int*>(kv_full);
  p.rowmask = static_cast<const uint8_t*>(rowmask);
  p.q_valid = static_cast<const uint8_t*>(q_valid);
  p.k_valid = static_cast<const uint8_t*>(k_valid);
  p.key_bits = static_cast<const uint64_t*>(key_bits);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.max_n = max_kv;
  p.ncells = ncells;
  p.scale_log2 = scale * kLog2e;
  p.scale = scale;
  p.causal = causal != 0;
  p.drop = Dropout{seed, threshold, rp};
  set_strides(p.st, strides);
  const dim3 grid((sq + kTileQ - 1) / kTileQ, h, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, dtype, b, grid, st);
  if (d == 128) return launch<128>(p, dtype, b, grid, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of K8a's bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_blocksparse_fwd_smem(int d) {
  using namespace fattn;
  return d == 64 ? FwdRing<64>::kBytes : d == 128 ? FwdRing<128>::kBytes : 0;
}
