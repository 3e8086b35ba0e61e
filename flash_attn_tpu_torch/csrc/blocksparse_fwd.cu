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
// q tile with an empty list writes them without walking.
//
// Dropout is K1's: the csrc/prng.cuh hash of (seed, b * h + head, row, col)
// in absolute coordinates, so the mask equals dropout_mask_dense bit for bit;
// it drops the unnormalised p after l is summed, and 1/(1-p) folds into the
// final scaling.
//
// Layout: q (b, h, sq, d), k and v (b, h, sk, d), out (b, h, sq, d), each
// with its own strides (csrc/common.cuh Strides), lse (b, h, sq) fp32
// contiguous; MHA only (the JAX blocksparse op is).
//   - bf16 / fp16: four warps, 16 rows each, mma.sync m16n8k16 as in K1;
//   - fp32: 256 threads, four per row, FMA (the tensor cores would round to
//     tf32), each 64-key tile taken as two halves of 32.
// Bound: tensor-core operations, 4 * d per visible (q, k) pair per head. This
// first version loads each tile with plain loads into one buffer, so loads
// and math do not overlap; cp.async/TMA and wgmma are later work.
#include "blocksparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace fattn {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) bs_fwd_mma_kernel(const BsParams p) {
  constexpr int kStride = D + 8;  // no bank conflicts
  __shared__ __align__(16) uint16_t k_s[kTileK * kStride];
  __shared__ __align__(16) uint16_t v_s[kTileK * kStride];
  __shared__ bool kok_s[kTileK];  // the tile's keys: in bounds, unpadded

  const int iq = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = iq * kTileQ + warp * 16 + g;  // rows row0, row0 + 8
  const size_t bh = (size_t)bb * p.h + hh;

  const uint16_t* q = bs_rows<uint16_t>(p, p.q, kOpQ, bb, hh);
  const uint16_t* k = bs_rows<uint16_t>(p, p.k, kOpK, bb, hh);
  const uint16_t* v = bs_rows<uint16_t>(p, p.v, kOpV, bb, hh);
  const long long qs = p.st[kOpQ].s, ks = p.st[kOpK].s, vs = p.st[kOpV].s;

  auto q_pair = [&](int row, int col) -> uint32_t {
    return row < p.sq ? ld_pair(q + row * qs + col) : 0u;
  };
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = q_pair(row0, kk * 16 + 2 * t);
    qa[kk][1] = q_pair(row0 + 8, kk * 16 + 2 * t);
    qa[kk][2] = q_pair(row0, kk * 16 + 8 + 2 * t);
    qa[kk][3] = q_pair(row0 + 8, kk * 16 + 8 + 2 * t);
  }
  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  const bool rok[2] = {bs_row_ok(p, bb, row0), bs_row_ok(p, bb, row0 + 8)};
  uint32_t rh[2] = {0u, 0u};
  if (p.drop.on()) {
    rh[0] = hash_row(p.drop.seed, (uint32_t)bh, row0);
    rh[1] = hash_row(p.drop.seed, (uint32_t)bh, row0 + 8);
  }

  const int n = p.cnt[iq];
  for (int j = 0; j < n; ++j) {
    const int k0 = p.idx[iq * p.max_n + j] * kTileK;
    const bool full = p.full[iq * p.max_n + j] != 0;
    __syncthreads();  // the previous tile is no longer read
    constexpr int kVecPerRow = D / 8;  // 16-byte vectors
    #pragma unroll
    for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kMmaThreads) {
      const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const uint4*>(k + (k0 + r) * ks + c);
        vv = *reinterpret_cast<const uint4*>(v + (k0 + r) * vs + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    if (threadIdx.x < kTileK) kok_s[threadIdx.x] = bs_key_ok(p, bb, k0 + threadIdx.x);
    __syncthreads();

    float s[kTileK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = k_s + (nb * 8 + g) * kStride + kk * 16 + 2 * t;
        Mma<T>::run(s[nb], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // Both rows of a thread lie in one 16-row cell row.
    const bool cell = !full && bs_cell_on(p, row0, k0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nb * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool vis = bs_visible(p, full, cell, rok[e >> 1], kok_s[cl], row, k0 + cl);
        const float x = vis ? s[nb][e] * p.scale_log2 : -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with nothing visible yet keeps m = -inf: exp2 against 0 gives
      // p = 0 and alpha = 0 instead of NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
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
    if (p.drop.on()) {  // after l: the normalizer keeps the dropped p
#pragma unroll
      for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t col = k0 + nb * 8 + 2 * t + (e & 1);
          if (!keep_elem(rh[e >> 1], col, p.drop.threshold)) s[nb][e] = 0.f;
        }
      }
    }

    // O += P V: the C fragments of two key n-blocks form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
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
  uint16_t* out = bs_rows<uint16_t>(p, p.o, kOpO, bb, hh);
  const long long os = p.st[kOpO].s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.sq) continue;
    const float inv = l[r] > 0.f ? (1.f / l[r]) * p.drop.rp : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + row * os + dn * 8 + 2 * t) =
          Mma<T>::pack(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse_out[bh * p.sq + row] = l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
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

template <int D>
cudaError_t launch(const BsParams& p, int dtype, dim3 grid, cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      bs_fwd_mma_kernel<__nv_bfloat16, D><<<grid, kMmaThreads, 0, st>>>(p);
      break;
    case kF16:
      bs_fwd_mma_kernel<__half, D><<<grid, kMmaThreads, 0, st>>>(p);
      break;
    case kF32:
      bs_fwd_f32_kernel<D><<<grid, 256, 0, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace fattn

// kv_idx, kv_cnt, kv_full: the layout's per-q-tile lists of kv tiles;
// rowmask (sq_pad, ncells) uint8; q_valid (b, sq) and k_valid (b, sk) uint8
// or null (no key padding); strides: host (batch, head, row) element strides
// of every BsOperand (those of dout, dk and dv unused here).
extern "C" int fattn_blocksparse_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides,
    const void* kv_idx, const void* kv_cnt, const void* kv_full,
    const void* rowmask, const void* q_valid, const void* k_valid, int b,
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
  if (d == 64) return launch<64>(p, dtype, grid, st);
  if (d == 128) return launch<128>(p, dtype, grid, st);
  return cudaErrorInvalidValue;
}
