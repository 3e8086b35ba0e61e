// Flash-attention backward for Hopper (sm_90a).
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
// Layout: q, dout (b, h, sq, d); k, v, dk, dv (b, h_kv, sk, d); lse and di
// (b, h, sq) fp32; all contiguous. Causal masking is top-left aligned.
//
// Design (FA2's K/V-stationary order): one block per (64-key tile, kv head,
// batch) walks every query tile of every query head in its GQA group,
// holding dK and dV for its keys in registers, so dK/dV are summed over the
// group in fp32 inside the kernel (no per-query-head copies to reduce
// afterwards, as the JAX package does at flash_bwd.py:481-487). dQ gets a
// contribution from every key tile: it accumulates by fp32 atomicAdd into a
// (b, h, sq, d) buffer that the entry point zeroes, and a last pass scales
// and casts it. The atomics make dQ's low bits depend on the order blocks
// finish: it is not bitwise deterministic from run to run.
//   - bf16 / fp16: four warps, each owning 16 keys; S^T = K Q^T and
//     dP^T = V dO^T on mma.sync m16n8k16, whose C fragments are reused as the
//     A operands of dV += P^T dO and dK += dS^T Q from registers. dS goes
//     through shared memory once for dQ = dS K. Query tiles of 64 rows at
//     d = 64 and 32 at d = 128 keep the block under 48 KB of shared memory.
//   - fp32: 16 keys x 16 queries per step, FMA on the CUDA cores.
// Bound: tensor-core math at training sizes (5 products per tile). This
// first version loads tiles with plain loads and one buffer, so loads and
// math do not overlap; wgmma, TMA and pipelining are the later work.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
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
  const float* lse;
  const float* di;
  float* dq_acc;  // (b, h, sq, d) fp32, zero on entry
  void* dk;
  void* dv;
  int h, h_kv, sq, sk;
  float scale_log2;
  float scale;
  bool causal;
  Dropout drop;
};

// di = rowsum(o * dout) - dlse, one warp per row (flash_bwd.py:497-506).
template <typename T, int D>
__global__ void __launch_bounds__(128)
    bwd_di_kernel(const T* o, const T* dout, const float* dlse, float* di,
                  int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) {
    acc += to_float(o[(size_t)row * D + c]) * to_float(dout[(size_t)row * D + c]);
  }
  acc = warp_sum(acc);
  if (lane == 0) di[row] = acc - (dlse != nullptr ? dlse[row] : 0.f);
}

// dq = scale * dq_acc in the output dtype.
template <typename T>
__global__ void bwd_dq_kernel(const float* acc, T* dq, size_t n, float scale) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dq[i] = from_float<T>(acc[i] * scale);
  }
}

// ---------------------------------------------------------------- mma path

// Fragment layouts: csrc/mma.cuh. In the transposed tiles S^T and dP^T a
// thread's C element [nb][e] is key (warp * 16 + g + 8 * (e >> 1)) and query
// (nb * 8 + 2 * t + (e & 1)) of the tile.
template <typename T, int D, int kBlockM>
__global__ void __launch_bounds__(128)
    flash_bwd_mma_kernel(const BwdParams p) {
  constexpr int kBlockN = 64;  // keys per block, 16 per warp
  constexpr int kStrideD = D + 8;  // shared row strides in elements
  constexpr int kStrideN = kBlockN + 8;
  __shared__ __align__(16) uint16_t k_s[kBlockN * kStrideD];
  __shared__ __align__(16) uint16_t q_s[kBlockM * kStrideD];
  __shared__ __align__(16) uint16_t do_s[kBlockM * kStrideD];
  __shared__ __align__(16) uint16_t ds_s[kBlockM * kStrideN];  // dS (q, key)
  __shared__ float lse_s[kBlockM];  // log2 domain; +inf: the row sees nothing
  __shared__ float di_s[kBlockM];
  __shared__ uint32_t rh_s[kBlockM];  // row halves of the dropout hash

  const int n0 = blockIdx.x * kBlockN;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = p.h / p.h_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  const size_t kv_off = (size_t)(bb * p.h_kv + hk) * p.sk * D;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + kv_off;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + kv_off;

  constexpr int kVecPerRow = D / 8;  // 16-byte vectors
  for (int i = threadIdx.x; i < kBlockN * kVecPerRow; i += blockDim.x) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < p.sk) {
      x = *reinterpret_cast<const uint4*>(k + (size_t)(n0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(k_s + r * kStrideD + c) = x;
  }
  // V rows of this warp's keys as A fragments, for dP^T = V dO^T.
  auto v_pair = [&](int key, int col) -> uint32_t {
    return key < p.sk ? ld_pair(v + (size_t)key * D + col) : 0u;
  };
  uint32_t va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    va[kk][0] = v_pair(key0, kk * 16 + 2 * t);
    va[kk][1] = v_pair(key0 + 8, kk * 16 + 2 * t);
    va[kk][2] = v_pair(key0, kk * 16 + 8 + 2 * t);
    va[kk][3] = v_pair(key0 + 8, kk * 16 + 8 + 2 * t);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  const int m_begin =
      first_row_for_keys(n0, p.causal) / kBlockM * kBlockM;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const uint32_t bh = bb * p.h + hq;  // the query head keys the hash
    const size_t q_off = (size_t)bh * p.sq * D;
    const uint16_t* q = static_cast<const uint16_t*>(p.q) + q_off;
    const uint16_t* dout = static_cast<const uint16_t*>(p.dout) + q_off;
    const float* lse = p.lse + (size_t)bh * p.sq;
    const float* di = p.di + (size_t)bh * p.sq;
    float* dq = p.dq_acc + q_off;

    for (int m0 = m_begin; m0 < p.sq; m0 += kBlockM) {
      __syncthreads();  // the previous tile's q_s, do_s, ds_s are read
      for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += blockDim.x) {
        const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = qv;
        if (m0 + r < p.sq) {
          qv = *reinterpret_cast<const uint4*>(q + (size_t)(m0 + r) * D + c);
          dv4 = *reinterpret_cast<const uint4*>(dout + (size_t)(m0 + r) * D + c);
        }
        *reinterpret_cast<uint4*>(q_s + r * kStrideD + c) = qv;
        *reinterpret_cast<uint4*>(do_s + r * kStrideD + c) = dv4;
      }
      for (int i = threadIdx.x; i < kBlockM; i += blockDim.x) {
        const int row = m0 + i;
        const float l = row < p.sq ? lse[row] : -INFINITY;
        // exp2(x - inf) = 0: rows with no visible key (lse = -inf) and rows
        // past sq give p = 0 instead of inf.
        lse_s[i] = l == -INFINITY ? INFINITY : l * kLog2e;
        di_s[i] = row < p.sq ? di[row] : 0.f;
        rh_s[i] = p.drop.on() ? hash_row(p.drop.seed, bh, row) : 0u;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kBlockM queries.
      float s[kBlockM / 8][4], dp[kBlockM / 8][4];
#pragma unroll
      for (int nb = 0; nb < kBlockM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint16_t* kr = k_s + (warp * 16 + g) * kStrideD + kk * 16 + 2 * t;
          const uint32_t ka[4] = {ld_pair(kr), ld_pair(kr + 8 * kStrideD),
                                  ld_pair(kr + 8),
                                  ld_pair(kr + 8 * kStrideD + 8)};
          const uint16_t* qr = q_s + (nb * 8 + g) * kStrideD + kk * 16 + 2 * t;
          Mma<T>::run(s[nb], ka, ld_pair(qr), ld_pair(qr + 8));
          const uint16_t* dr = do_s + (nb * 8 + g) * kStrideD + kk * 16 + 2 * t;
          Mma<T>::run(dp[nb], va[kk], ld_pair(dr), ld_pair(dr + 8));
        }
      }

      // s <- dropped, rescaled p (for dV); dp <- dS = p * (dP - di).
#pragma unroll
      for (int nb = 0; nb < kBlockM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t + (e & 1);
          const int col = key0 + 8 * (e >> 1);
          const float pv = key_visible(m0 + ql, col, p.sk, p.causal)
                               ? exp2f(s[nb][e] * p.scale_log2 - lse_s[ql])
                               : 0.f;
          float pd = pv * p.drop.rp, dpd = dp[nb][e] * p.drop.rp;
          if (p.drop.on() && !keep_elem(rh_s[ql], col, p.drop.threshold)) {
            pd = dpd = 0.f;
          }
          s[nb][e] = pd;
          dp[nb][e] = pv * (dpd - di_s[ql]);
        }
      }

      // dV += P^T dO and dK += dS^T Q, A operands straight from registers.
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        const uint32_t pa[4] = {
            Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
            Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
            Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
        const uint32_t dsa[4] = {
            Mma<T>::pack(dp[2 * kk][0], dp[2 * kk][1]),
            Mma<T>::pack(dp[2 * kk][2], dp[2 * kk][3]),
            Mma<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            Mma<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int off = (kk * 16 + 2 * t) * kStrideD + dn * 8 + g;
          Mma<T>::run(dv[dn], pa, ld_col_pair(do_s + off, kStrideD),
                      ld_col_pair(do_s + off + 8 * kStrideD, kStrideD));
          Mma<T>::run(dk[dn], dsa, ld_col_pair(q_s + off, kStrideD),
                      ld_col_pair(q_s + off + 8 * kStrideD, kStrideD));
        }
      }

      // dS to shared memory as (query, key) for dQ.
#pragma unroll
      for (int nb = 0; nb < kBlockM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nb * 8 + 2 * t + (e & 1);
          const int kl = warp * 16 + g + 8 * (e >> 1);
          ds_s[ql * kStrideN + kl] = Mma<T>::bits(dp[nb][e]);
        }
      }
      __syncthreads();

      // dQ (kBlockM x D) += dS K over this block's 64 keys. The warps split
      // the rows, and at kBlockM = 32 the columns too.
      constexpr int kWarpsM = kBlockM / 16;
      constexpr int kCols = D / (4 / kWarpsM);
      const int mw = warp % kWarpsM, c0 = (warp / kWarpsM) * kCols;
      float acc[kCols / 8][4];
#pragma unroll
      for (int dn = 0; dn < kCols / 8; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint16_t* ar = ds_s + (mw * 16 + g) * kStrideN + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld_pair(ar), ld_pair(ar + 8 * kStrideN),
                               ld_pair(ar + 8), ld_pair(ar + 8 * kStrideN + 8)};
#pragma unroll
        for (int dn = 0; dn < kCols / 8; ++dn) {
          const uint16_t* br = k_s + (kk * 16 + 2 * t) * kStrideD + c0 + dn * 8 + g;
          Mma<T>::run(acc[dn], a, ld_col_pair(br, kStrideD),
                      ld_col_pair(br + 8 * kStrideD, kStrideD));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + mw * 16 + g + 8 * r;
        if (row >= p.sq) continue;
#pragma unroll
        for (int dn = 0; dn < kCols / 8; ++dn) {
          float* dst = dq + (size_t)row * D + c0 + dn * 8 + 2 * t;
          atomicAdd(dst, acc[dn][2 * r]);
          atomicAdd(dst + 1, acc[dn][2 * r + 1]);
        }
      }
    }
  }

  uint16_t* dk_out = static_cast<uint16_t*>(p.dk) + kv_off;
  uint16_t* dv_out = static_cast<uint16_t*>(p.dv) + kv_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.sk) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const size_t off = (size_t)key * D + dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_out + off) = Mma<T>::pack(
          dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + off) =
          Mma<T>::pack(dv[dn][2 * r], dv[dn][2 * r + 1]);
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

  const int n0 = blockIdx.x * kN;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = p.h / p.h_kv;
  const int i16 = threadIdx.x >> 4, j16 = threadIdx.x & 15;

  const size_t kv_off = (size_t)(bb * p.h_kv + hk) * p.sk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  for (int i = threadIdx.x; i < kN * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool in = n0 + r < p.sk;
    k_s[r * kS + c] = in ? k[(size_t)(n0 + r) * D + c] : 0.f;
    v_s[r * kS + c] = in ? v[(size_t)(n0 + r) * D + c] : 0.f;
  }
  float dk[kPer], dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk[i] = dv[i] = 0.f;

  const int col = n0 + j16;  // this thread's key in the score grid
  const int m_begin = first_row_for_keys(n0, p.causal) / kM * kM;
  for (int hq = hk * group; hq < (hk + 1) * group; ++hq) {
    const uint32_t bh = bb * p.h + hq;
    const size_t q_off = (size_t)bh * p.sq * D;
    const float* q = static_cast<const float*>(p.q) + q_off;
    const float* dout = static_cast<const float*>(p.dout) + q_off;
    const float* lse = p.lse + (size_t)bh * p.sq;
    const float* di = p.di + (size_t)bh * p.sq;
    float* dq = p.dq_acc + q_off;

    for (int m0 = m_begin; m0 < p.sq; m0 += kM) {
      __syncthreads();
      for (int i = threadIdx.x; i < kM * D; i += blockDim.x) {
        const int r = i / D, c = i % D;
        const bool in = m0 + r < p.sq;
        q_s[r * kS + c] = in ? q[(size_t)(m0 + r) * D + c] : 0.f;
        do_s[r * kS + c] = in ? dout[(size_t)(m0 + r) * D + c] : 0.f;
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
        if (l != -INFINITY && key_visible(row, col, p.sk, p.causal)) {
          pv = exp2f(sc * p.scale_log2 - l * kLog2e);
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
      if (m0 + i16 < p.sq) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            a += ds_s[i16 * (kN + 1) + j] * k_s[j * kS + j16 + 16 * i];
          }
          atomicAdd(dq + (size_t)(m0 + i16) * D + j16 + 16 * i, a);
        }
      }
    }
  }

  const int key = n0 + i16;
  if (key >= p.sk) return;
  float* dk_out = static_cast<float*>(p.dk) + kv_off;
  float* dv_out = static_cast<float*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk_out[(size_t)key * D + j16 + 16 * i] = dk[i] * p.scale;
    dv_out[(size_t)key * D + j16 + 16 * i] = dv[i];
  }
}

template <typename T, int D>
cudaError_t launch_typed(const BwdParams& p, const void* o, const float* dlse,
                         float* di, void* dq, int b, cudaStream_t st) {
  const int rows = b * p.h * p.sq;
  bwd_di_kernel<T, D><<<(rows + 3) / 4, 128, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(p.dout), dlse, di,
      rows);
  if constexpr (std::is_same<T, float>::value) {
    flash_bwd_f32_kernel<D>
        <<<dim3((p.sk + 15) / 16, p.h_kv, b), 256, 0, st>>>(p);
  } else {
    constexpr int kBlockM = D == 64 ? 64 : 32;
    flash_bwd_mma_kernel<T, D, kBlockM>
        <<<dim3((p.sk + 63) / 64, p.h_kv, b), 128, 0, st>>>(p);
  }
  const size_t n = (size_t)rows * D;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  bwd_dq_kernel<T><<<blocks, 256, 0, st>>>(p.dq_acc, static_cast<T*>(dq), n,
                                           p.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const BwdParams& p, const void* o, const float* dlse,
                   float* di, void* dq, int dtype, int b, cudaStream_t st) {
  switch (dtype) {
    case kBF16:
      return launch_typed<__nv_bfloat16, D>(p, o, dlse, di, dq, b, st);
    case kF16:
      return launch_typed<__half, D>(p, o, dlse, di, dq, b, st);
    case kF32:
      return launch_typed<float, D>(p, o, dlse, di, dq, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fattn

// di and dq_acc are fp32 scratch the wrapper allocates: (b, h, sq) and
// (b, h, sq, d). dq_acc is zeroed here, on the stream, every call.
extern "C" int fattn_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, const void* dlse, void* di,
                               void* dq_acc, void* dq, void* dk, void* dv,
                               int b, int h, int h_kv, int sq, int sk, int d,
                               float scale, int causal, unsigned seed,
                               unsigned threshold, float rp, int dtype,
                               void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || sq <= 0 || sk <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      dq_acc, 0, (size_t)b * h * sq * d * sizeof(float), st);
  if (err != cudaSuccess) return err;
  const BwdParams p{q,
                    k,
                    v,
                    dout,
                    static_cast<const float*>(lse),
                    static_cast<const float*>(di),
                    static_cast<float*>(dq_acc),
                    dk,
                    dv,
                    h,
                    h_kv,
                    sq,
                    sk,
                    scale * kLog2e,
                    scale,
                    causal != 0,
                    Dropout{seed, threshold, rp}};
  const float* dl = static_cast<const float*>(dlse);
  float* di_f = static_cast<float*>(di);
  if (d == 64) return launch<64>(p, o, dl, di_f, dq, dtype, b, st);
  if (d == 128) return launch<128>(p, o, dl, di_f, dq, dtype, b, st);
  return cudaErrorInvalidValue;
}
