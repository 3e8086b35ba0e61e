// Blocksparse attention backward for Hopper (sm_90a): dK/dV (K8b) and dQ
// (K8c).
//
// Replace the Pallas kernels flash_attn_tpu/kernels/blocksparse.py
// :_bs_dkv_kernel (:855, launched at :1223) and :_bs_dq_kernel (:988,
// launched at :1287) of blocksparse_attention_bwd. As there, the backward is
// split in two kernels, so that neither needs atomics: K8b walks, for each kv
// tile, the transposed list of its live q tiles and holds dK and dV in
// registers; K8c walks, for each q tile, its list of live kv tiles and holds
// dQ. So dQ, unlike K2's (csrc/flash_bwd.cu), is deterministic. Both rebuild
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
//   - bf16 / fp16, mma.sync m16n8k16 (csrc/mma.cuh):
//     K8b: K2's design without dQ: four warps own 16 keys each of the 64-key
//     tile, S^T = K Q^T and dP^T = V dO^T feed dV += P^T dO and dK += dS^T Q
//     from registers. A 64-row q tile is taken whole at d = 64 and as two
//     halves at d = 128 (48 KB of static shared memory).
//     K8c: K1's design: four warps own 16 rows each with Q and dO as A
//     fragments in registers; S = Q K^T and dP = dO V^T, then dQ += dS K with
//     dS from the C fragments.
//   - fp32: 16 keys (K8b) or 16 rows (K8c) per block, FMA on the CUDA cores.
// Bound: tensor-core operations. Per visible (q, k) pair and head the
// backward needs 5 products, 10 * d operations; split as here it takes 14
// (K8b 8: S, dP, dV, dK; K8c 6: S, dP, dQ). Plain loads into one buffer, as
// in K2; pipelining and wgmma are later work.
#include "blocksparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace fattn {
namespace {

// ------------------------------------------------------------- K8b: dK, dV

// In the transposed tiles S^T and dP^T a thread's C element [nb][e] is key
// (warp * 16 + g + 8 * (e >> 1)) and query (nb * 8 + 2 * t + (e & 1)).
template <typename T, int D, int kBlockM>
__global__ void __launch_bounds__(kMmaThreads) bs_dkv_mma_kernel(const BsParams p) {
  constexpr int kStrideD = D + 8;
  __shared__ __align__(16) uint16_t k_s[kTileK * kStrideD];
  __shared__ __align__(16) uint16_t q_s[kBlockM * kStrideD];
  __shared__ __align__(16) uint16_t do_s[kBlockM * kStrideD];
  __shared__ float lse_s[kBlockM];  // log2 domain; +inf: the row sees nothing
  __shared__ float di_s[kBlockM];
  __shared__ uint32_t rh_s[kBlockM];  // row halves of the dropout hash
  __shared__ bool rok_s[kBlockM];     // the row is real and unpadded
  __shared__ bool cell_s[kBlockM];    // the row's cell at this kv tile

  const int ik = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int n0 = ik * kTileK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const size_t bh = (size_t)bb * p.h + hh;
  const uint16_t* k = bs_rows<uint16_t>(p, p.k, kOpK, bb, hh);
  const uint16_t* v = bs_rows<uint16_t>(p, p.v, kOpV, bb, hh);
  const uint16_t* q = bs_rows<uint16_t>(p, p.q, kOpQ, bb, hh);
  const uint16_t* dout = bs_rows<uint16_t>(p, p.dout, kOpDO, bb, hh);
  const long long ks = p.st[kOpK].s, vs = p.st[kOpV].s;
  const long long qs = p.st[kOpQ].s, dos = p.st[kOpDO].s;
  const float* lse = p.lse + bh * p.sq;
  const float* di = p.di + bh * p.sq;

  constexpr int kVecPerRow = D / 8;  // 16-byte vectors
  #pragma unroll
  for (int i = threadIdx.x; i < kTileK * kVecPerRow; i += kMmaThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < p.sk) x = *reinterpret_cast<const uint4*>(k + (n0 + r) * ks + c);
    *reinterpret_cast<uint4*>(k_s + r * kStrideD + c) = x;
  }
  // V rows of this warp's keys as A fragments, for dP^T = V dO^T.
  auto v_pair = [&](int key, int col) -> uint32_t {
    return key < p.sk ? ld_pair(v + key * vs + col) : 0u;
  };
  uint32_t va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    va[kk][0] = v_pair(key0, kk * 16 + 2 * t);
    va[kk][1] = v_pair(key0 + 8, kk * 16 + 2 * t);
    va[kk][2] = v_pair(key0, kk * 16 + 8 + 2 * t);
    va[kk][3] = v_pair(key0 + 8, kk * 16 + 8 + 2 * t);
  }
  const bool kok[2] = {bs_key_ok(p, bb, key0), bs_key_ok(p, bb, key0 + 8)};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  const int n = p.cnt[ik];
  for (int j = 0; j < n; ++j) {
    const int tile0 = p.idx[ik * p.max_n + j] * kTileQ;
    const bool full = p.full[ik * p.max_n + j] != 0;
    for (int m0 = tile0; m0 < tile0 + kTileQ && m0 < p.sq; m0 += kBlockM) {
      __syncthreads();  // the previous rows' q_s, do_s are read
      #pragma unroll
      for (int i = threadIdx.x; i < kBlockM * kVecPerRow; i += kMmaThreads) {
        const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = qv;
        if (m0 + r < p.sq) {
          qv = *reinterpret_cast<const uint4*>(q + (m0 + r) * qs + c);
          dv4 = *reinterpret_cast<const uint4*>(dout + (m0 + r) * dos + c);
        }
        *reinterpret_cast<uint4*>(q_s + r * kStrideD + c) = qv;
        *reinterpret_cast<uint4*>(do_s + r * kStrideD + c) = dv4;
      }
      for (int i = threadIdx.x; i < kBlockM; i += blockDim.x) {
        const int row = m0 + i;
        const float l = row < p.sq ? lse[row] : -INFINITY;
        lse_s[i] = l == -INFINITY ? INFINITY : l * kLog2e;
        di_s[i] = row < p.sq ? di[row] : 0.f;
        rh_s[i] = p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u;
        rok_s[i] = bs_row_ok(p, bb, row);
        cell_s[i] = !full && bs_cell_on(p, row, n0);
      }
      __syncthreads();

      float s[kBlockM / 8][4], dp[kBlockM / 8][4];
#pragma unroll
      for (int nb = 0; nb < kBlockM / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint16_t* kr = k_s + (warp * 16 + g) * kStrideD + kk * 16 + 2 * t;
          const uint32_t ka[4] = {ld_pair(kr), ld_pair(kr + 8 * kStrideD),
                                  ld_pair(kr + 8), ld_pair(kr + 8 * kStrideD + 8)};
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
          const bool vis = bs_visible(p, full, cell_s[ql], rok_s[ql], kok[e >> 1], m0 + ql, col);
          const float pv = vis ? exp2f(s[nb][e] * p.scale_log2 - lse_s[ql]) : 0.f;
          float pd = pv * p.drop.rp, dpd = dp[nb][e] * p.drop.rp;
          if (p.drop.on() && !keep_elem(rh_s[ql], col, p.drop.threshold)) pd = dpd = 0.f;
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
    }
  }

  uint16_t* dk_out = bs_rows<uint16_t>(p, p.dk, kOpDK, bb, hh);
  uint16_t* dv_out = bs_rows<uint16_t>(p, p.dv, kOpDV, bb, hh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.sk) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_out + key * p.st[kOpDK].s + c) =
          Mma<T>::pack(dk[dn][2 * r] * p.scale, dk[dn][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_out + key * p.st[kOpDV].s + c) =
          Mma<T>::pack(dv[dn][2 * r], dv[dn][2 * r + 1]);
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

// Thread (warp, g, t) owns rows row0 and row0 + 8 of the q tile, as in K1.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads) bs_dq_mma_kernel(const BsParams p) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) uint16_t k_s[kTileK * kStride];
  __shared__ __align__(16) uint16_t v_s[kTileK * kStride];
  __shared__ bool kok_s[kTileK];

  const int iq = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = iq * kTileQ + warp * 16 + g;
  const size_t bh = (size_t)bb * p.h + hh;
  const uint16_t* q = bs_rows<uint16_t>(p, p.q, kOpQ, bb, hh);
  const uint16_t* dout = bs_rows<uint16_t>(p, p.dout, kOpDO, bb, hh);
  const uint16_t* k = bs_rows<uint16_t>(p, p.k, kOpK, bb, hh);
  const uint16_t* v = bs_rows<uint16_t>(p, p.v, kOpV, bb, hh);
  const long long qs = p.st[kOpQ].s, dos = p.st[kOpDO].s;
  const long long ks = p.st[kOpK].s, vs = p.st[kOpV].s;

  // Q and dO rows of this warp as A fragments.
  auto pair = [&](const uint16_t* x, long long xs, int row, int col) -> uint32_t {
    return row < p.sq ? ld_pair(x + row * xs + col) : 0u;
  };
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = pair(q, qs, row0, kk * 16 + 2 * t);
    qa[kk][1] = pair(q, qs, row0 + 8, kk * 16 + 2 * t);
    qa[kk][2] = pair(q, qs, row0, kk * 16 + 8 + 2 * t);
    qa[kk][3] = pair(q, qs, row0 + 8, kk * 16 + 8 + 2 * t);
    da[kk][0] = pair(dout, dos, row0, kk * 16 + 2 * t);
    da[kk][1] = pair(dout, dos, row0 + 8, kk * 16 + 2 * t);
    da[kk][2] = pair(dout, dos, row0, kk * 16 + 8 + 2 * t);
    da[kk][3] = pair(dout, dos, row0 + 8, kk * 16 + 8 + 2 * t);
  }
  float lse2[2], di_r[2];
  bool rok[2];
  uint32_t rh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < p.sq ? p.lse[bh * p.sq + row] : -INFINITY;
    lse2[r] = l == -INFINITY ? INFINITY : l * kLog2e;  // exp2(x - inf) = 0
    di_r[r] = row < p.sq ? p.di[bh * p.sq + row] : 0.f;
    rok[r] = bs_row_ok(p, bb, row);
    rh[r] = p.drop.on() ? hash_row(p.drop.seed, (uint32_t)bh, row) : 0u;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n = p.cnt[iq];
  for (int j = 0; j < n; ++j) {
    const int k0 = p.idx[iq * p.max_n + j] * kTileK;
    const bool full = p.full[iq * p.max_n + j] != 0;
    __syncthreads();
    constexpr int kVecPerRow = D / 8;
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

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the 64 keys.
    float s[kTileK / 8][4], dp[kTileK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (nb * 8 + g) * kStride + kk * 16 + 2 * t;
        Mma<T>::run(s[nb], qa[kk], ld_pair(k_s + off), ld_pair(k_s + off + 8));
        Mma<T>::run(dp[nb], da[kk], ld_pair(v_s + off), ld_pair(v_s + off + 8));
      }
    }

    // s <- dS = p * (dP - di), dP dropped and rescaled.
    const bool cell = !full && bs_cell_on(p, row0, k0);
#pragma unroll
    for (int nb = 0; nb < kTileK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nb * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const bool vis = bs_visible(p, full, cell, rok[r], kok_s[cl], row0 + 8 * r, k0 + cl);
        const float pv = vis ? exp2f(s[nb][e] * p.scale_log2 - lse2[r]) : 0.f;
        float dpd = dp[nb][e] * p.drop.rp;
        if (p.drop.on() && !keep_elem(rh[r], k0 + cl, p.drop.threshold)) dpd = 0.f;
        s[nb][e] = pv * (dpd - di_r[r]);
      }
    }

    // dQ += dS K: the C fragments of two key n-blocks form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      const uint32_t dsa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* kr = k_s + (kk * 16 + 2 * t) * kStride + dn * 8 + g;
        Mma<T>::run(acc[dn], dsa, ld_col_pair(kr, kStride),
                    ld_col_pair(kr + 8 * kStride, kStride));
      }
    }
  }

  uint16_t* dq = bs_rows<uint16_t>(p, p.o, kOpO, bb, hh);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dq + row * p.st[kOpO].s + dn * 8 + 2 * t) =
          Mma<T>::pack(acc[dn][2 * r] * p.scale, acc[dn][2 * r + 1] * p.scale);
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

template <int D>
cudaError_t launch_dkv(const BsParams& p, int dtype, int b, cudaStream_t st) {
  const int nk = (p.sk + kTileK - 1) / kTileK;
  constexpr int kBlockM = D == 64 ? 64 : 32;
  switch (dtype) {
    case kBF16:
      bs_dkv_mma_kernel<__nv_bfloat16, D, kBlockM><<<dim3(nk, p.h, b), kMmaThreads, 0, st>>>(p);
      break;
    case kF16:
      bs_dkv_mma_kernel<__half, D, kBlockM><<<dim3(nk, p.h, b), kMmaThreads, 0, st>>>(p);
      break;
    case kF32:
      bs_dkv_f32_kernel<D><<<dim3(nk * (kTileK / 16), p.h, b), 256, 0, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BsParams& p, int dtype, int b, cudaStream_t st) {
  const int nq = (p.sq + kTileQ - 1) / kTileQ;
  switch (dtype) {
    case kBF16:
      bs_dq_mma_kernel<__nv_bfloat16, D><<<dim3(nq, p.h, b), kMmaThreads, 0, st>>>(p);
      break;
    case kF16:
      bs_dq_mma_kernel<__half, D><<<dim3(nq, p.h, b), kMmaThreads, 0, st>>>(p);
      break;
    case kF32:
      bs_dq_f32_kernel<D><<<dim3(nq * (kTileQ / 16), p.h, b), 256, 0, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
// strides as in fattn_blocksparse_fwd (that of o unused).
extern "C" int fattn_blocksparse_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv,
    const long long* strides, const void* q_idx,
    const void* q_cnt, const void* q_full, const void* rowmask,
    const void* q_valid, const void* k_valid, int b, int h, int sq, int sk,
    int d, int max_q, int ncells, float scale, int causal, unsigned seed,
    unsigned threshold, float rp, int dtype, void* stream) {
  using namespace fattn;
  if (bad_sizes(b, h, sq, sk, max_q, ncells)) return cudaErrorInvalidValue;
  BsParams p = bwd_params(q, k, v, dout, lse, di, strides, q_idx, q_cnt, q_full, rowmask,
                          q_valid, k_valid, h, sq, sk, max_q, ncells, scale,
                          causal, seed, threshold, rp);
  p.dk = dk;
  p.dv = dv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dkv<64>(p, dtype, b, st);
  if (d == 128) return launch_dkv<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}

// K8c. kv_idx, kv_cnt, kv_full: the layout's per-q-tile lists of kv tiles;
// strides as in fattn_blocksparse_fwd (o: dq; those of dk, dv unused).
extern "C" int fattn_blocksparse_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const long long* strides,
    const void* kv_idx,
    const void* kv_cnt, const void* kv_full, const void* rowmask,
    const void* q_valid, const void* k_valid, int b, int h, int sq, int sk,
    int d, int max_kv, int ncells, float scale, int causal, unsigned seed,
    unsigned threshold, float rp, int dtype, void* stream) {
  using namespace fattn;
  if (bad_sizes(b, h, sq, sk, max_kv, ncells)) return cudaErrorInvalidValue;
  BsParams p = bwd_params(q, k, v, dout, lse, di, strides, kv_idx, kv_cnt, kv_full,
                          rowmask, q_valid, k_valid, h, sq, sk, max_kv, ncells,
                          scale, causal, seed, threshold, rp);
  p.o = dq;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(p, dtype, b, st);
  if (d == 128) return launch_dq<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}
