// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel flash_attn_tpu/kernels/flash_fwd.py:_fwd_kernel
// (launched by flash_attention_fwd there). Exact attention with an online
// softmax: for each query row a running (max m, sum l, accumulator acc) is
// kept in fp32 while the block walks the K/V tiles, so the (sq, sk) score
// matrix never reaches device memory. Scores are taken in the log2 domain
// (scale * log2(e) folded into one constant) and exponentiated with exp2.
//
// Layout: q (b, h, sq, d), k and v (b, h_kv, sk, d), out (b, h, sq, d), all
// contiguous; lse (b, h, sq) fp32. GQA: query head hh reads kv head
// hh / (h / h_kv) in place. Causal masking is top-left aligned (key j is
// visible from query i iff j <= i), as in the JAX package. Ragged sq and sk
// are masked here; d is not padded. Rows with no visible key give out = 0
// and lse = -inf. The mask is csrc/mask.cuh, shared with the backward.
//
// Dropout (flash_fwd.py:363-377 there): the keep mask is the coordinate hash
// of csrc/prng.cuh on (seed, b * h + head, row, col), its row half computed
// once per thread. The normalizer l sums the un-dropped p, dropped p is
// zeroed before P @ V, 1/(1-p) folds into the final scaling, and the lse is
// that of the un-dropped scores, so the backward can rebuild p from it.
//
// Grid: one block per (64-row query tile, head, batch).
//   - bf16 / fp16: four warps, 16 query rows each, on the tensor cores with
//     mma.sync m16n8k16 (fp32 accumulate). The score fragment is reused as
//     the A operand of P @ V without a trip through shared memory.
//   - fp32: 256 threads, four per query row, FMA on the CUDA cores (the
//     tensor cores would round fp32 inputs to tf32).
// Bound: tensor-core math at prefill sizes. This first version stages K/V
// tiles through shared memory with plain loads and one buffer, so loads and
// math do not overlap yet; wgmma, TMA and a pipelined ring of tiles are the
// later work.
#include "common.cuh"
#include "mask.cuh"
#include "mma.cuh"
#include "prng.cuh"

namespace fattn {
namespace {

constexpr int kBlockQ = 64;

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
};

// ---------------------------------------------------------------- mma path

// Fragment layouts: csrc/mma.cuh.
template <typename T, int D>
__global__ void __launch_bounds__(128)
    flash_fwd_mma_kernel(const FwdParams p) {
  constexpr int kBlockK = 64;
  constexpr int kStride = D + 8;  // shared row stride in elements: no bank conflicts
  __shared__ __align__(16) uint16_t k_s[kBlockK * kStride];
  __shared__ __align__(16) uint16_t v_s[kBlockK * kStride];

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.h_kv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const uint16_t* q =
      static_cast<const uint16_t*>(p.q) + (size_t)(bb * p.h + hh) * p.sq * D;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) +
                      (size_t)(bb * p.h_kv + hk) * p.sk * D;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) +
                      (size_t)(bb * p.h_kv + hk) * p.sk * D;

  auto q_pair = [&](int row, int col) -> uint32_t {
    return row < p.sq
               ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * D + col)
               : 0u;
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
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
  uint32_t rh[2] = {0u, 0u};  // row halves of the dropout hash
  if (p.drop.on()) {
    const uint32_t bh = bb * p.h + hh;
    rh[0] = hash_row(p.drop.seed, bh, row0);
    rh[1] = hash_row(p.drop.seed, bh, row0 + 8);
  }

  const int n_keys = keys_for_rows(q0, kBlockQ, p.sk, p.causal);
  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    constexpr int kVecPerRow = D / 8;  // 16-byte vectors
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += blockDim.x) {
      const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = k_s + (nb * 8 + g) * kStride + kk * 16 + 2 * t;
        Mma<T>::run(s[nb], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nb][e] * p.scale_log2;
        if (!key_visible(row, col, p.sk, p.causal)) x = -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with nothing visible yet keeps m = -inf; exp2 against 0
      // then gives p = 0 and alpha = 0 instead of NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kBlockK / 8; ++nb) {
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
      for (int nb = 0; nb < kBlockK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t col = k0 + nb * 8 + 2 * t + (e & 1);
          if (!keep_elem(rh[e >> 1], col, p.drop.threshold)) s[nb][e] = 0.f;
        }
      }
    }

    // O += P V: the C fragments of two key n-blocks form one A fragment.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
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
  uint16_t* out =
      static_cast<uint16_t*>(p.o) + (size_t)(bb * p.h + hh) * p.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.sq) continue;
    const float inv = l[r] > 0.f ? (1.f / l[r]) * p.drop.rp : 0.f;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(out + (size_t)row * D + dn * 8 + 2 * t) =
          Mma<T>::pack(o[dn][2 * r] * inv, o[dn][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(size_t)(bb * p.h + hh) * p.sq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : -INFINITY;
    }
  }
}

// --------------------------------------------------------------- fp32 path

// Four threads per query row; thread t4 owns dims t4, t4 + 4, ... of q and of
// the accumulator, so a quad reads four consecutive floats of a K/V row.
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const FwdParams p) {
  constexpr int kBlockK = 32;
  constexpr int kPer = D / 4;
  __shared__ __align__(16) float k_s[kBlockK * D];
  __shared__ __align__(16) float v_s[kBlockK * D];

  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (p.h / p.h_kv);
  const int t4 = threadIdx.x & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + (threadIdx.x >> 2);

  const float* q =
      static_cast<const float*>(p.q) + (size_t)(bb * p.h + hh) * p.sq * D;
  const float* k = static_cast<const float*>(p.k) +
                   (size_t)(bb * p.h_kv + hk) * p.sk * D;
  const float* v = static_cast<const float*>(p.v) +
                   (size_t)(bb * p.h_kv + hk) * p.sk * D;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < p.sq ? q[(size_t)row * D + i * 4 + t4] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint32_t rh =
      p.drop.on() ? hash_row(p.drop.seed, bb * p.h + hh, row) : 0u;

  const int n_keys = keys_for_rows(q0, kBlockQ, p.sk, p.causal);
  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * D / 4; i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const float4*>(k + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(v + (size_t)(k0 + r) * D + c);
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
      s[j] = key_visible(row, col, p.sk, p.causal) ? a * p.scale_log2
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
  float* out = static_cast<float*>(p.o) + (size_t)(bb * p.h + hh) * p.sq * D;
  const float inv = l > 0.f ? (1.f / l) * p.drop.rp : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[(size_t)row * D + i * 4 + t4] = acc[i] * inv;
  if (p.lse != nullptr && t4 == 0) {
    p.lse[(size_t)(bb * p.h + hh) * p.sq + row] =
        l > 0.f ? m * kLn2 + logf(l) : -INFINITY;
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, int dtype, int b, cudaStream_t st) {
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, p.h, b);
  switch (dtype) {
    case kBF16:
      flash_fwd_mma_kernel<__nv_bfloat16, D><<<grid, 128, 0, st>>>(p);
      break;
    case kF16:
      flash_fwd_mma_kernel<__half, D><<<grid, 128, 0, st>>>(p);
      break;
    case kF32:
      flash_fwd_f32_kernel<D><<<grid, 256, 0, st>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace fattn

extern "C" int fattn_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int h, int h_kv,
                               int sq, int sk, int d, float scale, int causal,
                               unsigned seed, unsigned threshold, float rp,
                               int dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || h <= 0 || h_kv <= 0 || h % h_kv != 0 || sq <= 0 || sk <= 0) {
    return cudaErrorInvalidValue;
  }
  const FwdParams p{q,  k,  v,  o,  static_cast<float*>(lse),
                    h,  h_kv, sq, sk, scale * kLog2e,
                    causal != 0, Dropout{seed, threshold, rp}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(p, dtype, b, st);
  if (d == 128) return launch<128>(p, dtype, b, st);
  return cudaErrorInvalidValue;
}
