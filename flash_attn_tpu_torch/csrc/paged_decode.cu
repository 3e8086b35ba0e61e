// Paged decode attention for Hopper (sm_90a): K5.
//
// Replaces both TPU routes of one computation:
// flash_attn_tpu/kernels/decode.py:_decode_kernel (BlockSpec pipeline, taken
// for head_dim 64) and :_decode_dma_kernel (manual DMA, taken when head_dim
// % 128 == 0). One query token per sequence attends to its keys, which lie
// in pages scattered over the cache and are found through the page table.
// The visibility predicates are csrc/paged.cuh, shared with K6.
//
// Layout: q (b, h_kv * group, d) through its batch and head strides (the
// last dimension contiguous), so the models hand over a view of their
// fused projection; k_pages and v_pages (h_kv, num_pages, page_size, d)
// contiguous; lengths (b,) int32; page_table (b, pages_max) int32; out (b,
// h_kv * group, d) contiguous. The query sits at position length - 1, so
// every key below length is visible; a sequence with length <= 0 gives out =
// 0 (decode.py:168, l == 0), and a length past the table is cut to it.
//
// Bound: device-memory bytes of the live pages (one query row per head:
// 4 flops per cached key element, far below the card's ratio of flops to
// bytes). The design moves those bytes at the card's rate:
//   - Split-KV grid (split, kv head, sequence): the host cuts the page table
//     into ranges of whole pages (csrc/paged_split.cuh) so a small batch
//     still fills the SMs, and a merge kernel combines the splits' partials
//     in split order (deterministic). A split starting at or past the
//     sequence's length writes an empty partial and exits.
//   - One block serves the whole GQA group of its kv head, so each K/V byte
//     is read once.
//   - bf16 / fp16 (paged_decode_mma_kernel): 64-key segments of K and V
//     stream into a ring of 3 shared-memory stages by 16-byte cp.async
//     (every thread copies its pieces, so two segments are in flight while
//     one is scored), rows padded by 16 bytes so the fragment loads are
//     conflict-free; keys past the split's end are zero-filled, never read.
//     The group's query rows, padded to 16, are the A operand of mma.sync
//     m16n8k16 held in registers; each of the 4 warps takes 16 keys of a
//     segment: S = Q K^T, an fp32 online softmax in the log2 domain over
//     the warp's own keys, and O += P V with the score fragment reused as
//     the A operand. At the end of the split the warps' (m, l, O) merge in
//     warp order through shared memory. The tensor cores, not the CUDA
//     cores, because the CUDA-core kernel below is latency-bound: 2.8x
//     slower at Llama-3-8B's decode shape (PERF.md).
//   - fp32 (paged_decode_f32_kernel): CUDA cores, so the products stay in
//     full fp32: 32-key segments by bulk copies
//     (cp.async.bulk, one per run of keys inside a page) on an mbarrier per
//     stage; eight lanes per key; a warp per row runs the online softmax;
//     P @ V by threads that own column pairs.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "paged.cuh"
#include "paged_split.cuh"

namespace fattn {
namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kMaxGroup = 16;

struct DecodeParams {
  const void* q;
  long long q_sb, q_sh;  // element strides of q's batch and head
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_table;
  void* out;
  SplitKV sp;
  int h_kv, group, num_pages, page_size, pages_max;
  float scale_log2;
};

// The keys [k_begin, k_end) a block's split covers in its sequence.
struct SplitKeys {
  int k_begin, k_end;
};

__device__ __forceinline__ SplitKeys split_keys(const DecodeParams& p,
                                                int bb) {
  const int length = paged_length(p.lengths[bb], p.pages_max, p.page_size);
  const int k_begin = blockIdx.x * p.sp.split_keys;
  return SplitKeys{k_begin, min(length, k_begin + p.sp.split_keys)};
}

// Writes row r's result (output row `row`): out, or the split's partial
// of o = acc / l and its lse (log2 units) from the running max m.
template <typename T>
__device__ __forceinline__ void write_row(const DecodeParams& p, int row,
                                          int c, float a0, float a1, float m,
                                          float l, int d) {
  const float inv = l > 0.f ? 1.f / l : 0.f;
  if (p.sp.o_part == nullptr) {
    T* out = static_cast<T*>(p.out) + (size_t)row * d + c;
    out[0] = from_float<T>(a0 * inv);
    out[1] = from_float<T>(a1 * inv);
    return;
  }
  if (l > 0.f) {
    *reinterpret_cast<float2*>(partial_o(p.sp, blockIdx.x, row, d) + c) =
        make_float2(a0 * inv, a1 * inv);
  }
  if (c == 0) *partial_lse(p.sp, blockIdx.x, row, d) = partial_lse2(m, l);
}

// ---------------------------------------------------------------- mma path

constexpr int kKeys = 64;  // keys per segment, 16 per warp

template <int D>
struct MmaLayout {
  static constexpr int kStride = D + 8;  // padded row, in elements
  static constexpr int kSeg = kKeys * kStride;
  // The K and V rings; after the walk the same bytes hold the warps'
  // (m, l) and O for their merge.
  static constexpr int kBytes = 2 * 2 * kStages * kSeg;
  static_assert(4 * (4 * 16 * D + 2 * 4 * 16) <= kBytes, "merge scratch");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_mma_kernel(const DecodeParams p) {
  using L = MmaLayout<D>;
  constexpr int kS = L::kStride;
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* k_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* v_s = k_s + kStages * L::kSeg;

  const int hk = blockIdx.y, bb = blockIdx.z;
  const int G = p.group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ps = p.page_size;
  const SplitKeys sk = split_keys(p, bb);
  const int n_seg =
      sk.k_end > sk.k_begin ? (sk.k_end - sk.k_begin + kKeys - 1) / kKeys : 0;
  const size_t head = (size_t)hk * p.num_pages * ps * D;
  const uint16_t* kh = static_cast<const uint16_t*>(p.k_pages) + head;
  const uint16_t* vh = static_cast<const uint16_t*>(p.v_pages) + head;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;

  // Segment i into stage i % kStages: 16-byte pieces, rows past the
  // split's keys zero-filled; one commit group per segment.
  auto load_seg = [&](int i) {
    const int s = i % kStages;
    const int k0 = sk.k_begin + i * kKeys;
    constexpr int kPieces = D / 8;
    for (int c = tid; c < kKeys * kPieces; c += kThreads) {
      const int r = c / kPieces, col = (c % kPieces) * 8;
      const int pos = k0 + r;
      const bool in = pos < sk.k_end;
      const size_t src =
          in ? ((size_t)tbl[pos / ps] * ps + pos % ps) * D + col : 0;
      const int dst = s * L::kSeg + r * kS + col;
      cp_async16(k_s + dst, kh + src, in);
      cp_async16(v_s + dst, vh + src, in);
    }
  };

  // The group's rows (padded to 16 with zeros) as the A operand of S = Q
  // K^T (csrc/mma.cuh fragment layout).
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + bb * p.q_sb +
                      (long long)hk * G * p.q_sh;
  auto q_pair = [&](int r, int col) -> uint32_t {
    return r < G && n_seg > 0 ? ld_pair(q + r * p.q_sh + col) : 0u;
  };
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = q_pair(g, kk * 16 + 2 * t);
    qa[kk][1] = q_pair(g + 8, kk * 16 + 2 * t);
    qa[kk][2] = q_pair(g, kk * 16 + 8 + 2 * t);
    qa[kk][3] = q_pair(g + 8, kk * 16 + 8 + 2 * t);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_seg) load_seg(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_seg; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of segment i
    __syncthreads();  // everyone's; and segment i - 1's stage is free
    if (i + kStages - 1 < n_seg) load_seg(i + kStages - 1);
    cp_async_commit();

    const int s = i % kStages;
    const int key0 = warp * 16;  // this warp's keys of the segment
    const uint16_t* ks = k_s + s * L::kSeg + key0 * kS;
    const uint16_t* vs = v_s + s * L::kSeg + key0 * kS;
    // S = Q K^T: 16 rows x the warp's 16 keys, two n-blocks of 8.
    float sc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kr = ks + (nb * 8 + g) * kS + kk * 16 + 2 * t;
        Mma<T>::run(sc[nb], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }
    // Keys past the split's end (zero-filled) are not visible.
    const int k0 = sk.k_begin + i * kKeys + key0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nb][e] * p.scale_log2;
        if (k0 + nb * 8 + 2 * t + (e & 1) >= sk.k_end) x = -INFINITY;
        sc[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Nothing visible yet (a warp whose keys are all past the end): m
      // stays -inf; exp2 against 0 gives p = 0 and alpha = 0, not NaN.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = fast_exp2(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb][e] = fast_exp2(sc[nb][e] - base[e >> 1]);
        rs[e >> 1] += sc[nb][e];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    // O += P V: the two n-blocks' C fragments form one A fragment.
    const uint32_t pa[4] = {
        Mma<T>::pack(sc[0][0], sc[0][1]), Mma<T>::pack(sc[0][2], sc[0][3]),
        Mma<T>::pack(sc[1][0], sc[1][1]), Mma<T>::pack(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
      const uint16_t* vr = vs + 2 * t * kS + dn * 8 + g;
      Mma<T>::run(o[dn], pa, ld_col_pair(vr, kS), ld_col_pair(vr + 8 * kS, kS));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free for the merge

  // The warps' states through shared memory: m and l per (warp, row), O
  // per (warp, row, column).
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + 4 * 16;
  float* o_s = l_s + 4 * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      m_s[warp * 16 + g + 8 * r] = m[r];
      l_s[warp * 16 + g + 8 * r] = l[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<float2*>(o_s + (warp * 16 + g + 8 * r) * D + dn * 8 +
                                 2 * t) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
    }
  }
  __syncthreads();

  // Row r, columns c, c + 1: the four warps merged in warp order.
  const int h = p.h_kv * G;
  for (int i = tid; i < G * D / 2; i += kThreads) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    float mr = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mr = fmaxf(mr, m_s[w * 16 + r]);
    float lr = 0.f, a0 = 0.f, a1 = 0.f;
    if (mr != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float sc = fast_exp2(m_s[w * 16 + r] - mr);  // 0 for -inf
        const float2 ow =
            *reinterpret_cast<const float2*>(o_s + (w * 16 + r) * D + c);
        lr += l_s[w * 16 + r] * sc;
        a0 += ow.x * sc;
        a1 += ow.y * sc;
      }
    }
    write_row<T>(p, bb * h + hk * G + r, c, a0, a1, mr, lr, D);
  }
}

// --------------------------------------------------------------- fp32 path

constexpr int kF32Keys = 32;  // keys per segment

template <int D>
struct F32Layout {
  static constexpr int kSeg = kF32Keys * D;  // floats of K (V) per stage
  // mbarriers (padded to 128 bytes), the K and V rings, q, the scores, m,
  // l and alpha per row.
  static constexpr int kBytes =
      128 + 4 * (2 * kStages * kSeg + kMaxGroup * (D + kF32Keys + 3));
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_f32_kernel(const DecodeParams p) {
  using L = F32Layout<D>;
  constexpr int kChunks = D / 32;            // 128-byte pieces of a row
  constexpr int kCols = D / 2;               // column pairs of a row
  constexpr int kRowStep = kThreads / kCols;  // rows P @ V covers at once
  constexpr int kMaxRows = kMaxGroup / kRowStep;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + 128);
  float* v_s = k_s + kStages * L::kSeg;
  float* q_s = v_s + kStages * L::kSeg;
  float* s_s = q_s + kMaxGroup * D;
  float* m_s = s_s + kMaxGroup * kF32Keys;
  float* l_s = m_s + kMaxGroup;
  float* a_s = l_s + kMaxGroup;

  const int hk = blockIdx.y, bb = blockIdx.z;
  const int G = p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ps = p.page_size;
  const SplitKeys sk = split_keys(p, bb);
  const int n_seg = sk.k_end > sk.k_begin
                        ? (sk.k_end - sk.k_begin + kF32Keys - 1) / kF32Keys
                        : 0;
  const size_t head = (size_t)hk * p.num_pages * ps * D;
  const float* kh = static_cast<const float*>(p.k_pages) + head;
  const float* vh = static_cast<const float*>(p.v_pages) + head;
  const int* tbl = p.page_table + (size_t)bb * p.pages_max;

  // The live keys of segment i into stage i % kStages: one bulk copy of K
  // and one of V per run of keys inside a page.
  auto load_seg = [&](int i) {
    const int s = i % kStages;
    const int k0 = sk.k_begin + i * kF32Keys;
    const int n = min(kF32Keys, sk.k_end - k0);
    mbar_arrive_expect_tx(&full[s], 2 * n * D * 4);
    for (int pos = k0; pos < k0 + n;) {
      const int off = pos % ps;
      const int run = min(ps - off, k0 + n - pos);
      const size_t src = ((size_t)tbl[pos / ps] * ps + off) * D;
      const int dst = s * L::kSeg + (pos - k0) * D;
      bulk_load(k_s + dst, kh + src, run * D * 4, &full[s]);
      bulk_load(v_s + dst, vh + src, run * D * 4, &full[s]);
      pos += run;
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int i = 0; i < kStages && i < n_seg; ++i) load_seg(i);
  }
  const float* q = static_cast<const float*>(p.q) + bb * p.q_sb +
                   (long long)hk * G * p.q_sh;
  for (int i = tid; i < G * D; i += kThreads) {
    // scores come out in log2 units
    q_s[i] = q[(i / D) * p.q_sh + i % D] * p.scale_log2;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // P @ V: this thread's column pair c2 of rows r0, r0 + kRowStep, ...
  const int c2 = tid % kCols, r0 = tid / kCols;
  const int n_rows = r0 < G ? (G - r0 + kRowStep - 1) / kRowStep : 0;
  float acc[kMaxRows][2];
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) acc[k][0] = acc[k][1] = 0.f;
  __syncthreads();

  const int g8 = lane >> 3, l8 = lane & 7;
  for (int i = 0; i < n_seg; ++i) {
    const int s = i % kStages;
    const int n = min(kF32Keys, sk.k_end - (sk.k_begin + i * kF32Keys));
    const float* k_st = k_s + s * L::kSeg;
    const float* v_st = v_s + s * L::kSeg;
    mbar_wait(&full[s], (i / kStages) & 1);

    // Scores: lanes 8 g8 .. 8 g8 + 7 take key j; lane l8 reads 16 bytes of
    // each 128-byte piece of its row. Keys past n are never written.
    for (int j0 = warp * 4; j0 < n; j0 += kThreads / 8) {
      const int j = j0 + g8;
      float4 kf[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        kf[c] = j < n ? *reinterpret_cast<const float4*>(k_st + j * D +
                                                         c * 32 + l8 * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = 0; r < G; ++r) {
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + r * D + c * 32 + l8 * 4);
          a += qv.x * kf[c].x + qv.y * kf[c].y + qv.z * kf[c].z +
               qv.w * kf[c].w;
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        a += __shfl_xor_sync(0xffffffffu, a, 4);
        if (l8 == 0 && j < n) s_s[r * kF32Keys + j] = a;
      }
    }
    __syncthreads();

    // Online softmax, a warp per row: s_s <- p, and the row's alpha.
    for (int r = warp; r < G; r += kThreads / 32) {
      const float x = lane < n ? s_s[r * kF32Keys + lane] : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(x));  // finite: n >= 1
      const float e = lane < n ? exp2f(x - m_new) : 0.f;
      if (lane < n) s_s[r * kF32Keys + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 from m = -inf
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < n_rows) {
        const float alpha = a_s[r0 + k * kRowStep];
        acc[k][0] *= alpha;
        acc[k][1] *= alpha;
      }
    }
    for (int j = 0; j < n; ++j) {
      const float2 v2 = *reinterpret_cast<const float2*>(v_st + j * D + 2 * c2);
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) {
        if (k < n_rows) {
          const float pj = s_s[(r0 + k * kRowStep) * kF32Keys + j];
          acc[k][0] = fmaf(pj, v2.x, acc[k][0]);
          acc[k][1] = fmaf(pj, v2.y, acc[k][1]);
        }
      }
    }
    __syncthreads();  // stage s and the scores are free
    if (tid == 0 && i + kStages < n_seg) load_seg(i + kStages);
  }

  const int h = p.h_kv * G;
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    if (k >= n_rows) continue;
    const int r = r0 + k * kRowStep;
    write_row<float>(p, bb * h + hk * G + r, 2 * c2, acc[k][0], acc[k][1],
                     m_s[r], l_s[r], D);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const DecodeParams& p, int b, cudaStream_t st) {
  void (*kernel)(const DecodeParams);
  int bytes;
  if constexpr (sizeof(T) == 4) {
    kernel = paged_decode_f32_kernel<D>;
    bytes = F32Layout<D>::kBytes;
  } else {
    kernel = paged_decode_mma_kernel<T, D>;
    bytes = MmaLayout<D>::kBytes;
  }
  // Once per kernel and process (the first launch, on the current device).
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(p.sp.n_splits, p.h_kv, b), kThreads, bytes, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.sp.o_part == nullptr) return err;
  return launch_merge<T, D>(p.sp, static_cast<T*>(p.out), st);
}

template <typename T>
cudaError_t launch(const DecodeParams& p, int d, int b, cudaStream_t st) {
  if (d == 64) return launch_typed<T, 64>(p, b, st);
  if (d == 128) return launch_typed<T, 128>(p, b, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace fattn

// q_sb, q_sh: q's batch and head element strides (its last dimension
// contiguous, rows 4-byte aligned). partials: fp32 scratch of n_splits * b
// * h * (d + 1) floats (csrc/paged_split.cuh), or nullptr when n_splits ==
// 1; split_keys: keys per split, a multiple of page_size.
extern "C" int fattn_paged_decode(const void* q, long long q_sb,
                                  long long q_sh, const void* k_pages,
                                  const void* v_pages, const void* lengths,
                                  const void* page_table, void* out,
                                  void* partials, int b, int h_kv, int group,
                                  int num_pages, int page_size, int pages_max,
                                  int n_splits, int split_keys, int d,
                                  float scale, int dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || h_kv <= 0 || group <= 0 || group > kMaxGroup ||
      num_pages <= 0 || page_size <= 0 || pages_max <= 0 || n_splits <= 0 ||
      split_keys <= 0 || split_keys % page_size != 0 ||
      (n_splits > 1) != (partials != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const DecodeParams p{q,
                       q_sb,
                       q_sh,
                       k_pages,
                       v_pages,
                       static_cast<const int*>(lengths),
                       static_cast<const int*>(page_table),
                       out,
                       SplitKV{static_cast<float*>(partials), n_splits,
                               split_keys, b * h_kv * group},
                       h_kv,
                       group,
                       num_pages,
                       page_size,
                       pages_max,
                       scale * kLog2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(p, d, b, st);
    case kF16:
      return launch<__half>(p, d, b, st);
    case kBF16:
      return launch<__nv_bfloat16>(p, d, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bf16/fp16 kernel at head dim d (0: none).
extern "C" int fattn_paged_decode_smem(int d) {
  using namespace fattn;
  return d == 64 ? MmaLayout<64>::kBytes : d == 128 ? MmaLayout<128>::kBytes : 0;
}
