// The elementwise chain of the Llama serving phases
// (flash_attn_tpu_torch/models/llama_decode.py) as three kernels for Hopper
// (sm_90a): residual add + RMSNorm, QK-norm + rotary, and SwiGLU.
//
// They replace no Pallas kernel: on the TPU, XLA fuses this chain into the
// products around it. Written op by op in eager PyTorch it was about 44
// launches a Mistral-7B layer and 62 a Qwen3-30B-A3B one (a cast, a power, a
// mean, an add, a rsqrt, two products and a cast for each RMSNorm; the
// rotary tables rebuilt in every layer; a cat, two products and an add for
// each of q and k), each a full fp32 pass over the activations. Each kernel
// here reads its inputs once, computes in fp32 registers and writes once.
//
// Bound: device-memory bytes. A 512-token chunk of 8 rows of Mistral-7B
// moves per layer 2 x (read x and d, write x + d and its norm: 4 x 33.6 MB),
// rotary in place on q and k (2 x 42 MB) and SwiGLU (three 117 MB passes).
// In decode (32-64 rows) each launch is a few microseconds and the count of
// launches in the graph, not the bytes, is what is saved.
//
// Numerics follow the plain chain (kernels/llama_chain.py twins): the
// residual sum is rounded to the activation type before its statistics are
// taken (x + d in PyTorch); the norm is x * rsqrt(mean(x^2) + eps), times
// the weight, then one rounding; QK-norm is rounded before the rotation, as
// the plain q_norm's output is; the rotation's two products and its sum are
// rounded one by one (__fmul_rn / __fadd_rn: no contraction into an fma),
// as PyTorch's three ops round them, from cos/sin of fl(pos * inv_freq) by
// the accurate sincosf (no fast math: positions reach thousands of
// radians). SwiGLU rounds once: silu(gate) * up in fp32.
//
// Kernel names keep clear of the benchmark's kernel classes
// (portbench/harness/common.py KERNEL_CLASSES), so its breakdown counts
// them as elementwise work.
#include "common.cuh"

namespace fattn {
namespace {

// A 16-byte vector of N elements of T, as floats.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[Vec<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) f[j] = to_float(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[Vec<T>::N]) {
  uint4 v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) e[j] = from_float<T>(f[j]);
  return v;
}

// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// ------------------------------------------------ residual add + RMSNorm

constexpr int kNormThreads = 256;
constexpr int kNormVecs = 8;  // vectors a thread holds: rows to 16,384 (bf16)

// Block = one row of n elements: s = x + d (rounded to T; s = x without d)
// is held in registers, written to res (with d), and out = s * rsqrt(mean
// (s^2) + eps) * w. x and d rows are x_rs / d_rs elements apart; res and
// out are contiguous.
template <typename T, typename W>
__global__ void __launch_bounds__(kNormThreads)
    add_rmsnorm_kernel(const T* x, const T* d, const W* w, T* res, T* out,
                       long long x_rs, long long d_rs, int n, float eps) {
  constexpr int N = Vec<T>::N;
  const long long row = blockIdx.x;
  const int vecs = n / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_rs);
  const uint4* dr =
      d == nullptr ? nullptr : reinterpret_cast<const uint4*>(d + row * d_rs);
  uint4* rr = reinterpret_cast<uint4*>(res + row * n);
  uint4* orow = reinterpret_cast<uint4*>(out + row * n);
  uint4 s[kNormVecs];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kNormVecs; ++u) {
    const int i = u * blockDim.x + threadIdx.x;
    if (i < vecs) {
      float f[N];
      unpack<T>(xr[i], f);
      if (dr != nullptr) {
        float g[N];
        unpack<T>(dr[i], g);
#pragma unroll
        for (int j = 0; j < N; ++j) f[j] = round_to<T>(__fadd_rn(f[j], g[j]));
        rr[i] = pack<T>(f);
      }
      s[u] = pack<T>(f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  __shared__ float part[kNormThreads / 32];
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < (int)blockDim.x / 32; ++i) total += part[i];
  const float r = rsqrtf(__fdiv_rn(total, (float)n) + eps);
#pragma unroll
  for (int u = 0; u < kNormVecs; ++u) {
    const int i = u * blockDim.x + threadIdx.x;
    if (i < vecs) {
      float f[N], wf[N];
      unpack<T>(s[u], f);
      if constexpr (sizeof(W) == sizeof(T)) {
        unpack<W>(reinterpret_cast<const uint4*>(w)[i], wf);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) wf[j] = to_float(w[i * N + j]);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], r), wf[j]);
      orow[i] = pack<T>(f);
    }
  }
}

// -------------------------------------------------- QK-norm + rotary

constexpr int kRopeWarps = 8;  // (token, head) rows of a block
constexpr int kMaxHalf = 128;  // head_dim up to 256
constexpr int kRopePairs = kMaxHalf / 32;

struct RopeTensor {
  void* x;
  long long sb, ss, sh;  // element strides of batch, token and head
  const void* norm_w;    // (hd,) QK-norm weight, or null
  int heads;
};

// Block (token, group of kRopeWarps heads over q's then k's): cos/sin of
// the token's position for every frequency once into shared memory, then a
// warp per head row: QK-norm (if weighted), rotate, write in place.
template <typename T, typename W>
__global__ void __launch_bounds__(kRopeWarps * 32)
    qk_rope_kernel(RopeTensor q, RopeTensor k, const long long* pos,
                   long long p_sb, long long p_ss, const float* inv_freq,
                   int s, int half, float eps) {
  __shared__ float cs[kMaxHalf], sn[kMaxHalf];
  const int bb = blockIdx.x / s, tt = blockIdx.x % s;
  const float p = __ll2float_rn(pos[bb * p_sb + tt * p_ss]);
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    sincosf(__fmul_rn(p, inv_freq[j]), &sn[j], &cs[j]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int head = blockIdx.y * kRopeWarps + warp;
  const bool is_q = head < q.heads;
  if (!is_q) head -= q.heads;
  if (head >= (is_q ? q.heads : k.heads)) return;
  // fields picked one by one: a reference to either parameter would copy
  // both to the stack
  T* row = static_cast<T*>(is_q ? q.x : k.x) + bb * (is_q ? q.sb : k.sb) +
           tt * (is_q ? q.ss : k.ss) + head * (is_q ? q.sh : k.sh);
  const W* w = static_cast<const W*>(is_q ? q.norm_w : k.norm_w);
  float lo[kRopePairs], hi[kRopePairs];
#pragma unroll
  for (int u = 0; u < kRopePairs; ++u) {
    const int j = lane + 32 * u;
    lo[u] = hi[u] = 0.f;
    if (j < half) {
      lo[u] = to_float(row[j]);
      hi[u] = to_float(row[j + half]);
    }
  }
  if (w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < kRopePairs; ++u) {
      ss = fmaf(lo[u], lo[u], ss);
      ss = fmaf(hi[u], hi[u], ss);
    }
    const float r = rsqrtf(__fdiv_rn(warp_sum(ss), (float)(2 * half)) + eps);
#pragma unroll
    for (int u = 0; u < kRopePairs; ++u) {
      const int j = lane + 32 * u;
      if (j < half) {
        lo[u] = round_to<T>(__fmul_rn(__fmul_rn(lo[u], r), to_float(w[j])));
        hi[u] = round_to<T>(
            __fmul_rn(__fmul_rn(hi[u], r), to_float(w[j + half])));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRopePairs; ++u) {
    const int j = lane + 32 * u;
    if (j < half) {
      const float c = cs[j], sv = sn[j];
      // x * cos + rotate_half(x) * sin, rotate_half(x) = (-x_hi, x_lo)
      row[j] = from_float<T>(__fsub_rn(__fmul_rn(lo[u], c),
                                       __fmul_rn(hi[u], sv)));
      row[j + half] = from_float<T>(__fadd_rn(__fmul_rn(hi[u], c),
                                              __fmul_rn(lo[u], sv)));
    }
  }
}

// ------------------------------------------------------------- SwiGLU

constexpr int kGluThreads = 256;

// Block (row, slab of vectors): out = silu(gate) * up for one 16-byte
// vector a thread. gate and up rows are g_rs / u_rs elements apart (the
// two halves of the experts' fused product are strided views); out is
// contiguous.
template <typename T>
__global__ void __launch_bounds__(kGluThreads)
    swiglu_kernel(const T* gate, const T* up, T* out, long long g_rs,
                  long long u_rs, int n) {
  constexpr int N = Vec<T>::N;
  const long long row = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= n / N) return;
  float g[N], u[N];
  unpack<T>(reinterpret_cast<const uint4*>(gate + row * g_rs)[i], g);
  unpack<T>(reinterpret_cast<const uint4*>(up + row * u_rs)[i], u);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    g[j] = __fmul_rn(__fdiv_rn(g[j], __fadd_rn(1.f, expf(-g[j]))), u[j]);
  }
  reinterpret_cast<uint4*>(out + row * n)[i] = pack<T>(g);
}

// --------------------------------------------------------------- host

// Launch::run<T, W>(args, stream) for the types of two dtype codes: the
// activations' and the weights'.
template <class Launch, typename T>
int by_weight(int w_dtype, const typename Launch::Args& a, cudaStream_t st) {
  switch (w_dtype) {
    case kF32:
      return Launch::template run<T, float>(a, st);
    case kF16:
      return Launch::template run<T, __half>(a, st);
    case kBF16:
      return Launch::template run<T, __nv_bfloat16>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class Launch>
int by_types(int dtype, int w_dtype, const typename Launch::Args& a,
             cudaStream_t st) {
  switch (dtype) {
    case kF32:
      return by_weight<Launch, float>(w_dtype, a, st);
    case kF16:
      return by_weight<Launch, __half>(w_dtype, a, st);
    case kBF16:
      return by_weight<Launch, __nv_bfloat16>(w_dtype, a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

struct NormLaunch {
  struct Args {
    const void *x, *d, *w;
    void *res, *out;
    long long x_rs, d_rs;
    int rows, n, threads;
    float eps;
  };
  template <typename T, typename W>
  static int run(const Args& a, cudaStream_t st) {
    add_rmsnorm_kernel<T, W><<<a.rows, a.threads, 0, st>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.d),
        static_cast<const W*>(a.w), static_cast<T*>(a.res),
        static_cast<T*>(a.out), a.x_rs, a.d_rs, a.n, a.eps);
    return cudaGetLastError();
  }
};

struct RopeLaunch {
  struct Args {
    RopeTensor q, k;
    const void *pos, *inv_freq;
    long long p_sb, p_ss;
    dim3 grid;
    int s, half;
    float eps;
  };
  template <typename T, typename W>
  static int run(const Args& a, cudaStream_t st) {
    qk_rope_kernel<T, W><<<a.grid, kRopeWarps * 32, 0, st>>>(
        a.q, a.k, static_cast<const long long*>(a.pos), a.p_sb, a.p_ss,
        static_cast<const float*>(a.inv_freq), a.s, a.half, a.eps);
    return cudaGetLastError();
  }
};

struct GluLaunch {
  struct Args {
    const void *gate, *up;
    void* out;
    long long g_rs, u_rs;
    dim3 grid;
    int threads, n;
  };
  template <typename T, typename W>
  static int run(const Args& a, cudaStream_t st) {
    swiglu_kernel<T><<<a.grid, a.threads, 0, st>>>(
        static_cast<const T*>(a.gate), static_cast<const T*>(a.up),
        static_cast<T*>(a.out), a.g_rs, a.u_rs, a.n);
    return cudaGetLastError();
  }
};

// A pointer and a row stride (elements) that give 16-byte aligned rows.
bool rows_aligned(const void* p, long long rs, int elem) {
  const long long vec = 16 / elem;
  return p == nullptr ||
         (reinterpret_cast<uintptr_t>(p) % 16 == 0 && rs % vec == 0);
}

int elem_size(int code) { return code == kF32 ? 4 : 2; }

}  // namespace
}  // namespace fattn

// x, d (rows, n) with row strides x_rs, d_rs (d null: no add, res not
// written); w (n,); res, out (rows, n) contiguous.
extern "C" int fattn_add_rmsnorm(const void* x, const void* d, const void* w,
                                 void* res, void* out, long long x_rs,
                                 long long d_rs, int rows, int n, float eps,
                                 int dtype, int w_dtype, void* stream) {
  using namespace fattn;
  const int elem = elem_size(dtype), vec = 16 / elem;
  if (rows <= 0 || n <= 0 || n % vec != 0 ||
      n / vec > kNormThreads * kNormVecs || !rows_aligned(x, x_rs, elem) ||
      !rows_aligned(w, 0, elem) ||
      !rows_aligned(d, d_rs, elem) || !rows_aligned(res, n, elem) ||
      !rows_aligned(out, n, elem)) {
    return cudaErrorInvalidValue;
  }
  const int vecs = n / vec;
  const int threads =
      vecs >= kNormThreads ? kNormThreads : (vecs + 31) / 32 * 32;
  const NormLaunch::Args a{x, d, w, res, out, x_rs, d_rs, rows, n, threads,
                           eps};
  return by_types<NormLaunch>(dtype, w_dtype, a,
                              static_cast<cudaStream_t>(stream));
}

// In place on q (b, s, hq, hd) and k (b, s, hk, hd) through element
// strides (hd contiguous); pos (b, s) int64 through strides p_sb, p_ss;
// inv_freq (hd / 2,) fp32; q_norm / k_norm (hd,) of w_dtype, both or
// neither.
extern "C" int fattn_qk_rope(void* q, long long q_sb, long long q_ss,
                             long long q_sh, void* k, long long k_sb,
                             long long k_ss, long long k_sh, const void* pos,
                             long long p_sb, long long p_ss,
                             const void* inv_freq, const void* q_norm,
                             const void* k_norm, int b, int s, int hq,
                             int hk, int hd, float eps, int dtype,
                             int w_dtype, void* stream) {
  using namespace fattn;
  if (b <= 0 || s <= 0 || hq <= 0 || hk <= 0 || hd <= 0 || hd % 2 != 0 ||
      hd / 2 > kMaxHalf || (long long)b * s > 0x7fffffffLL ||
      (q_norm == nullptr) != (k_norm == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const RopeLaunch::Args a{
      RopeTensor{q, q_sb, q_ss, q_sh, q_norm, hq},
      RopeTensor{k, k_sb, k_ss, k_sh, k_norm, hk},
      pos,
      inv_freq,
      p_sb,
      p_ss,
      dim3(b * s, (hq + hk + kRopeWarps - 1) / kRopeWarps),
      s,
      hd / 2,
      eps};
  return by_types<RopeLaunch>(dtype, w_dtype, a,
                              static_cast<cudaStream_t>(stream));
}

// gate, up (rows, n) with row strides g_rs, u_rs; out (rows, n)
// contiguous.
extern "C" int fattn_swiglu(const void* gate, const void* up, void* out,
                            long long g_rs, long long u_rs, int rows, int n,
                            int dtype, void* stream) {
  using namespace fattn;
  const int elem = elem_size(dtype), vec = 16 / elem;
  if (rows <= 0 || n <= 0 || n % vec != 0 ||
      !rows_aligned(gate, g_rs, elem) || !rows_aligned(up, u_rs, elem) ||
      !rows_aligned(out, n, elem)) {
    return cudaErrorInvalidValue;
  }
  const int vecs = n / vec;
  const int threads =
      vecs >= kGluThreads ? kGluThreads : (vecs + 31) / 32 * 32;
  const GluLaunch::Args a{gate, up, out, g_rs, u_rs,
                          dim3(rows, (vecs + threads - 1) / threads),
                          threads, n};
  if (a.grid.y > 65535) return cudaErrorInvalidValue;
  // no weight: its type code is a placeholder
  return by_types<GluLaunch>(dtype, kF32, a,
                             static_cast<cudaStream_t>(stream));
}
