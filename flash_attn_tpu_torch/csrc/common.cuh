// Shared device helpers for the Hopper kernels of flash_attn_tpu_torch.
//
// Every C entry point of this library returns cudaGetLastError() right
// after its launch (or a cudaError_t for arguments it refuses); the Python
// wrapper raises when the code is not 0. Dtype codes match
// flash_attn_tpu_torch/kernels/_build.py DTYPE_CODES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fattn {

enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// The attention kernels (K1, K2, K8a-c) read and write their (b, h, s, d)
// operands through strides: the last dimension is contiguous, the others
// are any element strides whose byte sizes are multiples of 16 (checked by
// flash_attn_tpu_torch/kernels/common.py rows_ok), so the ops hand over
// transposed views of (b, s, h, d) tensors and of the packed qkv in place.
// lse and di stay contiguous (b, h, sq) fp32.
struct Strides {
  long long b, h, s;
};
// The order of kernels/common.py OPERANDS; K8c writes dq through kOpO.
enum Operand { kOpQ, kOpK, kOpV, kOpO, kOpDO, kOpDK, kOpDV, kOpDQ, kNumOps };

// The host side: flat[3 * op + {0, 1, 2}] for every Operand.
inline void set_strides(Strides (&st)[kNumOps], const long long* flat) {
  for (int op = 0; op < kNumOps; ++op) {
    st[op] = Strides{flat[3 * op], flat[3 * op + 1], flat[3 * op + 2]};
  }
}

// Row 0 of (batch bb, head hh) of an operand; row r is r * st.s further on.
template <typename E>
__device__ __forceinline__ E* head_rows(E* x, const Strides& st, int bb,
                                        int hh) {
  return x + bb * st.b + hh * st.h;
}

}  // namespace fattn
