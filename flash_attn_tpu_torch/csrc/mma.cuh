// Tensor-core helpers shared by the attention kernels: mma.sync m16n8k16
// with fp32 accumulation for bf16 and fp16 operands, and the packing of
// fp32 values into the 16-bit operand registers.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A (16x16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8):  b0 (k = 2t..2t+1, n = g)          b1 (k = 2t+8.., n = g)
//   C (16x8):  c0,c1 (g, 2t..2t+1)               c2,c3 (g+8, 2t..2t+1)
// The C fragments of two neighbouring n-blocks hold exactly the A fragment
// of one 16-wide k-step, so a product's result feeds the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace fattn {

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
  static __device__ __forceinline__ uint16_t bits(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

// Two consecutive 16-bit elements as one operand register.
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit elements one row apart (a B fragment read down a column).
__device__ __forceinline__ uint32_t ld_col_pair(const uint16_t* p,
                                                int stride) {
  return p[0] | (uint32_t(p[stride]) << 16);
}

}  // namespace fattn
