// The bf16 tensor-core product shared by the weight-stream kernels
// (stream_matmul.cu: K10a, K10b, K10c's bf16 mode, K2's W8A16 at decode
// rows), the megakernel probe's nibble stream (megakernel_probe.cu: K10e)
// and the fused o-proj + MLP tail (fused_mlp.cu: K9): mma.sync.m16n8k16
// with f32 accumulation, and the packing of integer weight values into its
// bf16 registers (by I2F, or exactly without it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values in one register, the first in the low half (the lower k)
__device__ __forceinline__ uint32_t pair(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ uint16_t bf16_bits(int v) {  // exact for |v| <= 256
  const __nv_bfloat16 b = __float2bfloat16_rn((float)v);
  return *reinterpret_cast<const uint16_t*>(&b);
}


// nibble j of each half of t (two words' bytes side by side) as a bf16
// pair: the nibble's bias flipped (bit 3: s becomes u = s + 8) and OR-ed
// into the bf16 128.0 in one LOP3, 128 + u, and 136 less is s exactly
__device__ __forceinline__ uint32_t nibble_pair_bf16(uint32_t t, int j) {
  uint32_t v = ((t >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 q =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&q);
}

// (a & kMask) | c (kLut 0xEA) or (a & kMask) ^ c (kLut 0x6A) in one LOP3, c
// held in a register: ptxas splits a mask and a fill that are both
// immediates into two LOP3s
template <uint32_t kMask, int kLut>
__device__ __forceinline__ uint32_t lop3_mask(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "n"(kMask), "r"(c), "n"(kLut));
  return d;
}

// the int8 values in bits 0-7 and 16-23 of t as a bf16 pair, exactly: a
// value's low 7 bits OR-ed into the bf16 128.0 (fill: 0x43004300 in a
// register) are 128 + (q & 127), its sign bit OR-ed into the same 128.0 is
// 256 (q < 0) or 128, and one bf16 pair subtract of the two is q (integers
// below 2^8 in magnitude, which bf16 holds exactly): two LOP3s and an HSUB2,
// no I2F
__device__ __forceinline__ uint32_t s8_pair_bf16x2(uint32_t t, uint32_t fill) {
  uint32_t v = lop3_mask<0x007F007Fu, 0xEA>(t, fill);
  uint32_t s = lop3_mask<0x00800080u, 0xEA>(t, fill);
  const __nv_bfloat162 q = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&q);
}

// nibble_pair_bf16 with its mask and bias flip in one LOP3 (bias:
// 0x43084308 in a register)
__device__ __forceinline__ uint32_t nibble_pair_bf16x2(uint32_t t, int j, uint32_t bias) {
  uint32_t v = lop3_mask<0x000F000Fu, 0x6A>(t >> (4 * j), bias);
  const __nv_bfloat162 q =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&q);
}

}  // namespace
