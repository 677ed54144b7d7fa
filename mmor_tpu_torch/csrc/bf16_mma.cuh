// The bf16 tensor-core product shared by the weight-stream kernels
// (stream_matmul.cu: K10a, K10b, K10c's bf16 mode) and the fused o-proj +
// MLP tail (fused_mlp.cu: K9): mma.sync.m16n8k16 with f32 accumulation, and
// the packing of integer weight values into its bf16 B registers.
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

}  // namespace
