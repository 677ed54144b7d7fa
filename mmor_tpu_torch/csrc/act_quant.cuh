// Activation quantization shared by K2 and K8 (int8_matmul.cu) and K3
// (int4_matmul.cu): per-row symmetric int8 rows, the numerics of
// mmor_tpu/ops/quantized_matmul.py:214-217 and :395-399 (K2, K3) or of
// :81-84 (K8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------ activation rows
// Per-row symmetric int8 activations. Both rules take the row amax in f32
// and scale = amax / 127 (1 for a zero row), round half to even and clip to
// +-127; they differ in how a value meets the scale:
//  - kInverse (K2, K3; the plain quantize_rows): the scale's inverse rounded
//    to x's type, x * inv in x's type;
//  - kDivide (K8; the plain quantize_rows_div): x / scale in f32.
// One block per row.
constexpr int kQuantThreads = 256;
enum class QuantRule { kInverse, kDivide };

template <typename T, QuantRule kRule = QuantRule::kInverse>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ row_scale, int k) {
  __shared__ float red[kQuantThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * k;
  float amax = 0.f;
  for (int i = threadIdx.x; i < k; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(to_float(xr[i])));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? amax / 127.f : 1.f;
  const float inv = to_float(from_float<T>(1.f / scale));
  if (threadIdx.x == 0) row_scale[blockIdx.x] = scale;
  int8_t* qr = xq + (size_t)blockIdx.x * k;
  for (int i = threadIdx.x; i < k; i += kQuantThreads) {
    const float v = kRule == QuantRule::kDivide
                        ? rintf(to_float(xr[i]) / scale)
                        : rintf(to_float(from_float<T>(to_float(xr[i]) * inv)));
    qr[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

}  // namespace
