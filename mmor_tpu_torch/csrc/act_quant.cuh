// Activation preparation shared by K2 and K8 (int8_matmul.cu) and K3
// (int4_matmul.cu): per-row symmetric int8 rows, the numerics of
// mmor_tpu/ops/quantized_matmul.py:214-217 and :395-399 (K2, K3) or of
// :81-84 (K8); and the bf16 rounding of f32 rows that the W8A16 and W4A16
// branches take (:219-220, :403), as their TPU kernels do.
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

// ------------------------------------------------------------ bf16 rows
// f32 x -> bf16 (round to nearest even), four values a thread (count % 4 ==
// 0, both pointers 16-byte aligned)
__global__ void to_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                               size_t count) {
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < count;
       i += (size_t)gridDim.x * blockDim.x * 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y + i);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

inline cudaError_t round_to_bf16(const float* x, __nv_bfloat16* y, size_t count,
                                 cudaStream_t s) {
  const size_t blocks = (count / 4 + 255) / 256;
  to_bf16_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(x, y, count);
  return cudaGetLastError();
}

}  // namespace
