// K4: one-position decode attention against an int8 KV cache stack, and
// K7: the same against one layer's int8 cache.
//
// Replaces mmor_tpu/ops/attention.py::decode_attention_packed_stack
// (_packed_decode_stack_kernel, the pl.pallas_call at :534) and
// mmor_tpu/ops/attention.py::decode_attention_packed (_packed_decode_kernel,
// the pl.pallas_call at :433).
//
// What bounds it on the H100: device-memory bytes. Each (batch, head) reads
// its layer's T x D int8 keys and values once (2 x 1008 x 128 bytes at the
// 7B serving shape) plus two bf16 scales per position; the arithmetic is a
// matvec.
//
// Design: the port keeps the cache as (L, B, H, T, D) int8 with (L, B, H, T)
// bf16 per-position scales instead of the TPU's (L, B, H, D/4, T) int32
// words, which exist for the TPU's element-rate DMA. Here a key row is D
// contiguous bytes, read with 16-byte loads. The kernel reads layer
// `layer` of the full stack in place (no per-layer copy). One block per
// (batch, head): each thread scores whole key rows (q . k in f32, times
// sm_scale times the key scale, masked slots take DEFAULT_MASK_VALUE), the
// block takes the softmax over T in shared memory, folds the value scale
// into the weights, and the four warps sum the weighted int8 value rows
// with each lane owning four consecutive head-dim channels.
//
// K7 is the same kernel on a one-layer cache (layer 0 of a stack of one, so
// no layer stride), templated on the scale type, since its callers pass f32
// scales (a bf16 copy would move them, 0.01 among them) as well as bf16
// ones, and on the output type (f32 for an f32 query, as the TPU kernel's f32
// result cast to q's dtype).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, other) : v + other;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename ScaleT, typename OutT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const int8_t* __restrict__ k_stack,
              const int8_t* __restrict__ v_stack,
              const ScaleT* __restrict__ ks_stack,
              const ScaleT* __restrict__ vs_stack,
              const int* __restrict__ kv_mask, OutT* __restrict__ out,
              int layer, int batch, int heads, int t_cap, int d,
              float sm_scale) {
  extern __shared__ float w_s[];  // t_cap logits, then weights
  __shared__ float q_s[kMaxD];
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const size_t slab = (size_t)layer * batch * heads + bh;  // (l, b, h) index
  const int8_t* kb = k_stack + slab * t_cap * d;
  const int8_t* vb = v_stack + slab * t_cap * d;
  const ScaleT* ksb = ks_stack + slab * t_cap;
  const ScaleT* vsb = vs_stack + slab * t_cap;
  const int* mb = kv_mask + (size_t)b * t_cap;

  for (int i = threadIdx.x; i < d; i += kThreads)
    q_s[i] = __bfloat162float(q[(size_t)bh * d + i]);
  __syncthreads();

  // logits: one key row per thread, 16 int8 channels per load
  float mx = kMaskValue;
  for (int t = threadIdx.x; t < t_cap; t += kThreads) {
    float logit = kMaskValue;
    if (mb[t] != 0) {
      const int4* row = reinterpret_cast<const int4*>(kb + (size_t)t * d);
      float dot = 0.f;
      for (int c = 0; c < d / 16; ++c) {
        const int4 w = row[c];
        const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int byte = 0; byte < 4; ++byte) {
            const int8_t kv = (int8_t)((words[j] >> (8 * byte)) & 0xff);
            dot += q_s[c * 16 + j * 4 + byte] * (float)kv;
          }
        }
      }
      logit = dot * sm_scale * as_float(ksb[t]);
    }
    w_s[t] = logit;
    mx = fmaxf(mx, logit);
  }
  mx = block_reduce(mx, red, true);

  float sum = 0.f;
  for (int t = threadIdx.x; t < t_cap; t += kThreads) {
    const float p = __expf(w_s[t] - mx);
    w_s[t] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);  // also orders the w_s writes
  const float inv = 1.f / sum;
  for (int t = threadIdx.x; t < t_cap; t += kThreads)
    w_s[t] = w_s[t] * inv * as_float(vsb[t]);
  __syncthreads();

  // out[c] = sum_t w[t] * v[t, c]: warps split T, lanes own 4 channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = lane * 4; c0 < d; c0 += 128) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = warp; t < t_cap; t += kWarps) {
      const float wt = w_s[t];
      if (wt == 0.f) continue;
      const int word = *reinterpret_cast<const int*>(vb + (size_t)t * d + c0);
#pragma unroll
      for (int byte = 0; byte < 4; ++byte)
        a[byte] += wt * (float)(int8_t)((word >> (8 * byte)) & 0xff);
    }
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) part[warp][c0 + byte] = a[byte];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += part[w][c];
    store(out + (size_t)bh * d + c, acc);
  }
}

template <typename ScaleT, typename OutT>
cudaError_t launch_decode(const void* q, const void* k_stack, const void* v_stack,
                          const void* ks_stack, const void* vs_stack,
                          const void* kv_mask, void* out, int layer, int batch,
                          int heads, int t_cap, int head_dim, float sm_scale,
                          cudaStream_t s) {
  if (head_dim % 16 != 0 || head_dim > kMaxD) return cudaErrorInvalidValue;
  const size_t smem = (size_t)t_cap * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<ScaleT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_kernel<ScaleT, OutT><<<batch * heads, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_stack),
      static_cast<const int8_t*>(v_stack), static_cast<const ScaleT*>(ks_stack),
      static_cast<const ScaleT*>(vs_stack), static_cast<const int*>(kv_mask),
      static_cast<OutT*>(out), layer, batch, heads, t_cap, head_dim, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// K4. q/out: (B*H, D) bf16; k/v stacks: (L, B, H, T, D) int8; scale stacks:
// (L, B, H, T) bf16; kv_mask: (B, T) int32. Returns the launch's cudaError_t.
extern "C" int mmor_decode_attention(const void* q, const void* k_stack,
                                     const void* v_stack, const void* ks_stack,
                                     const void* vs_stack, const void* kv_mask,
                                     void* out, int layer, int batch, int heads,
                                     int t_cap, int head_dim, float sm_scale,
                                     void* stream) {
  return (int)launch_decode<__nv_bfloat16, __nv_bfloat16>(
      q, k_stack, v_stack, ks_stack, vs_stack, kv_mask, out, layer, batch, heads,
      t_cap, head_dim, sm_scale, static_cast<cudaStream_t>(stream));
}

// K7. q: (B*H, D) bf16; k/v: (B, H, T, D) int8; scales: (B, H, T) f32
// (scale_f32 = 1) or bf16; kv_mask: (B, T) int32; out: (B*H, D) f32
// (out_f32 = 1) or bf16.
extern "C" int mmor_decode_attention_layer(const void* q, const void* k, const void* v,
                                           const void* k_scale, const void* v_scale,
                                           const void* kv_mask, void* out, int batch,
                                           int heads, int t_cap, int head_dim,
                                           float sm_scale, int scale_f32, int out_f32,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const auto args = [&](auto launch) {
    return (int)launch(q, k, v, k_scale, v_scale, kv_mask, out, 0, batch, heads, t_cap,
                       head_dim, sm_scale, s);
  };
  if (scale_f32)
    return out_f32 ? args(launch_decode<float, float>) : args(launch_decode<float, bf16>);
  return out_f32 ? args(launch_decode<bf16, float>) : args(launch_decode<bf16, bf16>);
}
