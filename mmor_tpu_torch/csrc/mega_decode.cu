// K5: one decode position through every decoder layer, int4 weights and an
// int4 KV cache (wbits = kvbits = 4).
//
// Replaces mmor_tpu/ops/mega_decode.py::mega_decode_layers (_mega_kernel,
// the pl.pallas_call at :1323) without its piggyback-prefill rows; the
// arithmetic is that of mega_decode_layers_reference (:1386-1589).
//
// What bounds it on the H100: bytes. Each decode step reads every layer's
// int4 weights once (about 3.3 GB at 7B) for B <= 64 rows, and each (row,
// head) reads its layer's valid int4 keys and values (64 bytes a position
// each); the arithmetic is a few operations a byte. On the TPU the step was
// bound by the fixed cost of each launch, which is why it became one kernel.
//
// Design: one C entry point runs all L layers with no Python between them;
// for each layer it enqueues a fixed sequence of kernels on the caller's
// stream:
//   1. RMSNorm (its mean of squares in double, a row's chunk blocks one
//      cluster sharing their partial sums) and int8 quantization per
//      (row, ck-chunk), in f32 as x * (1/rs);
//   2. fused-qkv W4A8 (w4a8.cuh), each chunk's exact int32 dot folded with
//      its weight scale and row-chunk scale;
//   3. attention, one block per (row, head): RoPE, per-(row, head) int8
//      quantization of q * sm_scale, k and v (the new K/V column is emitted
//      for the caller's cache update), logits over the valid int4 cache
//      positions with the current token's int8 term inline, the softmax
//      weights times the value scales quantized to int8 over T, the int8 x
//      int4 weighted sum, and the per-(row, head) int8 quantization of the
//      output for the o-projection;
//   4. o-projection W4A8 with per-(row, head) activation scales, plus the
//      f32 residual;
//   5. RMSNorm 2 and chunk quantization (kernel 1);
//   6. gate_up W4A8, each block owning 16 gate columns and their 16 up
//      columns, so SiLU(gate) * up happens in its epilogue;
//   7. chunk quantization of the SwiGLU output (kernel 1 without a norm);
//   8. down W4A8 plus the f32 residual.
// That is 8 launches a layer from C++, about 260 a token at 7B. The weights
// are the per-layer (K/8, N) stacks the prefill reads, walked in place
// through a host array of their device pointers (no second copy).
// The int4 cache is (L, B, H, T, Dh/2) bytes, two biased head-dim values to
// a byte (low nibble = even channel), with (L, B, H, T) bf16 scales: a key
// row is 64 contiguous bytes, and a masked position is never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "w4a8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;  // mega_decode.NEG_INF
constexpr int kDh = 128;           // head dim the attention kernel takes
constexpr int kAttnThreads = kDh;  // one thread a head-dim channel
constexpr int kQuantThreads = 128;
constexpr int kMaxChunkPerThread = 8;  // chunk <= 1024
constexpr int kMaxNormChunks = 8;      // a row's chunks: the largest portable cluster

// amax > 0 ? amax / 127 : 1, then the int8 value of x on that grid
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? amax / 127.f : 1.f;
}
__device__ __forceinline__ float quant8(float x, float inv) {
  return fminf(fmaxf(rintf(x * inv), -127.f), 127.f);
}

template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, other) : v + other;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < nw; ++w) v = IS_MAX ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// ------------------------------------------------------------ 0. bf16 -> f32
__global__ void widen_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                             int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = __bfloat162float(x[i]);
}

__global__ void narrow_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                              int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) y[i] = __float2bfloat16_rn(x[i]);
}

// ------------------------------------- 1. RMSNorm + per-(row, chunk) int8
// grid (width / chunk, rows), kQuantThreads threads, a block a (chunk, row);
// with NORM the blocks of a row form one thread-block cluster. Each block
// loads its chunk (and its norm) into registers at once. With NORM, each
// block sums its chunk's squares in double, the cluster exchanges those
// partial sums through distributed shared memory, and every block adds them
// in chunk order: the row's factor r = 1 / sqrt(mean(x^2) + eps) is taken
// once, in double, so the f32 result does not depend on the order of the
// sum; h = x * r * norm. Else h = x. Then the chunk's amax, rs = amax / 127
// (1 for a zero chunk) and q = clip(rint(h * (1/rs))).
template <bool NORM>
__global__ void __launch_bounds__(kQuantThreads)
norm_quant_kernel(const float* __restrict__ x, const float* __restrict__ norm,
                  int8_t* __restrict__ q, float* __restrict__ rs, int width,
                  int chunk, float eps) {
  __shared__ float red[kQuantThreads / 32];
  __shared__ double red_d[kQuantThreads / 32];
  __shared__ double part;  // this chunk's sum of squares
  const int c = blockIdx.x, row = blockIdx.y, nch = width / chunk, tid = threadIdx.x;
  const size_t base = (size_t)row * width + (size_t)c * chunk;
  float h[kMaxChunkPerThread], nv[kMaxChunkPerThread];
#pragma unroll
  for (int j = 0; j < kMaxChunkPerThread; ++j) {
    const int i = j * kQuantThreads + tid;
    h[j] = i < chunk ? x[base + i] : 0.f;
    if constexpr (NORM) nv[j] = i < chunk ? norm[c * chunk + i] : 0.f;
  }
  if constexpr (NORM) {
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < kMaxChunkPerThread; ++j) ss += (double)h[j] * h[j];
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (tid % 32 == 0) red_d[tid / 32] = ss;
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int w = 0; w < kQuantThreads / 32; ++w) t += red_d[w];
      part = t;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    double total = 0.0;
    for (int r = 0; r < nch; ++r) total += *cluster.map_shared_rank(&part, r);
    cluster.sync();  // no block leaves while another reads its part
    const float rinv = (float)(1.0 / sqrt(total / (double)width + (double)eps));
#pragma unroll
    for (int j = 0; j < kMaxChunkPerThread; ++j) h[j] = __fmul_rn(__fmul_rn(h[j], rinv), nv[j]);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunkPerThread; ++j) amax = fmaxf(amax, fabsf(h[j]));
  amax = block_reduce<true>(amax, red);
  const float scale = row_scale(amax);
  const float inv = 1.f / scale;
  if (tid == 0) rs[(size_t)row * nch + c] = scale;
#pragma unroll
  for (int j = 0; j < kMaxChunkPerThread; ++j) {
    const int i = j * kQuantThreads + tid;
    if (i < chunk) q[base + i] = (int8_t)quant8(h[j], inv);
  }
}

// ---------------------------------------------------------- 3. attention
struct AttnArgs {
  const float* qkv;            // (B, 3D) f32, this layer's fused projection
  const float* cos;            // (B, Dh)
  const float* sin;
  const uint8_t* k_cache;      // (L, B, H, T, Dh/2) biased nibbles
  const __nv_bfloat16* k_scale;  // (L, B, H, T)
  const uint8_t* v_cache;
  const __nv_bfloat16* v_scale;
  const int* kv_mask;          // (B, T)
  int8_t* knew;                // (L, B, H, Dh)
  float* knew_s;               // (L, B, H)
  int8_t* vnew;
  float* vnew_s;
  int8_t* a8;                  // (B, D) attention output, int8 per (row, head)
  float* ars;                  // (B, H)
  int layer, batch, heads, t_cap;
  float sm_scale;
};

// grid B * H, kDh threads; dynamic shared memory t_cap floats
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(AttnArgs p) {
  extern __shared__ float w_s[];  // logits, then weights, then int8 weights
  __shared__ float red[kAttnThreads / 32];
  __shared__ float qraw[kDh], kraw[kDh];
  __shared__ int q8s[kDh];
  __shared__ float part[kAttnThreads / 32][kDh];
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads, d = threadIdx.x;
  const int dim = p.heads * kDh, half = kDh / 2;
  const float* row = p.qkv + (size_t)b * 3 * dim + h * kDh;
  const float q = row[d], k = row[dim + d], v = row[2 * dim + d];
  qraw[d] = q;
  kraw[d] = k;
  __syncthreads();
  // RoPE, HF half rotation: t * cos + rotate_half(t) * sin
  const float c = p.cos[b * kDh + d], s = p.sin[b * kDh + d];
  const float qrot = d < half ? -qraw[d + half] : qraw[d - half];
  const float krot = d < half ? -kraw[d + half] : kraw[d - half];
  const float qr = __fadd_rn(__fmul_rn(q, c), __fmul_rn(qrot, s));
  const float kr = __fadd_rn(__fmul_rn(k, c), __fmul_rn(krot, s));

  // per-(row, head) int8: q * sm_scale, k, v
  const float qsc = qr * p.sm_scale;
  const float qs = row_scale(block_reduce<true>(fabsf(qsc), red));
  const float q8 = quant8(qsc, 1.f / qs);
  const float ks = row_scale(block_reduce<true>(fabsf(kr), red));
  const float k8 = quant8(kr, 1.f / ks);
  const float vs = row_scale(block_reduce<true>(fabsf(v), red));
  const float v8 = quant8(v, 1.f / vs);
  const size_t lbh = ((size_t)p.layer * p.batch + b) * p.heads + h;
  p.knew[lbh * kDh + d] = (int8_t)k8;
  p.vnew[lbh * kDh + d] = (int8_t)v8;
  if (d == 0) {
    p.knew_s[lbh] = ks;
    p.vnew_s[lbh] = vs;
  }
  q8s[d] = (int)q8;
  const float vcur = v8 * vs;
  // the current token's logit: the exact int8 dot, then its two scales
  // (a sum of integers in f32 is exact in any order)
  const float lcur = __fmul_rn(__fmul_rn(block_reduce<false>(q8 * k8, red), ks), qs);

  // logits over the cache: one key row (64 bytes) per thread and position
  const int t_cap = p.t_cap;
  const uint8_t* kb = p.k_cache + lbh * t_cap * (kDh / 2);
  const uint8_t* vb = p.v_cache + lbh * t_cap * (kDh / 2);
  const __nv_bfloat16* ksb = p.k_scale + lbh * t_cap;
  const __nv_bfloat16* vsb = p.v_scale + lbh * t_cap;
  const int* mb = p.kv_mask + (size_t)b * t_cap;
  float mx = lcur;
  for (int t = d; t < t_cap; t += kAttnThreads) {
    float logit = kNegInf;
    if (mb[t] != 0) {
      const uint4* key = reinterpret_cast<const uint4*>(kb + (size_t)t * (kDh / 2));
      int dot = 0;
#pragma unroll
      for (int c4 = 0; c4 < kDh / 32; ++c4) {
        const uint4 wv = key[c4];
        const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int byte = 0; byte < 4; ++byte) {
            const uint32_t bits = words[j] >> (8 * byte);
            const int ch = c4 * 32 + j * 8 + byte * 2;
            dot += q8s[ch] * ((int)(bits & 0xFu) - 8) +
                   q8s[ch + 1] * ((int)((bits >> 4) & 0xFu) - 8);
          }
      }
      logit = __fmul_rn(__fmul_rn((float)dot, qs), __bfloat162float(ksb[t]));
    }
    w_s[t] = logit;
    mx = fmaxf(mx, logit);
  }
  mx = block_reduce<true>(mx, red);

  float sum = 0.f, wamax = 0.f;
  for (int t = d; t < t_cap; t += kAttnThreads) {
    const float e = expf(w_s[t] - mx);
    sum += e;
    const float wv = e * __bfloat162float(vsb[t]);  // weights times value scales
    w_s[t] = wv;
    wamax = fmaxf(wamax, wv);
  }
  const float wc = expf(lcur - mx);
  const float denom = block_reduce<false>(sum, red) + wc;
  const float wrs = row_scale(block_reduce<true>(wamax, red));
  const float winv = 1.f / wrs;
  for (int t = d; t < t_cap; t += kAttnThreads) w_s[t] = quant8(w_s[t], winv);
  __syncthreads();

  // ov[c] = sum_t w8[t] * v[t, c]: warps split T, a lane owns 4 channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = warp; t < t_cap; t += kAttnThreads / 32) {
    const float wt = w_s[t];
    if (wt == 0.f) continue;
    const uint32_t pair = *reinterpret_cast<const uint16_t*>(vb + (size_t)t * (kDh / 2) + 2 * lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] += wt * (float)((int)((pair >> (4 * j)) & 0xFu) - 8);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = a[j];
  __syncthreads();
  float ov = 0.f;
#pragma unroll
  for (int w = 0; w < kAttnThreads / 32; ++w) ov += part[w][d];
  const float attn = __fadd_rn(__fmul_rn(ov, wrs), __fmul_rn(wc, vcur)) / denom;

  // int8 per (row, head) for the o-projection
  const float as = row_scale(block_reduce<true>(fabsf(attn), red));
  p.a8[(size_t)b * dim + h * kDh + d] = (int8_t)quant8(attn, 1.f / as);
  if (d == 0) p.ars[(size_t)b * p.heads + h] = as;
}

cudaError_t norm_quant(const float* x, const float* norm, void* q, void* rs, int rows,
                       int width, int chunk, float eps, cudaStream_t s) {
  const int nch = width / chunk;
  int8_t* q8 = static_cast<int8_t*>(q);
  float* rsf = static_cast<float*>(rs);
  if (norm == nullptr) {
    norm_quant_kernel<false><<<dim3(nch, rows), kQuantThreads, 0, s>>>(x, norm, q8, rsf,
                                                                       width, chunk, eps);
    return cudaGetLastError();
  }
  // with the norm, a row's chunk blocks form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nch, rows);
  cfg.blockDim = dim3(kQuantThreads);
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = nch;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, norm_quant_kernel<true>, x, norm, q8, rsf, width, chunk,
                            eps);
}

}  // namespace

// Layer-pointer slots in the host array `layers` (8 * L device pointers):
// slot * L + layer, slot 0/1 qkv w/scale, 2/3 o, 4/5 gate_up, 6/7 down.
// x_in (B, D) bf16; norms (L, 2, D) f32; caches (L, B, H, T, Dh/2) uint8 and
// (L, B, H, T) bf16 scales; kv_mask (B, T) int32; cos/sin (B, Dh) f32.
// Scratch: x_res, x2 (B, D) f32; hq (B, max(D, F)) int8; hrs (B, max(D, F)
// / ck) f32; qkv (B, 3D) f32; a8 (B, D) int8; ars (B, H) f32; mbuf (B, F)
// f32. Outputs: x_out (B, D) bf16 (before the final norm); knew/vnew
// (L, B, H, Dh) int8; knew_s/vnew_s (L, B, H) f32.
extern "C" int mmor_mega_decode(
    const void* x_in, const void* layers_host, const void* norms, const void* k_cache,
    const void* k_scale, const void* v_cache, const void* v_scale, const void* kv_mask,
    const void* cos, const void* sin, void* x_res, void* x2, void* hq, void* hrs,
    void* qkv, void* a8, void* ars, void* mbuf, void* x_out, void* knew, void* knew_s,
    void* vnew, void* vnew_s, int n_layers, int batch, int dim, int heads, int ffn,
    int t_cap, int ck, float eps, float sm_scale, void* stream) {
  if (dim != heads * kDh || ck % 256 || ck > kQuantThreads * kMaxChunkPerThread ||
      dim / ck > kMaxNormChunks || dim % ck || ffn % ck)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const* lp = static_cast<const void* const*>(layers_host);
  auto slot = [&](int which, int l) { return lp[which * n_layers + l]; };
  float* xr = static_cast<float*>(x_res);
  float* x2f = static_cast<float*>(x2);
  const float* nf = static_cast<const float*>(norms);
  const uint32_t* hq32 = static_cast<const uint32_t*>(hq);
  const float* hrsf = static_cast<const float*>(hrs);
  const int count = batch * dim;
  const size_t attn_smem = (size_t)t_cap * sizeof(float);
  static size_t attn_smem_set = 48 * 1024;
  cudaError_t e;
  if (attn_smem > attn_smem_set) {
    e = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn_smem);
    if (e != cudaSuccess) return (int)e;
    attn_smem_set = attn_smem;
  }
  widen_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x_in), xr, count);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  for (int l = 0; l < n_layers; ++l) {
    const float* norm1 = nf + (size_t)l * 2 * dim;
    const float* norm2 = norm1 + dim;
    // 1-2: attention norm, chunk quantization, fused qkv
    if ((e = norm_quant(xr, norm1, hq, hrs, batch, dim, ck, eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pq{hq32, hrsf, static_cast<const uint32_t*>(slot(0, l)),
                        static_cast<const float*>(slot(1, l)), nullptr, qkv,
                        batch, dim, 3 * dim, ck, ck};
    if ((e = w4a8::launch_skinny<w4a8::kStoreF32, float>(pq, s)) != cudaSuccess)
      return (int)e;
    // 3: attention
    AttnArgs pa{static_cast<const float*>(qkv), static_cast<const float*>(cos),
                static_cast<const float*>(sin), static_cast<const uint8_t*>(k_cache),
                static_cast<const __nv_bfloat16*>(k_scale),
                static_cast<const uint8_t*>(v_cache),
                static_cast<const __nv_bfloat16*>(v_scale),
                static_cast<const int*>(kv_mask), static_cast<int8_t*>(knew),
                static_cast<float*>(knew_s), static_cast<int8_t*>(vnew),
                static_cast<float*>(vnew_s), static_cast<int8_t*>(a8),
                static_cast<float*>(ars), l, batch, heads, t_cap, sm_scale};
    attention_kernel<<<batch * heads, kAttnThreads, attn_smem, s>>>(pa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // 4: o-projection (activation scales per (row, head)) + residual
    w4a8::SkinnyArgs po{static_cast<const uint32_t*>(a8), static_cast<const float*>(ars),
                        static_cast<const uint32_t*>(slot(2, l)),
                        static_cast<const float*>(slot(3, l)), xr, x2, batch, dim, dim,
                        ck, kDh};
    if ((e = w4a8::launch_skinny<w4a8::kResidF32, float>(po, s)) != cudaSuccess)
      return (int)e;
    // 5-6: MLP norm, chunk quantization, gate_up with SwiGLU
    if ((e = norm_quant(x2f, norm2, hq, hrs, batch, dim, ck, eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pg{hq32, hrsf, static_cast<const uint32_t*>(slot(4, l)),
                        static_cast<const float*>(slot(5, l)), nullptr, mbuf,
                        batch, dim, 2 * ffn, ck, ck};
    if ((e = w4a8::launch_skinny<w4a8::kSwiGLU, float>(pg, s)) != cudaSuccess)
      return (int)e;
    // 7-8: chunk quantization of the SwiGLU output, down + residual
    if ((e = norm_quant(static_cast<const float*>(mbuf), nullptr, hq, hrs, batch, ffn,
                        ck, eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pd{hq32, hrsf, static_cast<const uint32_t*>(slot(6, l)),
                        static_cast<const float*>(slot(7, l)), x2f, xr, batch, ffn, dim,
                        ck, ck};
    if ((e = w4a8::launch_skinny<w4a8::kResidF32, float>(pd, s)) != cudaSuccess)
      return (int)e;
  }
  narrow_kernel<<<(count + 255) / 256, 256, 0, s>>>(xr, static_cast<__nv_bfloat16*>(x_out),
                                                    count);
  return (int)cudaGetLastError();
}
