// K5: one decode position through every decoder layer, int8 or int4 weights
// (WBITS) and an int8 or int4 KV cache (KVBITS), all four pairs, with
// optional piggyback-prefill (pf) rows.
//
// Replaces mmor_tpu/ops/mega_decode.py::mega_decode_layers (_mega_kernel,
// the pl.pallas_call at :1323), its pf_chunk branches (:548-567, :853-913)
// and its int8 variants (K5-int8: wbits = 8 at :663-760, :941-978,
// :1060-1068; kvbits = 8 at :794-913, :1174-1176, :1267-1268) included; the
// arithmetic is that of mega_decode_layers_reference (:1386-1589).
//
// What bounds it on the H100: bytes. Each decode step reads every layer's
// weights once (about 3.3 GB at 7B in int4, 6.6 GB in int8) for B <= 64
// rows, and each (row, head) reads its layer's valid keys and values (64
// bytes a position each in int4, 128 in int8); the arithmetic is a few
// operations a byte. On the TPU the step was
// bound by the fixed cost of each launch, which is why it became one kernel.
// The pf rows (c prompt tokens of one stream of the next batch) add c rows
// to every matmul: at c = 128 their int8 operations at the card's peak take
// about as long as the weight bytes, so the step's least time barely grows,
// which is why they ride along. The skinny W4A8 kernel reads the weights
// once per 16-row tile, though, so today a step with them costs several
// plain steps; sharing one weight read among the tiles is a later change.
//
// Design: one C entry point runs all L layers with no Python between them;
// for each layer it enqueues a fixed sequence of kernels on the caller's
// stream, over R = B + c activation rows (the chunk's rows after the decode
// rows):
//   1. RMSNorm (its mean of squares in double, a row's chunk blocks one
//      cluster sharing their partial sums) and int8 quantization per
//      (row, ck-chunk), in f32 as x * (1/rs);
//   2. fused-qkv W4A8 (w4a8.cuh), each chunk's exact int32 dot folded with
//      its weight scale and row-chunk scale; or W8A8 (w8a8.cuh), each
//      chunk's dot folded with its row-chunk scale and the per-channel
//      weight scale applied after the sum;
//   3. attention of the B decode rows, one block per (row, head): RoPE,
//      per-(row, head) int8 quantization of q * sm_scale, k and v (the new
//      K/V column is emitted for the caller's cache update), logits over the
//      valid cache positions with the current token's int8 term inline,
//      the softmax weights times the value scales quantized to int8 over T,
//      the int8 x int4 (or exact int8 x int8) weighted sum, and the
//      per-(row, head) int8
//      quantization of the output for the o-projection;
//   3a. (pf) RoPE and int8 q/k/v of the c chunk rows, one block per (row,
//      head), emitting the chunk's K/V;
//   3b. (pf) the chunk's attention, one block per (row, head): int8 x int4
//      (or int8) logits over the stream's working cache where its mask is
//      set, an
//      inline causal block over the chunk's own exact int8 keys (columns
//      j <= i with amask[j] set), one softmax over both, the working-cache
//      weights times their value scales quantized to int8, the f32 inline
//      sum over the chunk's dequantized values, and the output's int8
//      quantization for the o-projection;
//   4. o-projection W4A8/W8A8 with per-(row, head) activation scales, plus
//      the f32 residual;
//   5. RMSNorm 2 and chunk quantization (kernel 1);
//   6. gate_up W4A8/W8A8, each block owning 16 gate columns and their 16 up
//      columns, so SiLU(gate) * up happens in its epilogue;
//   7. chunk quantization of the SwiGLU output (kernel 1 without a norm);
//   8. down W4A8/W8A8 plus the f32 residual.
// That is 8 launches a layer from C++ (10 with pf rows), about 260 a token
// at 7B. No step mixes rows other than the chunk's own attention, so the
// decode rows' outputs do not depend on whether pf rows ride along. The
// weights are the per-layer (K/8, N) or (K/4, N) stacks the prefill reads,
// walked in place through a host array of their device pointers (no second
// copy). The int4 caches are (L, B, H, T, Dh/2) bytes (the working cache
// (L, H, T2, Dh/2)), two biased head-dim values to a byte (low nibble = even
// channel); the int8 caches (L, B, H, T, Dh) int8, the per-op path's layout;
// both with (L, B, H, T) bf16 scales: a key row is 64 or 128 contiguous
// bytes, and a masked position is never loaded. The four (WBITS, KVBITS)
// pairs are instantiations of one template: the int4 paths' code is that of
// the int4-only kernel, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "w4a8.cuh"
#include "w8a8.cuh"

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

// The softmax's exps and sums: f32 over an int4 cache (the int4 kernels'
// arithmetic), double over an int8 cache, where the attention outputs'
// int8 quantization sits at a tie often enough that an f32 sum's order
// (the kernel's and the plain version's differ) flips a bin a few times a
// layer at 7B; in double, rounded to f32 once, the result does not depend
// on the order, as for the RMSNorm's mean of squares.
template <int KVBITS>
using SoftmaxSum = typename std::conditional<KVBITS == 8, double, float>::type;

template <int KVBITS>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (KVBITS == 8)
    return (float)exp((double)x);
  else
    return expf(x);
}

__device__ __forceinline__ float block_sum(float v, float* red, double*) {
  return block_reduce<false>(v, red);
}
__device__ __forceinline__ double block_sum(double v, float*, double* red_d) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  __syncthreads();  // red_d is free
  if (lane == 0) red_d[warp] = v;
  __syncthreads();
  v = red_d[0];
  for (int w = 1; w < nw; ++w) v += red_d[w];
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
  const float* qkv;            // (R, 3D) f32, this layer's fused projection
  const float* cos;            // (B, Dh)
  const float* sin;
  const uint8_t* k_cache;      // (L, B, H, T, Dh/2) biased nibbles, or (.., Dh) int8
  const __nv_bfloat16* k_scale;  // (L, B, H, T)
  const uint8_t* v_cache;
  const __nv_bfloat16* v_scale;
  const int* kv_mask;          // (B, T)
  int8_t* knew;                // (L, B, H, Dh)
  float* knew_s;               // (L, B, H)
  int8_t* vnew;
  float* vnew_s;
  int8_t* a8;                  // (R, D) attention output, int8 per (row, head)
  float* ars;                  // (R, H)
  int layer, batch, heads, t_cap;
  float sm_scale;
};

// This thread's channel d of one (row, head): RoPE (HF half rotation, t *
// cos + rotate_half(t) * sin) of q and k, then the per-(row, head) int8
// quantization of q * sm_scale, k and v.
struct RopeQuant {
  float q8, qs, k8, ks, v8, vs;
};

__device__ __forceinline__ RopeQuant rope_quant(const float* row, int dim, const float* cos,
                                                const float* sin, float sm_scale,
                                                float* qraw, float* kraw, float* red) {
  const int d = threadIdx.x, half = kDh / 2;
  const float q = row[d], k = row[dim + d], v = row[2 * dim + d];
  qraw[d] = q;
  kraw[d] = k;
  __syncthreads();
  const float c = cos[d], s = sin[d];
  const float qrot = d < half ? -qraw[d + half] : qraw[d - half];
  const float krot = d < half ? -kraw[d + half] : kraw[d - half];
  const float qr = __fadd_rn(__fmul_rn(q, c), __fmul_rn(qrot, s));
  const float kr = __fadd_rn(__fmul_rn(k, c), __fmul_rn(krot, s));
  RopeQuant o;
  const float qsc = qr * sm_scale;
  o.qs = row_scale(block_reduce<true>(fabsf(qsc), red));
  o.q8 = quant8(qsc, 1.f / o.qs);
  o.ks = row_scale(block_reduce<true>(fabsf(kr), red));
  o.k8 = quant8(kr, 1.f / o.ks);
  o.vs = row_scale(block_reduce<true>(fabsf(v), red));
  o.v8 = quant8(v, 1.f / o.vs);
  return o;
}

// bytes of one cache row (a position's Dh keys or values)
template <int KVBITS>
__host__ __device__ constexpr int row_bytes() {
  return KVBITS == 4 ? kDh / 2 : kDh;
}

// Logits of the int8 query q8s (kDh ints in shared memory, scale qs) over
// an int4 or int8 cache of t_cap positions: w_s[t] = (dot * qs) *
// k_scale[t] where mask[t] is set, else kNegInf; one key row (64 or 128
// bytes) per thread and position. Returns the max of mx and this thread's
// logits.
template <int KVBITS>
__device__ __forceinline__ float cache_logits(const int* q8s, float qs, const uint8_t* kb,
                                              const __nv_bfloat16* ksb, const int* mb,
                                              int t_cap, float* w_s, float mx) {
  for (int t = threadIdx.x; t < t_cap; t += kAttnThreads) {
    float logit = kNegInf;
    if (mb[t] != 0) {
      const uint4* key = reinterpret_cast<const uint4*>(kb + (size_t)t * row_bytes<KVBITS>());
      int dot = 0;
      if constexpr (KVBITS == 4) {
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
      } else {
#pragma unroll
        for (int c16 = 0; c16 < kDh / 16; ++c16) {
          const uint4 wv = key[c16];
          const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int byte = 0; byte < 4; ++byte)
              dot += q8s[c16 * 16 + j * 4 + byte] * (int)(int8_t)(words[j] >> (8 * byte));
        }
      }
      logit = __fmul_rn(__fmul_rn((float)dot, qs), __bfloat162float(ksb[t]));
    }
    w_s[t] = logit;
    mx = fmaxf(mx, logit);
  }
  return mx;
}

// w_s[t] = exp(w_s[t] - mx) * v_scale[t], the softmax weights times the
// value scales; adds this thread's share of the exp sum to *sum and of the
// weights' max to *wamax.
template <int KVBITS>
__device__ __forceinline__ void cache_weights(float* w_s, const __nv_bfloat16* vsb,
                                              int t_cap, float mx, SoftmaxSum<KVBITS>* sum,
                                              float* wamax) {
  for (int t = threadIdx.x; t < t_cap; t += kAttnThreads) {
    const float e = softmax_exp<KVBITS>(w_s[t] - mx);
    *sum += e;
    const float wv = e * __bfloat162float(vsb[t]);
    w_s[t] = wv;
    *wamax = fmaxf(*wamax, wv);
  }
}

// Channel threadIdx.x of sum_t w8[t] * v[t, c] over an int4 or int8 value
// cache, with the int8 weights w8 in w_s (visible to the block): warps split
// T, a lane owns 4 channels, and the warps' partial sums meet in `part`. At
// int8 the sums are taken in int32 (exact), then rounded to f32 once, as
// the plain version's exact sum is.
template <int KVBITS>
__device__ __forceinline__ float cache_weighted_sum(const float* w_s, const uint8_t* vb,
                                                    int t_cap,
                                                    float (*part)[kDh]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (KVBITS == 8) {
    int a[4] = {0, 0, 0, 0};
    for (int t = warp; t < t_cap; t += kAttnThreads / 32) {
      const int wt = (int)w_s[t];
      if (wt == 0) continue;
      const uint32_t quad = *reinterpret_cast<const uint32_t*>(vb + (size_t)t * kDh + 4 * lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] += wt * (int)(int8_t)(quad >> (8 * j));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = __int_as_float(a[j]);
    __syncthreads();
    int ov = 0;
#pragma unroll
    for (int w = 0; w < kAttnThreads / 32; ++w) ov += __float_as_int(part[w][threadIdx.x]);
    return (float)ov;
  }
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = warp; t < t_cap; t += kAttnThreads / 32) {
    const float wt = w_s[t];
    if (wt == 0.f) continue;
    const uint32_t pair =
        *reinterpret_cast<const uint16_t*>(vb + (size_t)t * (kDh / 2) + 2 * lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] += wt * (float)((int)((pair >> (4 * j)) & 0xFu) - 8);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = a[j];
  __syncthreads();
  float ov = 0.f;
#pragma unroll
  for (int w = 0; w < kAttnThreads / 32; ++w) ov += part[w][threadIdx.x];
  return ov;
}

// grid B * H, kDh threads; dynamic shared memory t_cap floats
template <int KVBITS>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(AttnArgs p) {
  extern __shared__ float w_s[];  // logits, then weights, then int8 weights
  __shared__ float red[kAttnThreads / 32];
  __shared__ double red_d[kAttnThreads / 32];
  __shared__ float qraw[kDh], kraw[kDh];
  __shared__ int q8s[kDh];
  __shared__ float part[kAttnThreads / 32][kDh];
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads, d = threadIdx.x;
  const int dim = p.heads * kDh;
  const RopeQuant r = rope_quant(p.qkv + (size_t)b * 3 * dim + h * kDh, dim,
                                 p.cos + b * kDh, p.sin + b * kDh, p.sm_scale, qraw, kraw,
                                 red);
  const size_t lbh = ((size_t)p.layer * p.batch + b) * p.heads + h;
  p.knew[lbh * kDh + d] = (int8_t)r.k8;
  p.vnew[lbh * kDh + d] = (int8_t)r.v8;
  if (d == 0) {
    p.knew_s[lbh] = r.ks;
    p.vnew_s[lbh] = r.vs;
  }
  q8s[d] = (int)r.q8;
  const float vcur = r.v8 * r.vs;
  // the current token's logit: the exact int8 dot, then its two scales
  // (a sum of integers in f32 is exact in any order)
  const float lcur = __fmul_rn(__fmul_rn(block_reduce<false>(r.q8 * r.k8, red), r.ks), r.qs);

  const int t_cap = p.t_cap;
  const float mx = block_reduce<true>(
      cache_logits<KVBITS>(q8s, r.qs, p.k_cache + lbh * t_cap * row_bytes<KVBITS>(),
                           p.k_scale + lbh * t_cap, p.kv_mask + (size_t)b * t_cap, t_cap,
                           w_s, lcur),
      red);
  SoftmaxSum<KVBITS> sum = 0;
  float wamax = 0.f;
  cache_weights<KVBITS>(w_s, p.v_scale + lbh * t_cap, t_cap, mx, &sum, &wamax);
  const float wc = softmax_exp<KVBITS>(lcur - mx);
  const float denom = (float)(block_sum(sum, red, red_d) + wc);
  const float wrs = row_scale(block_reduce<true>(wamax, red));
  const float winv = 1.f / wrs;
  for (int t = d; t < t_cap; t += kAttnThreads) w_s[t] = quant8(w_s[t], winv);
  __syncthreads();
  const float ov = cache_weighted_sum<KVBITS>(w_s, p.v_cache + lbh * t_cap * row_bytes<KVBITS>(),
                                              t_cap, part);
  const float attn = __fadd_rn(__fmul_rn(ov, wrs), __fmul_rn(wc, vcur)) / denom;

  // int8 per (row, head) for the o-projection
  const float as = row_scale(block_reduce<true>(fabsf(attn), red));
  p.a8[(size_t)b * dim + h * kDh + d] = (int8_t)quant8(attn, 1.f / as);
  if (d == 0) p.ars[(size_t)b * p.heads + h] = as;
}

// ------------------------------------------------ 3a-b. the pf chunk's rows
struct ChunkArgs {
  const float* qkv;            // (R, 3D); the chunk's rows start at row `batch`
  const float* cos;            // (c, Dh) at the chunk's positions
  const float* sin;
  const int* amask;            // (c,) the chunk's real columns
  const uint8_t* k_work;       // (L, H, T2, Dh/2 or Dh) the stream's working cache
  const __nv_bfloat16* k_work_s;  // (L, H, T2)
  const uint8_t* v_work;
  const __nv_bfloat16* v_work_s;
  const int* work_mask;        // (T2,) the working-cache columns the chunk sees
  int8_t* knew;                // (L, c, H, Dh) the chunk's K/V
  float* knew_s;               // (L, c, H)
  int8_t* vnew;
  float* vnew_s;
  int8_t* a8;                  // (R, D): 3a leaves the chunk's int8 q here,
  float* ars;                  // (R, H)   3b overwrites it with the output
  int layer, batch, chunk, heads, t2;
  float sm_scale;
};

// 3a. grid c * H, kDh threads: the chunk rows' RoPE and int8 q/k/v
__global__ void __launch_bounds__(kAttnThreads) chunk_rope_quant_kernel(ChunkArgs p) {
  __shared__ float red[kAttnThreads / 32];
  __shared__ float qraw[kDh], kraw[kDh];
  const int i = blockIdx.x / p.heads, h = blockIdx.x % p.heads, d = threadIdx.x;
  const int dim = p.heads * kDh, row = p.batch + i;
  const RopeQuant r = rope_quant(p.qkv + (size_t)row * 3 * dim + h * kDh, dim,
                                 p.cos + i * kDh, p.sin + i * kDh, p.sm_scale, qraw, kraw,
                                 red);
  const size_t lih = ((size_t)p.layer * p.chunk + i) * p.heads + h;
  p.knew[lih * kDh + d] = (int8_t)r.k8;
  p.vnew[lih * kDh + d] = (int8_t)r.v8;
  p.a8[(size_t)row * dim + h * kDh + d] = (int8_t)r.q8;
  if (d == 0) {
    p.knew_s[lih] = r.ks;
    p.vnew_s[lih] = r.vs;
    p.ars[(size_t)row * p.heads + h] = r.qs;
  }
}

// 3b. grid c * H, kDh threads; dynamic shared memory T2 + c floats
template <int KVBITS>
__global__ void __launch_bounds__(kAttnThreads) chunk_attention_kernel(ChunkArgs p) {
  extern __shared__ float w_s[];  // T2 working-cache weights, then c inline ones
  __shared__ float red[kAttnThreads / 32];
  __shared__ double red_d[kAttnThreads / 32];
  __shared__ int q8s[kDh];
  __shared__ float part[kAttnThreads / 32][kDh];
  const int i = blockIdx.x / p.heads, h = blockIdx.x % p.heads, d = threadIdx.x;
  const int dim = p.heads * kDh, row = p.batch + i, t2 = p.t2, c = p.chunk;
  q8s[d] = p.a8[(size_t)row * dim + h * kDh + d];
  const float qs = p.ars[(size_t)row * p.heads + h];
  __syncthreads();  // q8s complete
  const size_t lh = (size_t)p.layer * p.heads + h;
  const size_t col0 = (size_t)p.layer * c * p.heads + h;  // (layer, column 0, h)
  float mx = cache_logits<KVBITS>(q8s, qs, p.k_work + lh * t2 * row_bytes<KVBITS>(),
                                  p.k_work_s + lh * t2, p.work_mask, t2, w_s, kNegInf);
  // the inline causal block: the exact int8 dot with column j's key, then
  // its scale and the query's, as the decode rows' current-token term
  float* wi_s = w_s + t2;
  for (int j = d; j < c; j += kAttnThreads) {
    float logit = kNegInf;
    if (j <= i && p.amask[j] != 0) {
      const size_t cj = col0 + (size_t)j * p.heads;
      const int4* key = reinterpret_cast<const int4*>(p.knew + cj * kDh);
      int dot = 0;
#pragma unroll
      for (int w16 = 0; w16 < kDh / 16; ++w16) {
        const int4 wv = key[w16];
        const int words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int byte = 0; byte < 4; ++byte)
            dot += q8s[w16 * 16 + k * 4 + byte] * (int)(int8_t)(words[k] >> (8 * byte));
      }
      logit = __fmul_rn(__fmul_rn((float)dot, p.knew_s[cj]), qs);
    }
    wi_s[j] = logit;
    mx = fmaxf(mx, logit);
  }
  mx = block_reduce<true>(mx, red);
  SoftmaxSum<KVBITS> sum = 0, sum_i = 0;
  float wamax = 0.f;
  cache_weights<KVBITS>(w_s, p.v_work_s + lh * t2, t2, mx, &sum, &wamax);
  for (int j = d; j < c; j += kAttnThreads) {
    const float e = softmax_exp<KVBITS>(wi_s[j] - mx);
    wi_s[j] = e;
    sum_i += e;
  }
  const float denom = (float)(block_sum(sum, red, red_d) + block_sum(sum_i, red, red_d));
  const float wrs = row_scale(block_reduce<true>(wamax, red));
  const float winv = 1.f / wrs;
  for (int t = d; t < t2; t += kAttnThreads) w_s[t] = quant8(w_s[t], winv);
  __syncthreads();
  const float ov = cache_weighted_sum<KVBITS>(w_s, p.v_work + lh * t2 * row_bytes<KVBITS>(), t2,
                                              part);
  // the inline sum over the chunk's dequantized values, in column order
  SoftmaxSum<KVBITS> ovi = 0;
  for (int j = 0; j < c; ++j) {
    const float wj = wi_s[j];
    if (wj == 0.f) continue;
    const size_t cj = col0 + (size_t)j * p.heads;
    ovi += (SoftmaxSum<KVBITS>)wj * ((float)p.vnew[cj * kDh + d] * p.vnew_s[cj]);
  }
  const float attn = __fadd_rn(__fmul_rn(ov, wrs), (float)ovi) / denom;
  const float as = row_scale(block_reduce<true>(fabsf(attn), red));
  p.a8[(size_t)row * dim + h * kDh + d] = (int8_t)quant8(attn, 1.f / as);
  if (d == 0) p.ars[(size_t)row * p.heads + h] = as;
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

// Sets a kernel's dynamic shared memory limit once it exceeds the default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* set) {
  if (bytes <= *set) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *set = bytes;
  return e;
}

// The entry point's operands (see mmor_mega_decode below).
struct MegaArgs {
  const void *x_in, *layers_host, *norms, *k_cache, *k_scale, *v_cache, *v_scale, *kv_mask,
      *cos, *sin;
  void *x_res, *x2, *hq, *hrs, *qkv, *a8, *ars, *mbuf, *x_out, *knew, *knew_s, *vnew, *vnew_s;
  const void *x_pf, *cos_pf, *sin_pf, *amask, *k_work, *k_work_s, *v_work, *v_work_s,
      *work_mask;
  void *x_pf_out, *knew_pf, *knew_pf_s, *vnew_pf, *vnew_pf_s;
  int n_layers, batch, dim, heads, ffn, t_cap, ck, chunk, t2;
  float eps, sm_scale;
};

// One weight phase at the weights' width: W4A8 with per-(K-chunk, channel)
// scales, or W8A8 with per-channel scales.
template <int WBITS, int EPI>
cudaError_t project(const w4a8::SkinnyArgs& p, cudaStream_t s) {
  if constexpr (WBITS == 4)
    return w4a8::launch_skinny<EPI, float>(p, s);
  else
    return w8a8::launch_skinny<EPI>(p, s);
}

// All L layers at one (WBITS, KVBITS) pair: the kernel sequence above.
template <int WBITS, int KVBITS>
int run_layers(const MegaArgs& a, cudaStream_t s) {
  const void* const* lp = static_cast<const void* const*>(a.layers_host);
  auto slot = [&](int which, int l) { return lp[which * a.n_layers + l]; };
  const int batch = a.batch, dim = a.dim, heads = a.heads, ffn = a.ffn, ck = a.ck;
  const int chunk = a.chunk, t2 = a.t2, t_cap = a.t_cap;
  float* xr = static_cast<float*>(a.x_res);
  float* x2f = static_cast<float*>(a.x2);
  const float* nf = static_cast<const float*>(a.norms);
  const uint32_t* hq32 = static_cast<const uint32_t*>(a.hq);
  const float* hrsf = static_cast<const float*>(a.hrs);
  const int rows = batch + chunk;
  const int count = batch * dim, count_pf = chunk * dim;
  const size_t attn_smem = (size_t)t_cap * sizeof(float);
  const size_t chunk_smem = (size_t)(t2 + chunk) * sizeof(float);
  static size_t attn_smem_set = 48 * 1024, chunk_smem_set = 48 * 1024;
  cudaError_t e;
  if ((e = allow_smem(attention_kernel<KVBITS>, attn_smem, &attn_smem_set)) != cudaSuccess)
    return (int)e;
  if (chunk > 0 && (e = allow_smem(chunk_attention_kernel<KVBITS>, chunk_smem,
                                   &chunk_smem_set)) != cudaSuccess)
    return (int)e;
  widen_kernel<<<(count + 255) / 256, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a.x_in), xr, count);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (chunk > 0) {
    widen_kernel<<<(count_pf + 255) / 256, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a.x_pf), xr + count, count_pf);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }

  for (int l = 0; l < a.n_layers; ++l) {
    const float* norm1 = nf + (size_t)l * 2 * dim;
    const float* norm2 = norm1 + dim;
    // 1-2: attention norm, chunk quantization, fused qkv
    if ((e = norm_quant(xr, norm1, a.hq, a.hrs, rows, dim, ck, a.eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pq{hq32, hrsf, static_cast<const uint32_t*>(slot(0, l)),
                        static_cast<const float*>(slot(1, l)), nullptr, a.qkv,
                        rows, dim, 3 * dim, ck, ck};
    if ((e = project<WBITS, w4a8::kStoreF32>(pq, s)) != cudaSuccess) return (int)e;
    // 3: attention of the decode rows
    AttnArgs pa{static_cast<const float*>(a.qkv), static_cast<const float*>(a.cos),
                static_cast<const float*>(a.sin), static_cast<const uint8_t*>(a.k_cache),
                static_cast<const __nv_bfloat16*>(a.k_scale),
                static_cast<const uint8_t*>(a.v_cache),
                static_cast<const __nv_bfloat16*>(a.v_scale),
                static_cast<const int*>(a.kv_mask), static_cast<int8_t*>(a.knew),
                static_cast<float*>(a.knew_s), static_cast<int8_t*>(a.vnew),
                static_cast<float*>(a.vnew_s), static_cast<int8_t*>(a.a8),
                static_cast<float*>(a.ars), l, batch, heads, t_cap, a.sm_scale};
    attention_kernel<KVBITS><<<batch * heads, kAttnThreads, attn_smem, s>>>(pa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // 3a-b: the chunk rows' q/k/v, then their attention
    if (chunk > 0) {
      ChunkArgs pc{static_cast<const float*>(a.qkv), static_cast<const float*>(a.cos_pf),
                   static_cast<const float*>(a.sin_pf), static_cast<const int*>(a.amask),
                   static_cast<const uint8_t*>(a.k_work),
                   static_cast<const __nv_bfloat16*>(a.k_work_s),
                   static_cast<const uint8_t*>(a.v_work),
                   static_cast<const __nv_bfloat16*>(a.v_work_s),
                   static_cast<const int*>(a.work_mask), static_cast<int8_t*>(a.knew_pf),
                   static_cast<float*>(a.knew_pf_s), static_cast<int8_t*>(a.vnew_pf),
                   static_cast<float*>(a.vnew_pf_s), static_cast<int8_t*>(a.a8),
                   static_cast<float*>(a.ars), l, batch, chunk, heads, t2, a.sm_scale};
      chunk_rope_quant_kernel<<<chunk * heads, kAttnThreads, 0, s>>>(pc);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      chunk_attention_kernel<KVBITS><<<chunk * heads, kAttnThreads, chunk_smem, s>>>(pc);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    // 4: o-projection (activation scales per (row, head)) + residual
    w4a8::SkinnyArgs po{static_cast<const uint32_t*>(a.a8), static_cast<const float*>(a.ars),
                        static_cast<const uint32_t*>(slot(2, l)),
                        static_cast<const float*>(slot(3, l)), xr, a.x2, rows, dim, dim,
                        ck, kDh};
    if ((e = project<WBITS, w4a8::kResidF32>(po, s)) != cudaSuccess) return (int)e;
    // 5-6: MLP norm, chunk quantization, gate_up with SwiGLU
    if ((e = norm_quant(x2f, norm2, a.hq, a.hrs, rows, dim, ck, a.eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pg{hq32, hrsf, static_cast<const uint32_t*>(slot(4, l)),
                        static_cast<const float*>(slot(5, l)), nullptr, a.mbuf,
                        rows, dim, 2 * ffn, ck, ck};
    if ((e = project<WBITS, w4a8::kSwiGLU>(pg, s)) != cudaSuccess) return (int)e;
    // 7-8: chunk quantization of the SwiGLU output, down + residual
    if ((e = norm_quant(static_cast<const float*>(a.mbuf), nullptr, a.hq, a.hrs, rows, ffn,
                        ck, a.eps, s)) != cudaSuccess)
      return (int)e;
    w4a8::SkinnyArgs pd{hq32, hrsf, static_cast<const uint32_t*>(slot(6, l)),
                        static_cast<const float*>(slot(7, l)), x2f, xr, rows, ffn, dim,
                        ck, ck};
    if ((e = project<WBITS, w4a8::kResidF32>(pd, s)) != cudaSuccess) return (int)e;
  }
  narrow_kernel<<<(count + 255) / 256, 256, 0, s>>>(xr, static_cast<__nv_bfloat16*>(a.x_out),
                                                    count);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (chunk > 0)
    narrow_kernel<<<(count_pf + 255) / 256, 256, 0, s>>>(
        xr + count, static_cast<__nv_bfloat16*>(a.x_pf_out), count_pf);
  return (int)cudaGetLastError();
}

}  // namespace

// Layer-pointer slots in the host array `layers` (8 * L device pointers):
// slot * L + layer, slot 0/1 qkv w/scale, 2/3 o, 4/5 gate_up, 6/7 down:
// (K/8, N) int32 words and (K/ck, N) f32 scales at wbits 4, (K/4, N) words
// and (N,) f32 scales at wbits 8. x_in (B, D) bf16; norms (L, 2, D) f32;
// caches (L, B, H, T, Dh/2) uint8 at kvbits 4 or (L, B, H, T, Dh) int8 at
// kvbits 8, with (L, B, H, T) bf16 scales; kv_mask (B, T) int32; cos/sin
// (B, Dh) f32. Scratch for R = B + chunk rows: x_res, x2 (R, D) f32; hq (R,
// max(D, F)) int8; hrs (R, max(D, F) / ck) f32; qkv (R, 3D) f32; a8 (R, D)
// int8; ars (R, H) f32; mbuf (R, F) f32. Outputs: x_out (B, D) bf16 (before
// the final norm); knew/vnew (L, B, H, Dh) int8; knew_s/vnew_s (L, B, H)
// f32. pf rows (chunk > 0, else these pointers are null): x_pf (c, D) bf16;
// cos_pf/sin_pf (c, Dh) f32; amask (c,) int32; the working cache k_work/
// v_work (L, H, T2, Dh/2) uint8 or (L, H, T2, Dh) int8 (the decode cache's
// width) with k_work_s/v_work_s (L, H, T2) bf16; work_mask (T2,) int32.
// Their outputs: x_pf_out (c, D) bf16; knew_pf/vnew_pf (L, c, H, Dh) int8;
// knew_pf_s/vnew_pf_s (L, c, H) f32.
extern "C" int mmor_mega_decode(
    const void* x_in, const void* layers_host, const void* norms, const void* k_cache,
    const void* k_scale, const void* v_cache, const void* v_scale, const void* kv_mask,
    const void* cos, const void* sin, void* x_res, void* x2, void* hq, void* hrs,
    void* qkv, void* a8, void* ars, void* mbuf, void* x_out, void* knew, void* knew_s,
    void* vnew, void* vnew_s, const void* x_pf, const void* cos_pf, const void* sin_pf,
    const void* amask, const void* k_work, const void* k_work_s, const void* v_work,
    const void* v_work_s, const void* work_mask, void* x_pf_out, void* knew_pf,
    void* knew_pf_s, void* vnew_pf, void* vnew_pf_s, int n_layers, int batch, int dim,
    int heads, int ffn, int t_cap, int ck, int chunk, int t2, int wbits, int kvbits,
    float eps, float sm_scale, void* stream) {
  if ((wbits != 4 && wbits != 8) || (kvbits != 4 && kvbits != 8))
    return (int)cudaErrorInvalidValue;
  if (dim != heads * kDh || ck % (wbits == 4 ? 256 : 128) ||
      ck > kQuantThreads * kMaxChunkPerThread || dim / ck > kMaxNormChunks || dim % ck ||
      ffn % ck || chunk < 0)
    return (int)cudaErrorInvalidValue;
  if (chunk > 0 && (t2 < 1 || !x_pf || !cos_pf || !sin_pf || !amask || !k_work ||
                    !k_work_s || !v_work || !v_work_s || !work_mask || !x_pf_out ||
                    !knew_pf || !knew_pf_s || !vnew_pf || !vnew_pf_s))
    return (int)cudaErrorInvalidValue;
  const MegaArgs a{x_in, layers_host, norms, k_cache, k_scale, v_cache, v_scale, kv_mask,
                   cos, sin, x_res, x2, hq, hrs, qkv, a8, ars, mbuf, x_out, knew, knew_s,
                   vnew, vnew_s, x_pf, cos_pf, sin_pf, amask, k_work, k_work_s, v_work,
                   v_work_s, work_mask, x_pf_out, knew_pf, knew_pf_s, vnew_pf, vnew_pf_s,
                   n_layers, batch, dim, heads, ffn, t_cap, ck, chunk, t2, eps, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wbits == 4) return kvbits == 4 ? run_layers<4, 4>(a, s) : run_layers<4, 8>(a, s);
  return kvbits == 4 ? run_layers<8, 4>(a, s) : run_layers<8, 8>(a, s);
}
