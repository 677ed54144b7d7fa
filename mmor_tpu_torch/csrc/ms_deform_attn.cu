// K6: multi-scale deformable attention sampling (forward).
//
// Replaces mmor_tpu/ops/deformable_sampler.py::ms_deform_attn_pallas (the
// _kernel / _precompute pair, the pl.pallas_call at :346).
//
// What it computes: for every (frame n, query q, head m) and each of the
// L x P sampling points, a bilinear sample of level l's (H, W, D) value map at
// the point's location (x, y in [0, 1], align_corners=False, zero padding),
// times the point's attention weight, summed over levels and points:
// out[n, q, m*D + d]. The semantics are those of the plain version,
// ops/deformable_attention.py::ms_deform_attn: a sample's 2x2 window starts
// at floor of its pixel coordinate clamped to [0, size - 2], each corner
// weighs max(0, 1 - |coord - corner|) at its actual coordinate (0 for a
// corner off the map), a 1-pixel level has a 1-wide window, and the sum is
// taken in f32 and written once in the value's dtype.
//
// What bounds it on the H100: device-memory bytes. At the DVIS++ serving
// shapes (3 frames of 736x1280: levels 23x40, 46x80, 92x160, S = Lq =
// 19,320, M = 8, D = 32, L = 3, P = 4) it reads 29.7 MB of bf16 values,
// 44.5 MB of f32 locations and the weights, and writes 29.7 MB; the
// arithmetic is ~1.4 GFLOP of f32 on the CUDA cores.
//
// Design: the TPU kernel's one-hot matrices over 32x40 value windows, its
// head-grouped 128-lane layouts and its overflow residual exist for the
// TPU's matrix unit and DMA rules; none of that carries over. This is the
// direct gather of the original MSDeformAttn CUDA op: one thread per output
// channel, so the D threads of a (n, q, m) row are neighbouring lanes (D = 32:
// one warp a row; D = 4 or 8: a warp holds 8 or 4 heads of a query). Each
// thread walks the L x P points: the point's location (one 8-byte load) and
// weight are the same address for all the row's lanes, which the hardware
// serves as one request and broadcasts; the up to four corners are D
// contiguous elements across the lanes (one coalesced segment each), skipped
// where their weight is 0. The level table lives in shared memory: indexed
// by a loop variable, a by-value kernel argument is copied to every
// thread's local memory first (96 bytes a thread). Every sample is computed
// exactly, so there is no overflow path. All N frames run in one launch. Not
// yet done (later work): bf16x2 loads, or a level's rows staged in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename V>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_kernel(const V* __restrict__ value, const float2* __restrict__ loc,
                      const V* __restrict__ attn, V* __restrict__ out, Levels lv,
                      int n_levels, int n_points, int s_len, int lq, int heads,
                      int d, int64_t total) {
  __shared__ Levels s_lv;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {  // constant indices: read in place
      s_lv.h[l] = lv.h[l];
      s_lv.w[l] = lv.w[l];
      s_lv.start[l] = lv.start[l];
    }
  }
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t row = t / d;  // (n * Lq + q) * M + m
  const int c = (int)(t - row * d);
  const int m = (int)(row % heads);
  const int64_t n = row / ((int64_t)lq * heads);
  const int64_t v_stride = (int64_t)heads * d;  // one spatial position
  const V* v_base = value + n * s_len * v_stride + (int64_t)m * d + c;
  const float2* loc_row = loc + row * n_levels * n_points;
  const V* attn_row = attn + row * n_levels * n_points;

  float acc = 0.f;
  // one corner: weight (a * wy) * wx, as in the plain version; skipped at 0
  auto add = [&](const V* v, float ay, float wx) {
    const float wgt = __fmul_rn(ay, wx);
    if (wgt != 0.f) acc = __fadd_rn(acc, __fmul_rn(wgt, to_float(*v)));
  };
  for (int l = 0; l < n_levels; ++l) {
    const int h = s_lv.h[l], w = s_lv.w[l];
    const V* v_level = v_base + (int64_t)s_lv.start[l] * v_stride;
    const float hmax = (float)max(h - 2, 0), wmax = (float)max(w - 2, 0);
    for (int p = 0; p < n_points; ++p) {
      const int i = l * n_points + p;
      const float2 xy = __ldg(&loc_row[i]);
      const float a = to_float(attn_row[i]);
      // the plain version's arithmetic, uncontracted: t = coord * size - 0.5
      const float x = __fsub_rn(__fmul_rn(xy.x, (float)w), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, (float)h), 0.5f);
      const float x0 = fminf(fmaxf(floorf(x), 0.f), wmax);
      const float y0 = fminf(fmaxf(floorf(y), 0.f), hmax);
      const float wx0 = fmaxf(0.f, 1.f - fabsf(x - x0));
      const float wx1 = fmaxf(0.f, 1.f - fabsf(x - (x0 + 1.f)));
      const float ay0 = __fmul_rn(a, fmaxf(0.f, 1.f - fabsf(y - y0)));
      const float ay1 = __fmul_rn(a, fmaxf(0.f, 1.f - fabsf(y - (y0 + 1.f))));
      // the 2x2 window (1-wide along a 1-pixel axis), rows then columns
      const V* v00 = v_level + ((int64_t)y0 * w + (int64_t)x0) * v_stride;
      add(v00, ay0, wx0);
      if (w > 1) add(v00 + v_stride, ay0, wx1);
      if (h > 1) {
        add(v00 + w * v_stride, ay1, wx0);
        if (w > 1) add(v00 + (w + 1) * v_stride, ay1, wx1);
      }
    }
  }
  store(out + t, acc);
}

template <typename V>
int launch(const void* value, const void* loc, const void* attn, void* out,
           const Levels& lv, int n_levels, int n_points, int n, int s_len, int lq,
           int heads, int d, cudaStream_t stream) {
  const int64_t total = (int64_t)n * lq * heads * d;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ms_deform_attn_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(value), static_cast<const float2*>(loc),
      static_cast<const V*>(attn), static_cast<V*>(out), lv, n_levels, n_points,
      s_len, lq, heads, d, total);
  return (int)cudaGetLastError();
}

}  // namespace

// value: (N, S, M, D) and attn: (N, Lq, M, L, P), both bf16 (bf16 = 1) or
// both f32; loc: (N, Lq, M, L, P, 2) f32; out: (N, Lq, M*D) in the value's
// dtype. shapes: host array of L (H, W) pairs, rows of the
// flattened S axis in level order. Returns the launch's cudaError_t.
extern "C" int mmor_ms_deform_attn(const void* value, const void* loc,
                                   const void* attn, void* out, const void* shapes,
                                   int n_levels, int n_points, int n, int s_len,
                                   int lq, int heads, int head_dim, int bf16,
                                   void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  const int* hw = static_cast<const int*>(shapes);
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != s_len) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(value, loc, attn, out, lv, n_levels, n_points, n, s_len,
                                 lq, heads, head_dim, st);
  return launch<float>(value, loc, attn, out, lv, n_levels, n_points, n, s_len, lq, heads,
                       head_dim, st);
}
