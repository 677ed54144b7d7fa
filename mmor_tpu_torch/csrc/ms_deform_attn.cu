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
// A channel's arithmetic, in this order (tests/test_torch_deform_sampler.py
// states it as k6_order_model, and the card tests hold both kernels to it
// bit for bit): levels, then points, then the corners (y0, x0), (y0, x1),
// (y1, x0), (y1, x1); the point's coordinate t = coord * size - 0.5 and each
// corner weight (a * wy) * wx as separate f32 roundings (__fmul_rn,
// __fsub_rn); acc = acc + weight * value (__fadd_rn of a __fmul_rn) for each
// corner whose weight is not 0; one cast to the value's dtype.
//
// What bounds it on the H100: device-memory bytes by the count (at the
// DVIS++ serving shapes, 3 frames of 736x1280: levels 23x40, 46x80, 92x160,
// S = Lq = 19,320, M = 8, D = 32, L = 3, P = 4, it reads 29.7 MB of bf16
// values, 44.5 MB of f32 locations and the weights, and writes 29.7 MB:
// 0.034 ms), but in fact the gather: each of the 22.3 M samples' corners is
// a 64-byte row of one head, 1.42 GB of requests that L1 and L2 serve from
// the 29.7 MB value map (it fits in the 50 MB L2). The first form (PR 3: a
// thread an output channel, 12 serial location-then-value round trips a
// thread, every lane of a row recomputing the same coefficients, 64-bit
// indices) was latency-bound at 28x the byte bound.
//
// Design (ms_deform_attn_kernel, the templated form, L = 3 and P = 4): a
// lane owns a (query, head, chunk) of 16 bytes of channels (8 bf16 or 4
// f32), so a head's C = D / chunk lanes are neighbours and one warp load
// fetches 32 chunks of up to 32 / C corner rows. The L x P points of a
// (query, head) are shared among its C lanes: lane c loads the locations
// and weights of points c, c + C, ... (the streaming hint: they are read
// once) and computes their four corner weights and first pixel once; the
// lanes that need a point take it by __shfl_sync. For each point the four
// corner loads go out together (a corner of weight 0 is not loaded), then
// are added in order; the loops are unrolled on L and P. Offsets inside a
// frame are 32-bit (the host checks S x M x D < 2^31). A block is 256
// consecutive lanes: 8 neighbouring queries (pixels of one level) at the
// serving shape, whose overlapping windows meet in L1. The register cap of
// 64 (4 blocks, 32 warps an SM) is the measured choice (development
// builds, the serving case on an H100): a level's 16 corner loads in flight
// at 118 registers (2 blocks an SM) took 0.257 ms, 8 loads at 80 registers
// 0.204-0.208, a point's 4 at 64 registers 0.186-0.187, at 48 or 40
// registers 0.194 and 0.226; several blocks' worth of queries a block made
// no difference. ms_deform_attn_generic_kernel takes every other shape (any
// L up to 8 and P, any D, 64-bit offsets): a lane a (query, head, chunk of
// the widest vector that divides D), computing its own coefficients, a
// point's four corner loads together. Both keep the order above, so they
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;
// blocks an SM the templated form's registers leave room for: 64 registers
// a thread, 32 warps an SM
constexpr int kMinBlocks = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// kVec channels of one corner row as 32-bit words (a lone bf16 in the low
// half of one word), loaded with one vector load
template <typename V, int kVec>
struct Chunk {
  static constexpr int kBytes = kVec * (int)sizeof(V);
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const V* p) {
    if constexpr (kBytes == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  // channel i as f32 (exact)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(V) == 4) return __uint_as_float(w[i]);
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// the f32 sums of kVec channels, cast once to V and stored with one vector store
template <typename V, int kVec>
__device__ __forceinline__ void store_chunk(V* p, const float (&acc)[kVec]) {
  using C = Chunk<V, kVec>;
  uint32_t w[C::kWords];
#pragma unroll
  for (int i = 0; i < C::kWords; ++i) {
    if constexpr (sizeof(V) == 4) {
      w[i] = __float_as_uint(acc[i]);
    } else {
      w[i] = bf16_bits(acc[2 * i]);
      if (2 * i + 1 < kVec) w[i] |= bf16_bits(acc[2 * i + 1]) << 16;
    }
  }
  if constexpr (C::kBytes == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (C::kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (C::kBytes == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
  }
}

template <typename V>
__device__ __forceinline__ float weight_at(const V* p) {  // read once: streaming
  if constexpr (sizeof(V) == 4) return __ldcs(reinterpret_cast<const float*>(p));
  return __uint_as_float((uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// One point's corners: the weights of (y0, x0), (y0, x1), (y1, x0), (y1, x1)
// (0 for a corner a 1-pixel axis does not have) and the level pixel of
// (y0, x0), in the plain version's arithmetic, uncontracted.
struct Point {
  float wt[4];
  int pix;  // row-major pixel of the level
};

__device__ __forceinline__ Point point_of(float2 xy, float a, int h, int w) {
  const float hmax = (float)max(h - 2, 0), wmax = (float)max(w - 2, 0);
  const float x = __fsub_rn(__fmul_rn(xy.x, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, (float)h), 0.5f);
  const float x0 = fminf(fmaxf(floorf(x), 0.f), wmax);
  const float y0 = fminf(fmaxf(floorf(y), 0.f), hmax);
  const float wx0 = fmaxf(0.f, 1.f - fabsf(x - x0));
  const float wx1 = fmaxf(0.f, 1.f - fabsf(x - (x0 + 1.f)));
  const float ay0 = __fmul_rn(a, fmaxf(0.f, 1.f - fabsf(y - y0)));
  const float ay1 = __fmul_rn(a, fmaxf(0.f, 1.f - fabsf(y - (y0 + 1.f))));
  Point pt;
  pt.wt[0] = __fmul_rn(ay0, wx0);
  pt.wt[1] = w > 1 ? __fmul_rn(ay0, wx1) : 0.f;
  pt.wt[2] = h > 1 ? __fmul_rn(ay1, wx0) : 0.f;
  pt.wt[3] = w > 1 && h > 1 ? __fmul_rn(ay1, wx1) : 0.f;
  pt.pix = (int)y0 * w + (int)x0;
  return pt;
}

// acc += wt * corner for each channel (the caller skips a weight of 0)
template <typename V, int kVec>
__device__ __forceinline__ void add(float (&acc)[kVec], float wt, const Chunk<V, kVec>& v) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wt, v.at(e)));
}

// The templated form: L levels, P points, C lanes a head (16-byte chunks),
// lanes (query, head, chunk) in order, a block 256 consecutive lanes.
template <typename V, int C, int L, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ms_deform_attn_kernel(const V* __restrict__ value, const float2* __restrict__ loc,
               const V* __restrict__ attn, V* __restrict__ out, Levels lv, int s_len, int lq,
               int heads, int64_t lanes) {
  constexpr int kVec = 16 / (int)sizeof(V), kLP = L * P;
  constexpr int kSlots = (kLP + C - 1) / C;  // points a lane computes
  const int lane = threadIdx.x % 32;
  const int d = C * kVec, row = heads * d;  // channels of a head, of a pixel
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t - lane >= lanes) return;  // the whole warp is past the end
  const bool live = t < lanes;    // the rest take part in the shuffles
  const int64_t qh = (live ? t : 0) / C;  // (n * Lq + q) * M + m
  const int c = (int)((live ? t : 0) % C), m = (int)(qh % heads);
  const int64_t n = qh / ((int64_t)lq * heads);
  const V* vb = value + n * s_len * row + m * d + c * kVec;

  // this lane's points c, c + C, ...: their corner weights and pixels
  Point pts[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = s * C + c;
    pts[s].wt[0] = pts[s].wt[1] = pts[s].wt[2] = pts[s].wt[3] = 0.f;
    pts[s].pix = 0;
    if (i < kLP) {
      int h = lv.h[0], w = lv.w[0], start = lv.start[0];
#pragma unroll
      for (int l = 1; l < L; ++l)
        if (i / P == l) h = lv.h[l], w = lv.w[l], start = lv.start[l];
      pts[s] = point_of(__ldcs(&loc[qh * kLP + i]), weight_at(&attn[qh * kLP + i]), h, w);
      pts[s].pix += start;
    }
  }

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int w = lv.w[l];
    const int step[4] = {0, 1, w, w + 1};  // the corners' pixels past (y0, x0)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p, src = (lane & ~(C - 1)) | (i % C);
      const Point& pt = pts[i / C];
      const int pix = __shfl_sync(0xffffffffu, pt.pix, src);
      float wt[4];
      Chunk<V, kVec> v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wt[k] = __shfl_sync(0xffffffffu, pt.wt[k], src);
        if (wt[k] != 0.f) v[k].load(vb + (pix + step[k]) * row);
        else v[k].zero();
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (wt[k] != 0.f) add(acc, wt[k], v[k]);
    }
  }
  if (live) store_chunk<V, kVec>(out + qh * d + c * kVec, acc);
}

// The generic form: any level (up to kMaxLevels) and point counts, any D
// (chunks of kVec channels), 64-bit offsets; a lane a (query, head, chunk)
// computing its own points.
template <typename V, int kVec>
__global__ void __launch_bounds__(kThreads)
ms_deform_attn_generic_kernel(const V* __restrict__ value, const float2* __restrict__ loc,
                       const V* __restrict__ attn, V* __restrict__ out, Levels lv,
                       int n_levels, int n_points, int s_len, int lq, int heads, int d,
                       int64_t lanes) {
  __shared__ Levels s_lv;  // indexed by a loop variable: kept out of local memory
  if (threadIdx.x == 0) s_lv = lv;
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= lanes) return;
  const int chunks = d / kVec;
  const int64_t qh = t / chunks;
  const int c = (int)(t % chunks), m = (int)(qh % heads);
  const int64_t n = qh / ((int64_t)lq * heads), row = (int64_t)heads * d;
  const V* vb = value + n * s_len * row + (int64_t)m * d + (int64_t)c * kVec;
  const int lp = n_levels * n_points;

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int l = 0; l < n_levels; ++l) {
    const int h = s_lv.h[l], w = s_lv.w[l];
    const int64_t step[4] = {0, row, w * row, (w + 1) * row};
    const V* vl = vb + (int64_t)s_lv.start[l] * row;
    for (int p = 0; p < n_points; ++p) {
      const int64_t i = qh * lp + l * n_points + p;
      const Point pt = point_of(__ldcs(&loc[i]), weight_at(&attn[i]), h, w);
      const V* v00 = vl + (int64_t)pt.pix * row;
      Chunk<V, kVec> v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (pt.wt[k] != 0.f) v[k].load(v00 + step[k]);
        else v[k].zero();
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (pt.wt[k] != 0.f) add(acc, pt.wt[k], v[k]);
    }
  }
  store_chunk<V, kVec>(out + qh * d + (int64_t)c * kVec, acc);
}

template <typename K, typename... Args>
int launch_lanes(K kernel, int64_t blocks, cudaStream_t stream, Args... args) {
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename V, int kVec>
int launch_generic(const V* value, const float2* loc, const V* attn, V* out, const Levels& lv,
                   int n_levels, int n_points, int n, int s_len, int lq, int heads, int d,
                   cudaStream_t stream) {
  const int64_t lanes = (int64_t)n * lq * heads * (d / kVec);
  return launch_lanes(ms_deform_attn_generic_kernel<V, kVec>, (lanes + kThreads - 1) / kThreads,
                      stream, value, loc, attn, out, lv, n_levels, n_points, s_len, lq, heads, d,
                      lanes);
}

template <typename V, int C>
int launch_templated(const V* value, const float2* loc, const V* attn, V* out,
                     const Levels& lv, int n, int s_len, int lq, int heads,
                     cudaStream_t stream) {
  const int64_t lanes = (int64_t)n * lq * heads * C;
  return launch_lanes(ms_deform_attn_kernel<V, C, 3, 4>, (lanes + kThreads - 1) / kThreads,
                      stream, value, loc, attn, out, lv, s_len, lq, heads, lanes);
}

template <typename V>
int launch(const void* value_, const void* loc_, const void* attn_, void* out_,
           const Levels& lv, int n_levels, int n_points, int n, int s_len, int lq, int heads,
           int d, bool generic, cudaStream_t stream) {
  const V* value = static_cast<const V*>(value_);
  const float2* loc = static_cast<const float2*>(loc_);
  const V* attn = static_cast<const V*>(attn_);
  V* out = static_cast<V*>(out_);
  if ((int64_t)n * lq * heads * d == 0) return (int)cudaSuccess;
  constexpr int kVec = 16 / (int)sizeof(V);
  // the templated form: the serving counts, 16-byte chunks, 2 to 8 lanes a
  // head, and a frame that 32-bit offsets span
  const int c = d % kVec == 0 ? d / kVec : 0;
  if (!generic && n_levels == 3 && n_points == 4 && (int64_t)s_len * heads * d < 0x7fffffff) {
    if (c == 1)
      return launch_templated<V, 1>(value, loc, attn, out, lv, n, s_len, lq, heads, stream);
    if (c == 2)
      return launch_templated<V, 2>(value, loc, attn, out, lv, n, s_len, lq, heads, stream);
    if (c == 4)
      return launch_templated<V, 4>(value, loc, attn, out, lv, n, s_len, lq, heads, stream);
    if (c == 8)
      return launch_templated<V, 8>(value, loc, attn, out, lv, n, s_len, lq, heads, stream);
  }
  // the widest vector of channels that divides D
  const int args_vec = d % kVec == 0 ? kVec : d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1;
#define K6_GENERIC(W)                                                                         \
  if (args_vec == W)                                                                          \
    return launch_generic<V, W>(value, loc, attn, out, lv, n_levels, n_points, n, s_len, lq, \
                                heads, d, stream);
  if constexpr (sizeof(V) == 2) { K6_GENERIC(8) }
  K6_GENERIC(4)
  K6_GENERIC(2)
  K6_GENERIC(1)
#undef K6_GENERIC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// value: (N, S, M, D) and attn: (N, Lq, M, L, P), both bf16 (bf16 = 1) or
// both f32; loc: (N, Lq, M, L, P, 2) f32; out: (N, Lq, M*D) in the value's
// dtype. shapes: host array of L (H, W) pairs, rows of the flattened S axis
// in level order. generic = 1 takes the generic form where the templated
// one applies (tests and timing). Returns the launch's cudaError_t.
extern "C" int mmor_ms_deform_attn(const void* value, const void* loc, const void* attn,
                                   void* out, const void* shapes, int n_levels, int n_points,
                                   int n, int s_len, int lq, int heads, int head_dim, int bf16,
                                   int generic, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  const int* hw = static_cast<const int*>(shapes);
  int64_t start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = (int)start;
    start += (int64_t)lv.h[l] * lv.w[l];
  }
  if (start != s_len) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(value, loc, attn, out, lv, n_levels, n_points, n, s_len, lq,
                                 heads, head_dim, generic != 0, st);
  return launch<float>(value, loc, attn, out, lv, n_levels, n_points, n, s_len, lq, heads,
                       head_dim, generic != 0, st);
}
