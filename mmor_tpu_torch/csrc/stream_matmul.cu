// K10a: W8A16 on an unpacked int8 weight, K10b: W8A16 on slab-packed int8
// or int4 words, and K10c's bf16 mode: W8A16 on row-packed int8 words, the
// kernels of the weight-stream microbenchmarks. The row-word instantiation
// is also K2's W8A16 branch at up to 16 rows (int8_matmul.cu calls
// mmor_wp_matmul), which serves decode steps: the lm_head at
// quant_int8_mxu=False and every projection of the per-op int8 path there.
//
// Replaces tools/perf/bench_w8a16.py::w8a16_matmul (_w8a16_kernel, the
// pl.pallas_call at :75), tools/perf/bench_packed.py::wp_matmul
// (make_wp_kernel, the pl.pallas_call at :109) and the bf16 mode of
// tools/perf/bench_bitcast.py::w8b_matmul (_kernel, the pl.pallas_call at
// :95).
//
// What bounds it on the H100: device-memory bytes. At the benchmarks' M = 16
// every weight byte (or half byte) is read once for 16 multiply-adds, far
// below the tensor cores' rate; the question the benchmarks ask is how close
// each weight layout comes to the card's bandwidth.
//
// Design: bf16 mma.sync.m16n8k16 with f32 accumulation, the TPU kernels'
// bf16 product. x arrives as bf16 (the wrapper's cast, as on the TPU); each
// weight value converts exactly to bf16 in registers (by I2F: the byte
// permutes of int8_matmul.cu's s8_pair_bf16 measured no faster here, where
// the loads' latency sets the time). A block of eight warps (sixteen,
// below) owns 32 columns and one 16-row m-tile (grid.y walks the m-tiles);
// its warps split the weight's word rows, four word rows (one per thread
// quad lane) a k-step, four k-steps of loads in flight before their
// products, and their partial sums meet in shared memory. Where the column blocks are too few
// to fill the card (K2's decode widths: 4096 columns are 128 blocks), a
// block is sixteen warps, twice the loads in flight an SM (at 8 rows on an
// H100, chip_smoke.py's phase 2: 11264 x 4096 from 0.032 to 0.026 ms,
// 4096 x 4096 from 0.0106 to 0.0099; eight k-steps in flight a warp
// instead, or a cluster of blocks splitting K, were slower). out = acc * scale in f32, cast to x's
// dtype. The mma does not care which real k its 16 k slots hold as long as A
// and B agree, so each thread's B registers take the values of one weight
// word and its A registers the x entries of the same k: every weight word is
// loaded once, by one thread, and nothing is shuffled. Nor does it care
// which real columns its 8 n slots are: a thread's four words are those of
// four neighbouring columns (one per 8-column tile), one 16-byte load. x
// comes in word order (the wrapper's copy for the slab formats: the TPU
// wrapper also cuts x into slabs), so a thread's x values of one word are
// one 8-byte load a row. The word formats (loaded by weight_words.cuh):
//  - Bytes (K10a): the (K, N) int8 weight; word r of a column is rows
//    4r..4r+3: a thread loads 4 bytes (its four columns) of each of the four
//    rows and transposes them;
//  - Slab8 (K10b w8p): pack4_int8's (K/4, N) int32, word (r, n) holds rows
//    r + i*K/4 in byte i;
//  - Slab4 (K10b w4p): pack8_int4's (K/8, N) int32, rows r + i*K/8 in
//    nibble i (values in [-8, 7], no bias): eight values, two k-steps a word;
//  - row words (K10c bf16, bench_bitcast's w8b_matmul): pack_int8_rows'
//    (K/4, N) int32, rows 4r..4r+3 in bytes 0..3 of word r. That is Slab8's
//    word format with x in its natural order (the k of word r already sit
//    at x[4r..4r+3]), so Slab8's instantiation runs it and the wrapper
//    passes x as it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "weight_words.cuh"

namespace {

// A weight format: how its words are laid out and how many bits a value
// takes; value i of a word sign-extends as the TPU kernel's
// (w << (32 - bits*(i+1))) >> (32 - bits).
template <WLayout L, int kBits> struct Format {
  static constexpr WLayout kLayout = L;
  static constexpr int kVals = 32 / kBits;  // values a word; word rows = K / kVals
  static __device__ __forceinline__ int value(uint32_t word, int i) {
    if constexpr (L == WLayout::kBytes) return (int)(int8_t)((word >> (8 * i)) & 0xffu);
    return (int)(word << (32 - kBits * (i + 1))) >> (32 - kBits);
  }
};
using Bytes = Format<WLayout::kBytes, 8>;  // K10a
using Slab8 = Format<WLayout::kWords, 8>;  // K10b w8p; K10c bf16 (row words)
using Slab4 = Format<WLayout::kWords, 4>;  // K10b w4p

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

constexpr int kCols = 32;
constexpr int kUnroll = 4;  // k-steps a warp loads before its products
constexpr int kFill = 2 * 132;  // blocks of 8 warps that fill the card twice over

// The A registers of k-step (r, j): rows g and g + 8 of the m-tile at the
// k of values 4j..4j+3 of word row r (0 for rows past M). x is in word
// order, the values of word row r at x[kVals*r .. kVals*r + kVals - 1], so
// they are one 8-byte load a row.
template <int kVals>
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* x_lo,
                                       const uint16_t* x_hi, bool lo, bool hi, int r,
                                       int j) {
  const uint2 z = make_uint2(0u, 0u);
  const int k0 = kVals * r + 4 * j;
  const uint2 l = lo ? *reinterpret_cast<const uint2*>(x_lo + k0) : z;
  const uint2 h = hi ? *reinterpret_cast<const uint2*>(x_hi + k0) : z;
  a[0] = l.x, a[1] = h.x, a[2] = l.y, a[3] = h.y;
}

// Column mapping: lane group g owns the four neighbouring columns
// n0 + 4g .. 4g + 3, one in each 8-column mma tile nt (so one 16-byte load
// fetches a thread's B words for all four tiles); the output of tile nt at
// mma column c is column n0 + 4c + nt.
template <typename Fm, typename OutT, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
stream_kernel(const uint16_t* __restrict__ x, const void* __restrict__ w,
              const float* __restrict__ scale, OutT* __restrict__ out, int m, int k, int n) {
  constexpr int kSteps = Fm::kVals / 4;  // mma k-steps a word
  __shared__ float red[kWarps][16][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * 16;
  const int col0 = n0 + 4 * g;
  const bool wide = (n % 4) == 0 && col0 + 3 < n;
  const int steps = k / Fm::kVals / 4;  // four word rows a step
  const bool row_lo = m0 + g < m, row_hi = m0 + g + 8 < m;
  const uint16_t* x_lo = x + (size_t)(m0 + g) * k;
  const uint16_t* x_hi = x + (size_t)(m0 + g + 8) * k;

  float acc[kCols / 8][4] = {};
  for (int s0 = warp * kUnroll; s0 < steps; s0 += kWarps * kUnroll) {
    uint4 wv[kUnroll];
    uint32_t a[kUnroll][kSteps][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = s0 + u < steps;
      const int r = (s0 + u) * 4 + t4;
      if (live && wide) {
        wv[u] = w_words4<Fm::kLayout>(w, r, col0, n);
      } else {
        wv[u].x = live && col0 < n ? w_word<Fm::kLayout>(w, r, col0, n) : 0u;
        wv[u].y = live && col0 + 1 < n ? w_word<Fm::kLayout>(w, r, col0 + 1, n) : 0u;
        wv[u].z = live && col0 + 2 < n ? w_word<Fm::kLayout>(w, r, col0 + 2, n) : 0u;
        wv[u].w = live && col0 + 3 < n ? w_word<Fm::kLayout>(w, r, col0 + 3, n) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        load_a<Fm::kVals>(a[u][j], x_lo, x_hi, live && row_lo, live && row_hi, r, j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt) {
          const uint32_t word = words[nt];
          const uint32_t b[2] = {
              pair(bf16_bits(Fm::value(word, 4 * j)), bf16_bits(Fm::value(word, 4 * j + 1))),
              pair(bf16_bits(Fm::value(word, 4 * j + 2)),
                   bf16_bits(Fm::value(word, 4 * j + 3)))};
          mma_bf16(acc[nt], a[u][j], b);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][g + (e >> 1) * 8][4 * (t4 * 2 + (e & 1)) + nt] = acc[nt][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * kCols; i += kWarps * 32) {
    const int row = m0 + i / kCols, col = n0 + i % kCols;
    if (row >= m || col >= n) continue;
    float sum = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][i / kCols][i % kCols];
    store(out + (size_t)row * n + col, sum * scale[col]);
  }
}

template <typename Fm, int kWarps>
int launch_warps(const void* x, const void* w, const void* scale, void* out, int m, int k,
                 int n, int out_bf16, cudaStream_t s) {
  const dim3 grid((n + kCols - 1) / kCols, (m + 15) / 16);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const float* sc = static_cast<const float*>(scale);
  if (out_bf16)
    stream_kernel<Fm, __nv_bfloat16, kWarps><<<grid, kWarps * 32, 0, s>>>(
        xb, w, sc, static_cast<__nv_bfloat16*>(out), m, k, n);
  else
    stream_kernel<Fm, float, kWarps><<<grid, kWarps * 32, 0, s>>>(
        xb, w, sc, static_cast<float*>(out), m, k, n);
  return (int)cudaGetLastError();
}

template <typename Fm>
int launch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
           int out_bf16, void* stream) {
  if (k % (4 * Fm::kVals) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = ((n + kCols - 1) / kCols) * ((m + 15) / 16);
  return blocks < kFill ? launch_warps<Fm, 16>(x, w, scale, out, m, k, n, out_bf16, s)
                        : launch_warps<Fm, 8>(x, w, scale, out, m, k, n, out_bf16, s);
}

}  // namespace

// K10a: x (M, K) bf16; w (K, N) int8 row-major; scale (N,) f32; out (M, N)
// bf16 (out_bf16 = 1) or f32. K must be a multiple of 16.
extern "C" int mmor_w8a16_bytes(const void* x, const void* w, const void* scale, void* out,
                                int m, int k, int n, int out_bf16, void* stream) {
  return launch<Bytes>(x, w, scale, out, m, k, n, out_bf16, stream);
}

// K10b: x (M, K) bf16 in word order (x[m, parts*r + i] holds column
// r + i*K/parts of the row); w (K/parts, N) int32 slab-packed (bits 8: parts
// 4, pack4_int8; bits 4: parts 8, pack8_int4); scale (N,) f32; out as above.
// K must be a multiple of 16 (bits 8) or 32 (bits 4). K10c's bf16 mode is
// bits 8 on pack_int8_rows' words with x in its natural order.
extern "C" int mmor_wp_matmul(const void* x, const void* w, const void* scale, void* out,
                              int m, int k, int n, int bits, int out_bf16, void* stream) {
  if (bits == 8) return launch<Slab8>(x, w, scale, out, m, k, n, out_bf16, stream);
  if (bits == 4) return launch<Slab4>(x, w, scale, out, m, k, n, out_bf16, stream);
  return (int)cudaErrorInvalidValue;
}
