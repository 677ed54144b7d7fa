// K10a: W8A16 on an unpacked int8 weight, K10b: W8A16 on slab-packed int8
// or int4 words, and K10c's bf16 mode: W8A16 on row-packed int8 words, the
// kernels of the weight-stream microbenchmarks. The row-word kernel is also
// K2's W8A16 branch at up to 16 rows (int8_matmul.cu calls mmor_wp_matmul),
// which serves decode steps: the lm_head at quant_int8_mxu=False and every
// projection of the per-op int8 path there.
//
// Replaces tools/perf/bench_w8a16.py::w8a16_matmul (_w8a16_kernel, the
// pl.pallas_call at :75), tools/perf/bench_packed.py::wp_matmul
// (make_wp_kernel, the pl.pallas_call at :109) and the bf16 mode of
// tools/perf/bench_bitcast.py::w8b_matmul (_kernel, the pl.pallas_call at
// :95).
//
// What bounds them on the H100: device-memory bytes. At the benchmarks' M =
// 16 every weight byte (or half byte) is read once for 16 multiply-adds, far
// below the tensor cores' rate; the question the benchmarks ask is how close
// each weight layout comes to the card's bandwidth.
//
// stream_kernel (K10c's bf16 mode, K2's W8A16 at decode rows): bf16
// mma.sync.m16n8k16 with f32 accumulation, the TPU kernels' bf16 product. x
// arrives as bf16 (the wrapper's cast, as on the TPU); each weight value
// converts exactly to bf16 in registers (by I2F: the byte permutes of
// int8_matmul.cu's s8_pair_bf16 measured no faster here, where the loads' latency sets the
// time). A block of eight warps (sixteen, below) owns 32 columns and one
// 16-row m-tile (grid.y walks the m-tiles); its warps split the weight's
// word rows, four word rows (one per thread quad lane) a k-step, four
// k-steps of loads in flight before their products, and their partial sums
// meet in shared memory. Where the column blocks are too few to fill the
// card (K2's decode widths: 4096 columns are 128 blocks), a block is sixteen
// warps, twice the loads in flight an SM (at 8 rows on an H100,
// chip_smoke.py's phase 2: 11264 x 4096 from 0.032 to 0.026 ms, 4096 x 4096
// from 0.0106 to 0.0099; eight k-steps in flight a warp instead, or a
// cluster of blocks splitting K, were slower). out = acc * scale in f32,
// cast to x's dtype. The mma does not care which real k its 16 k slots hold
// as long as A and B agree, so each thread's B registers take the values of
// one weight word and its A registers the x entries of the same k: every
// weight word is loaded once, by one thread, and nothing is shuffled. Nor
// does it care which real columns its 8 n slots are: a thread's four words
// are those of four neighbouring columns (one per 8-column tile), one
// 16-byte load of the row words (K10c bf16, bench_bitcast's w8b_matmul; K2's
// pack_int8_rows): (K/4, N) int32, rows 4r..4r+3 in bytes 0..3 of word r, x
// in its natural order.
//
// byte_stream_kernel (K10a): the unpacked (K, N) int8 weight. Its first form
// was stream_kernel reading the bytes as words, 39% of the byte bound: a
// thread fetched a word as four 4-byte loads N bytes apart and transposed
// them in 16 shift-and-mask steps, every 32-column block read all of x from
// L2 (46 MB at 16 x 4096 x 11264, as much as the weight), and each value
// went through an I2F. This kernel is the slab stream's design on bytes:
//  - a block owns 96 columns of one m-tile of x rows (16; 8 up to 8 rows)
//    over all of K (118 blocks at 11264 columns, one an SM; x read 118
//    times a call, not 352);
//  - the weight's rows stream through a ring of 256-row stages, one TMA box
//    of 96 bytes x 256 rows each (N % 16 == 0: TMA's rows are 16-byte
//    strided; otherwise the twelve consumer warps copy the bytes they read
//    themselves, by cp.async of 4 bytes where N % 4 == 0, else by byte loads),
//    with x's columns at those rows by TMA from its natural (M, K) order in
//    the 128-byte swizzle (f32 x rounds to bf16 as it is read); as many
//    stages as fit (7 at bf16 x, 16 rows), paced by mbarriers, released
//    through release_stage; launched with programmatic dependent launch, its
//    first weight stages load while the kernel before still runs;
//  - the (K, N) layout's transpose happens in shared memory: the product is
//    taken transposed, W^T x^T, on mma.m16n8k16 bf16 (a k-step's slots 2t4,
//    2t4 + 1 are rows kr, kr + 1 of the stage, one 4-byte x load); lane (g,
//    t4) reads 4-byte words (its 4 columns) of rows kr, kr + 1, kr + 8,
//    kr + 9, whose row order within a load keeps the 96-byte rows' banks
//    apart, and a byte permute pairs a column's two rows;
//  - converts without I2F: a pair of int8 values is two LOP3s (the low 7
//    bits, and the sign, each OR-ed into the bf16 128.0) and one bf16 pair
//    subtract (bf16_mma.cuh's s8_pair_bf16x2, exact). The 128.0 is held in
//    a register: with mask and fill both immediates ptxas split each LOP3
//    in two, and the kernel took 0.0236 ms, not 0.0206, at 16 x 4096 x
//    11264 (an H100, 700 W);
//  - folds its 12 warps' f32 tiles in shared memory: out = sum * scale[col]
//    in f32, cast to x's dtype.
//
// slab_stream_kernel (K10b): pack4_int8's words (w8p: word (r, n) holds rows
// r + i*K/4 in byte i) or pack8_int4's (w4p: rows r + i*K/8 in nibble i,
// values in [-8, 7], no bias). Its first form was stream_kernel on these
// words, 27-49% of the byte bound: every 32-column block read all of x from
// L2 (46 MB a layer at 16 x 4096 x 11264, as much as w8p's weight), each
// value went through a shift pair and an I2F (16 a clock an SM: about 11 us
// a layer, more than w4p's whole 6.9 us bound), and the wrapper copied x
// into word order before each call. This kernel:
//  - gives a block 96 columns (3 boxes of 32) of one 16-row m-tile over
//    all of K: 118 blocks at 11264 columns, one an SM, and x is read 118
//    times a layer, not 352;
//  - streams the weight words through a ring of stages (128 word rows of
//    each box, 128-byte swizzle) that warp 0 keeps full with TMA (where
//    N % 4 != 0 the twelve consumer warps copy the words they read
//    themselves, by cp.async of 4 bytes, in blocks of 8 x rows: warp 0
//    alone issuing them was 3.8x slower than stream_kernel on the same
//    words at M 40 x 1030), paced by mbarriers, each stage released
//    through hopper.cuh's release_stage (its ordinary shared-memory reads
//    ordered before the next TMA write); as many stages as fit (3 at w8p,
//    2 at w4p, bf16 x at 16 rows); launched with programmatic dependent
//    launch, its first stages' words go out while the kernel before still
//    runs (a scan of layers: one layer's ramp under the last one's tail);
//  - loads with each stage, by TMA from x's natural (M, K) order, the x
//    values that meet its word rows: for each slab i, columns i*kw + r0 ..
//    + 127 in the 128-byte swizzle (no wrapper copy where a slab's run is a
//    multiple of 16 bytes; f32 x rounds to bf16 as it is read);
//  - takes the product transposed, W^T x^T, on mma.m16n8k16 bf16 (K2's
//    word stream in bf16): a k-step's slot pairs are one slab at two
//    neighbouring word rows, so a B register is one 4-byte load of x and an
//    A register two words' values of one column; the n = 8 slots are x rows
//    (one n-tile up to 8 rows, two up to 16); lane (g, t4) loads 16 bytes
//    (4 columns) of word rows 2t4 and 2t4 + 1 of each 8-row group, whose
//    swizzled places fall in distinct banks;
//  - converts without I2F: int8 pairs by byte permutes under the f32
//    exponent of 2^23 (int8_matmul.cu's s8_pair_bf16 rule, exact), int4 pairs by one LOP3
//    that masks two nibbles, flips their bias (s becomes s + 8) and ORs
//    them into the bf16 128.0, and one bf16 pair subtract of 136 (exact);
//  - folds its 12 warps' f32 tiles in shared memory: out = sum * scale[col]
//    in f32, cast to x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "weight_words.cuh"

namespace {

// A weight format: how its words are laid out and how many bits a value
// takes; value i of a word sign-extends as the TPU kernel's
// (w << (32 - bits*(i+1))) >> (32 - bits).
template <WLayout L, int kBits> struct Format {
  static constexpr WLayout kLayout = L;
  static constexpr int kVals = 32 / kBits;  // values a word; word rows = K / kVals
  static __device__ __forceinline__ int value(uint32_t word, int i) {
    return (int)(word << (32 - kBits * (i + 1))) >> (32 - kBits);
  }
};
using Words = Format<WLayout::kWords, 8>;  // K10c bf16, K2's W8A16 (row words)

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

constexpr int kCols = 32;
constexpr int kUnroll = 4;  // k-steps a warp loads before its products
constexpr int kFill = 2 * 132;  // blocks of 8 warps that fill the card twice over

// The A registers of k-step (r, j): rows g and g + 8 of the m-tile at the
// k of values 4j..4j+3 of word row r (0 for rows past M). The values of word
// row r sit at x[kVals*r .. kVals*r + kVals - 1], so they are one 8-byte
// load a row.
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

// ---------------------------------------------- K10b: the slab-word stream
namespace slab {
constexpr int kBoxCols = wbox::kCols;             // columns a TMA box: 128 bytes a word row
constexpr int kRows = 128;                        // word rows of each box a stage
constexpr int kBoxBytes = kRows * kBoxCols * 4;   // 16 KB
constexpr int kBoxes = 3;                         // boxes a block: 96 columns
constexpr int kWarpsPerBox = 4;                   // consumer warps a box, 32 word rows apiece
constexpr int kConsumers = kWarpsPerBox * kBoxes;
constexpr int kThreads = 32 * (1 + kConsumers);   // warp 0 loads
constexpr int kWBytes = kBoxes * kBoxBytes;       // a stage's words
constexpr int kSmemMax = 227 * 1024;              // a block's shared memory, at most
constexpr int kMaxStages = 8;

// A stage's x: for each slab i, x's columns i * x_slab + r0 .. + kRows - 1
// (the values that meet the stage's word rows r0 ..) of the m-tile's 8 kNT
// rows, as TMA boxes of 128 bytes a row in the 128-byte swizzle (boxes of
// 64 bf16 or 32 f32 columns)
template <int kBits, int kNT, typename XT>
struct StageX {
  static constexpr int kParts = 32 / kBits;
  static constexpr int kBoxCols = 128 / (int)sizeof(XT);   // x columns a box
  static constexpr int kBoxesASlab = kRows / kBoxCols;
  static constexpr int kBoxBytes = 8 * kNT * 128;
  static constexpr int kBytes = kParts * kBoxesASlab * kBoxBytes;
  static constexpr int kStageBytes = kWBytes + kBytes;       // a multiple of 1024
  static_assert(1024 + 2 * kStageBytes + 16 * kMaxStages <= kSmemMax, "a ring of two stages");
};

// x's slab i at the stage's word rows (r, r + 1) of x row g + 8 nt as a
// bf16 pair (f32 x rounded to nearest even): column r of the slab's run
// sits in box r / kBoxCols at its 16-byte chunk XOR-ed by the row (g: rows
// g and g + 8 alike); r is even, so a pair shares a chunk, and the chunks
// of a warp's 8 rows fall in distinct banks (bf16; f32: two lanes a bank)
template <int kBits, int kNT, typename XT>
__device__ __forceinline__ uint32_t x_pair(const uint8_t* xs, int i, int nt, int g, int r) {
  using SX = StageX<kBits, kNT, XT>;
  constexpr int kEl = (int)sizeof(XT), kPerChunk = 16 / kEl;
  const int c = r % SX::kBoxCols;
  const uint8_t* p = xs + (i * SX::kBoxesASlab + r / SX::kBoxCols) * SX::kBoxBytes +
                     (g + 8 * nt) * 128 + (((c / kPerChunk) ^ g) << 4) + (c % kPerChunk) * kEl;
  if constexpr (kEl == 2) return *reinterpret_cast<const uint32_t*>(p);
  const float2 f = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// byte b of two words wr (low half) and wr1 (high half), each a signed
// int8 made u = q + 128 by the bias flip (wx = w ^ 0x80808080), as a bf16
// pair: the byte under the f32 exponent of 2^23 is 2^23 + u, and 2^23 + 128
// less is q exactly; its f32's upper half is q's bf16 (int8_matmul.cu's s8_pair_bf16)
__device__ __forceinline__ uint32_t byte_pair_bf16(uint32_t wr, uint32_t wr1, int b) {
  const float lo = __uint_as_float(__byte_perm(wr, 0x4B000000u, 0x7650 + b)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(wr1, 0x4B000000u, 0x7650 + b)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The products of word rows r, r + 1 (words v, v1: columns 4g .. 4g + 3;
// m-tile 0 takes the first two as its fragment rows g and g + 8, m-tile 1
// the last two) with x rows g, g + 8 of each n-tile (b: their bf16 pairs of
// each slab at rows r, r + 1). A k-step's slots 2t4, 2t4 + 1 hold slab i at
// rows (r, r + 1), slots 2t4 + 8, 2t4 + 9 slab i + 1: two k-steps at int8,
// four at int4.
template <int kBits, int kNT>
__device__ __forceinline__ void word_rows(float (&acc)[2][kNT][4], uint4 v, uint4 v1,
                                          const uint32_t (&b)[kNT][32 / kBits]) {
  const uint32_t w0[4] = {v.x, v.y, v.z, v.w}, w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int c0 = 2 * mt, c1 = 2 * mt + 1;
    if constexpr (kBits == 8) {
      const uint32_t f0 = 0x80808080u;
      const uint32_t a0 = w0[c0] ^ f0, a1 = w1[c0] ^ f0, b0 = w0[c1] ^ f0, b1 = w1[c1] ^ f0;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // slabs (2ks, 2ks + 1)
        const uint32_t a[4] = {byte_pair_bf16(a0, a1, 2 * ks), byte_pair_bf16(b0, b1, 2 * ks),
                               byte_pair_bf16(a0, a1, 2 * ks + 1),
                               byte_pair_bf16(b0, b1, 2 * ks + 1)};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t bb[2] = {b[nt][2 * ks], b[nt][2 * ks + 1]};
          mma_bf16(acc[mt][nt], a, bb);
        }
      }
    } else {
      const uint32_t a0 = w0[c0], a1 = w1[c0], b0 = w0[c1], b1 = w1[c1];
      // nibbles 0-3 (the low half-words side by side), then 4-7 (the high ones)
      const uint32_t t[2][2] = {{__byte_perm(a0, a1, 0x5410), __byte_perm(b0, b1, 0x5410)},
                                {__byte_perm(a0, a1, 0x7632), __byte_perm(b0, b1, 0x7632)}};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // slabs (2ks, 2ks + 1)
        const int h = ks / 2, j = 2 * (ks % 2);
        const uint32_t a[4] = {nibble_pair_bf16(t[h][0], j), nibble_pair_bf16(t[h][1], j),
                               nibble_pair_bf16(t[h][0], j + 1),
                               nibble_pair_bf16(t[h][1], j + 1)};
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t bb[2] = {b[nt][2 * ks], b[nt][2 * ks + 1]};
          mma_bf16(acc[mt][nt], a, bb);
        }
      }
    }
  }
}

// Block (strip, m-tile): weight columns 96 strip.. over all of K, x rows 16
// m-tile... w_map is the (N, K/parts) int32 word map in boxes of 32 columns
// x kRows word rows, 128-byte swizzle, when N % 4 == 0 (w_tma); otherwise
// the consumers copy the words by cp.async into the same layout. x_map is x's
// (M, parts * x_slab) map in StageX's boxes, slab i's values at columns
// i * x_slab ... out = sum * scale in XT, x's dtype.
template <int kBits, int kNT, typename XT>
__global__ void __launch_bounds__(kThreads, 1)
slab_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map, int w_tma,
                   const uint32_t* __restrict__ w, const float* __restrict__ scale,
                   XT* __restrict__ out, int m, int k, int n, int x_slab, int stages) {
  using SX = StageX<kBits, kNT, XT>;
  constexpr int kCols = kBoxes * kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * SX::kStageBytes);
  uint64_t* empty = full + stages;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * 8 * kNT;
  const int kw = k / SX::kParts, tiles = (kw + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the next kernel may start its own first stages while this one runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // the TMA bytes' arrival, and each consumer lane's where the consumers
      // copy the words
      mbar_init(&full[s], w_tma ? 1 : 1 + 32 * kConsumers);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[2][kNT][4] = {};  // 16-column m-tile, 8-row n-tile
  if (warp == 0) {
    // ------------------------------------------------------------ producer
    // tile i into stage i % stages once the consumers have released it: its
    // words (by TMA; where N % 4 != 0 the consumers copy them) and x's
    // values at its word rows. The first stages' words go out at once, while
    // the kernel before may still run (the words and scales are not written
    // by it); x only after griddepcontrol.wait, when that kernel's writes are
    // visible
    auto load_w = [&](int i) {
      const int s = i % stages;
      uint8_t* st = smem + s * SX::kStageBytes;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], (w_tma ? kWBytes : 0) + SX::kBytes);
        if (w_tma) {
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tma_load_2d(st + b * kBoxBytes, &w_map, &full[s], n0 + b * kBoxCols, i * kRows);
        }
      }
    };
    auto load_x = [&](int i) {
      if (lane != 0) return;
      const int s = i % stages;
      uint8_t* xst = smem + s * SX::kStageBytes + kWBytes;
#pragma unroll
      for (int b = 0; b < SX::kParts * SX::kBoxesASlab; ++b)
        tma_load_2d(xst + b * SX::kBoxBytes, &x_map, &full[s],
                    b / SX::kBoxesASlab * x_slab + i * kRows + b % SX::kBoxesASlab * SX::kBoxCols,
                    m0);
    };
    const int pre = min(stages, tiles);
    for (int i = 0; i < pre; ++i) load_w(i);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < pre; ++i) load_x(i);
    for (int i = pre; i < tiles; ++i) {
      if (lane == 0) mbar_wait(&empty[i % stages], ((i / stages) - 1) & 1);
      __syncwarp();
      load_w(i);
      load_x(i);
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Consumer c takes box c % kBoxes, word rows 32 (c / kBoxes) .. of each
    // stage, 8 at a time: lane (g, t4) loads the 16-byte chunk g (columns
    // 4g .. 4g + 3) of word rows 2t4 and 2t4 + 1 (whose swizzled places,
    // XOR-ed by the rows, are 8 distinct chunks in each quarter warp) and
    // the x of those rows.
    const int c = warp - 1, box = c % kBoxes, part = c / kBoxes;
    constexpr int kPartRows = kRows / kWarpsPerBox;
    // Where N % 4 != 0 (no TMA), each consumer copies the words that it
    // alone reads, 4 bytes a cp.async: lane l column l of its box, at each of
    // its kPartRows word rows; all twelve consumers copy at once, and each
    // refills its part of a stage as soon as its own reads of it are done
    auto fill = [&](int i) {
      const int s = i % stages, r0 = i * kRows + kPartRows * part;
      uint32_t* dst = reinterpret_cast<uint32_t*>(smem + s * SX::kStageBytes + box * kBoxBytes);
      const int col = n0 + box * kBoxCols + lane;
      const uint32_t* src = w + (size_t)r0 * n + col;
      for (int r = 0; r < kPartRows; ++r, src += n) {
        const bool in = r0 + r < kw && col < n;
        cp_async4(dst + wbox::swz(kPartRows * part + r, lane), in ? src : w, in ? 4 : 0);
      }
      cp_async_arrive(&full[s]);
    };
    if (!w_tma)
      for (int i = 0; i < min(stages, tiles); ++i) fill(i);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* st = smem + s * SX::kStageBytes;
      const uint32_t* wst = reinterpret_cast<const uint32_t*>(st + box * kBoxBytes);
#pragma unroll
      for (int j = 0; j < kPartRows / 8; ++j) {
        const int r = kPartRows * part + 8 * j + 2 * t4;  // r % 8 == 2 t4
        const uint4 v = *reinterpret_cast<const uint4*>(wst + r * kBoxCols + ((g ^ (2 * t4)) << 2));
        const uint4 v1 = *reinterpret_cast<const uint4*>(wst + (r + 1) * kBoxCols +
                                                         ((g ^ (2 * t4 + 1)) << 2));
        uint32_t b[kNT][SX::kParts];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int si = 0; si < SX::kParts; ++si)
            b[nt][si] = x_pair<kBits, kNT, XT>(st + kWBytes, si, nt, g, r);
        word_rows<kBits, kNT>(acc, v, v1, b);
      }
      release_stage(&empty[s], lane);  // the stage's words and x are in registers
      if (!w_tma && i + stages < tiles) fill(i + stages);  // after release_stage's __syncwarp
    }
  }

  // the consumers' f32 tiles meet in shared memory (the ring is idle: every
  // tile has been consumed) and are summed in warp order; out is written
  // only after the kernel before has finished (griddepcontrol.wait)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  float* fold = reinterpret_cast<float*>(smem);  // [consumer][row][column of its box]
  if (warp > 0) {
    const int c = warp - 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // fragment row g + 8 (e >> 1), column 2t4 + (e & 1)
          fold[(c * 16 + nt * 8 + 2 * t4 + (e & 1)) * kBoxCols + 4 * g + 2 * mt + (e >> 1)] =
              acc[mt][nt][e];
  }
  __syncthreads();
  const int out_rows = min(8 * kNT, m - m0);
  for (int o = threadIdx.x; o < out_rows * kCols; o += kThreads) {
    const int row = o / kCols, cl = o % kCols, b = cl / kBoxCols, col = n0 + cl;
    if (col >= n) continue;
    const float* f = fold + row * kBoxCols + cl % kBoxCols;
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < kWarpsPerBox; ++h) sum += f[(b + kBoxes * h) * 16 * kBoxCols];
    store(out + (size_t)(m0 + row) * n + col, sum * scale[col]);
  }
}

template <int kBits, int kNT, typename XT>
int launch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
           int x_slab, cudaStream_t s) {
  using SX = StageX<kBits, kNT, XT>;
  const int kw = k / SX::kParts;
  CUtensorMap w_map, x_map;
  // TMA rows must be 16-byte strided: the weight's when N % 4 == 0
  const int w_tma = (n % 4) == 0 && kw > 0;
  if (w_tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)kw};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {kBoxCols, kRows};
    if (!encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  } else {
    memset(&w_map, 0, sizeof(w_map));  // unused
  }
  {  // TMA box starts must be 16-byte aligned: x_slab * sizeof(XT) % 16 == 0
    const int cols = max(SX::kParts * x_slab, 16 / (int)sizeof(XT));
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(XT)};
    const cuuint32_t box[2] = {SX::kBoxCols, 8 * kNT};
    if (!encode_map(&x_map,
                    sizeof(XT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = slab_stream_kernel<kBits, kNT, XT>;
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // as many stages as fit, up to kMaxStages
  const int stages = min(kMaxStages, (kSmemMax - 1024 - 16 * kMaxStages) / SX::kStageBytes);
  const int smem = 1024 + stages * SX::kStageBytes + 16 * stages;
  const dim3 grid((n + kBoxes * kBoxCols - 1) / (kBoxes * kBoxCols), (m + 8 * kNT - 1) / (8 * kNT));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute pdl;  // programmatic dependent launch (see the producer)
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, w_map, x_map, w_tma,
                                 static_cast<const uint32_t*>(w),
                                 static_cast<const float*>(scale), static_cast<XT*>(out), m, k,
                                 n, x_slab, stages);
}

template <int kBits, typename XT>
int dispatch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
             int x_slab, cudaStream_t s) {
  if (x_slab < k / (32 / kBits) || x_slab * (int)sizeof(XT) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // 8-row m-tiles up to 8 rows, and where the words come by cp.async (N % 4
  // != 0): twice the blocks, each with half the x, stream such a weight faster
  // (M 40 x 1030 f32 x: 55 blocks of 3 stages, not 33 of 2)
  return m <= 8 || n % 4 != 0 ? launch<kBits, 1, XT>(x, w, scale, out, m, k, n, x_slab, s)
                              : launch<kBits, 2, XT>(x, w, scale, out, m, k, n, x_slab, s);
}
}  // namespace slab

// --------------------------------------------- K10a: the byte-weight stream
namespace bytew {
constexpr int kCols = 96;                      // weight columns a block: one TMA box, 96 bytes a row
constexpr int kRows = 256;                     // k rows a stage (TMA's longest box)
constexpr int kWBytes = kRows * kCols;         // 24 KB
constexpr int kGroups = kCols / 32;            // 32-column groups, one consumer warp's width
constexpr int kParts = 4;                      // consumer warps a group
constexpr int kPartRows = kRows / kParts;      // k rows of a stage a consumer: 4 k-steps
constexpr int kConsumers = kGroups * kParts;
constexpr int kThreads = 32 * (1 + kConsumers);  // warp 0 loads
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxStages = 8;

// A stage's x: columns k0 .. k0 + kRows - 1 (the stage's k rows) of the
// m-tile's 8 kNT rows, as TMA boxes of 128 bytes a row in the 128-byte
// swizzle (64 bf16 or 32 f32 columns a box)
template <int kNT, typename XT>
struct StageX {
  static constexpr int kBoxCols = 128 / (int)sizeof(XT);
  static constexpr int kBoxes = kRows / kBoxCols;
  static constexpr int kBoxBytes = 8 * kNT * 128;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = kWBytes + kBytes;  // a multiple of 1024
  static_assert(1024 + 2 * kStageBytes + 16 * kMaxStages <= kSmemMax, "a ring of two stages");
};

// x row g + 8 nt at the stage's k rows (k, k + 1), k even, as a bf16 pair
// (f32 x rounded to nearest even): column c of box k / kBoxCols sits at its
// 16-byte chunk XOR-ed by the row (g), so the chunks of a warp's 8 rows fall
// in distinct banks (bf16; f32: two lanes a bank)
template <int kNT, typename XT>
__device__ __forceinline__ uint32_t x_pair(const uint8_t* xs, int nt, int g, int k) {
  using SX = StageX<kNT, XT>;
  constexpr int kEl = (int)sizeof(XT), kPerChunk = 16 / kEl;
  const int c = k % SX::kBoxCols;
  const uint8_t* p = xs + (k / SX::kBoxCols) * SX::kBoxBytes + (g + 8 * nt) * 128 +
                     (((c / kPerChunk) ^ g) << 4) + (c % kPerChunk) * kEl;
  if constexpr (kEl == 2) return *reinterpret_cast<const uint32_t*>(p);
  const float2 f = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Block (strip, m-tile): weight columns 96 strip.. over all of K, x rows 16
// m-tile... kTma: w_map is the (K, N) byte weight's map in boxes of 96
// columns x kRows rows (N % 16 == 0: TMA's rows are 16-byte strided);
// otherwise the consumers copy the bytes into the same layout. x_map is x's
// (M, K) map in StageX's boxes. out = sum * scale in XT, x's dtype.
template <int kNT, typename XT, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
byte_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, XT* __restrict__ out, int m, int k, int n,
                   int stages) {
  using SX = StageX<kNT, XT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * SX::kStageBytes);
  uint64_t* empty = full + stages;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * 16;
  const int tiles = (k + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the next kernel may start its own first stages while this one runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // the TMA bytes' arrival, and each consumer lane's where the consumers
      // copy the weight
      mbar_init(&full[s], kTma ? 1 : 1 + 32 * kConsumers);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[2][kNT][4] = {};  // 16-column m-tile, 8-row n-tile
  if (warp == 0) {
    // ------------------------------------------------------------ producer
    // tile i into stage i % stages once the consumers have released it: its
    // weight rows (by TMA) and x's columns at those rows. The first stages'
    // weight goes out at once, while the kernel before may still run (the
    // weight and scales are not written by it); x only after
    // griddepcontrol.wait, when that kernel's writes are visible
    if (lane == 0) {
      auto load_w = [&](int i) {
        const int s = i % stages;
        mbar_arrive_expect_tx(&full[s], (kTma ? kWBytes : 0) + SX::kBytes);
        if constexpr (kTma)
          tma_load_2d(smem + s * SX::kStageBytes, &w_map, &full[s], n0, i * kRows);
      };
      auto load_x = [&](int i) {
        const int s = i % stages;
        uint8_t* xst = smem + s * SX::kStageBytes + kWBytes;
#pragma unroll
        for (int b = 0; b < SX::kBoxes; ++b)
          tma_load_2d(xst + b * SX::kBoxBytes, &x_map, &full[s], i * kRows + b * SX::kBoxCols,
                      m0);
      };
      const int pre = min(stages, tiles);
      for (int i = 0; i < pre; ++i) load_w(i);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < pre; ++i) load_x(i);
      for (int i = pre; i < tiles; ++i) {
        mbar_wait(&empty[i % stages], ((i / stages) - 1) & 1);
        load_w(i);
        load_x(i);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Consumer c takes group c % kGroups (bytes 32 grp .. + 31 of each stage
    // row) and k rows kPartRows (c / kGroups) .. of each stage, 16 at a
    // time. Lane (g, t4) reads its 4 columns 4g .. 4g + 3 of rows kr, kr + 1,
    // kr + 8, kr + 9 (kr = 2 t4 of each 16) as 4-byte words; a row pair's two
    // loads take rows (kr + f, kr + 1 - f), f = (t4 ^ (t4 >> 1)) & 1, so each
    // load's four rows are {0, 3, 5, 6} or {1, 2, 4, 7} mod 8: four distinct
    // 32-byte bank groups at the 96-byte pitch. The byte permute sel puts
    // row kr's byte in the low half of each pair whichever load it came in.
    const int c = warp - 1, grp = c % kGroups, part = c / kGroups;
    const int col = 32 * grp + 4 * g;
    const int f = (t4 ^ (t4 >> 1)) & 1;
    const uint32_t sel = f ? 0x0004u : 0x0400u;  // byte 0 of (row kr, row kr + 1)
    const uint32_t bf128 = 0x43004300u;  // the bf16 pair (128, 128)
    // Where N % 16 != 0 (no TMA), each consumer copies the bytes that it
    // alone reads: lane l the 4-byte word l % 8 of its group at rows l / 8,
    // + 4, .. of its kPartRows, by cp.async where N % 4 == 0 (the words
    // aligned), else by byte loads; all twelve consumers copy at once, and
    // each refills its part of a stage as soon as its own reads of it are done
    auto fill = [&](int i) {
      const int s = i % stages;
      uint8_t* st = smem + s * SX::kStageBytes;
      const int wc = 4 * (lane % 8), c0 = n0 + 32 * grp + wc;
#pragma unroll 4
      for (int q = 0; q < kPartRows / 4; ++q) {
        const int r = kPartRows * part + lane / 8 + 4 * q, kr = i * kRows + r;
        uint8_t* dst = st + r * kCols + 32 * grp + wc;
        const uint8_t* src = w + (size_t)kr * n + c0;
        if (n % 4 == 0) {
          const bool in = kr < k && c0 < n;
          cp_async4(dst, in ? src : w, in ? 4 : 0);
        } else {
          uint32_t v = 0;
#pragma unroll
          for (int jb = 0; jb < 4; ++jb)
            if (kr < k && c0 + jb < n) v |= (uint32_t)src[jb] << (8 * jb);
          *reinterpret_cast<uint32_t*>(dst) = v;
        }
      }
      __syncwarp();  // the byte loads' stores, before the other lanes read them
      cp_async_arrive(&full[s]);
    };
    if constexpr (!kTma)
      for (int i = 0; i < min(stages, tiles); ++i) fill(i);
    for (int i = 0; i < tiles; ++i) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const uint8_t* st = smem + s * SX::kStageBytes;
      const uint8_t* xs = st + kWBytes;
#pragma unroll
      for (int j = 0; j < kPartRows / 16; ++j) {
        const int kr = kPartRows * part + 16 * j + 2 * t4;
        const uint8_t* p = st + kr * kCols + col;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p + f * kCols);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + (1 - f) * kCols);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(p + (8 + f) * kCols);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(p + (9 - f) * kCols);
        uint32_t b[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          b[nt][0] = x_pair<kNT, XT>(xs, nt, g, kr);
          b[nt][1] = x_pair<kNT, XT>(xs, nt, g, kr + 8);
        }
        // m-tile mt: fragment rows g and g + 8 are columns 4g + 2mt and
        // 4g + 2mt + 1 (bytes 2mt, 2mt + 1); slots 2t4, 2t4 + 1 rows kr, kr + 1,
        // slots 2t4 + 8, 2t4 + 9 rows kr + 8, kr + 9, as b's x
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t s0 = sel + 0x0202u * mt, s1 = s0 + 0x0101u;
          const uint32_t a[4] = {s8_pair_bf16x2(__byte_perm(w0, w1, s0), bf128),
                                 s8_pair_bf16x2(__byte_perm(w0, w1, s1), bf128),
                                 s8_pair_bf16x2(__byte_perm(w8, w9, s0), bf128),
                                 s8_pair_bf16x2(__byte_perm(w8, w9, s1), bf128)};
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
        }
      }
      release_stage(&empty[s], lane);  // the stage's bytes and x are in registers
      if constexpr (!kTma)
        if (i + stages < tiles) fill(i + stages);  // after release_stage's __syncwarp
    }
  }

  // the consumers' f32 tiles meet in shared memory (the ring is idle: every
  // tile has been consumed) and are summed in warp order; out is written
  // only after the kernel before has finished (griddepcontrol.wait)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  // [consumer][row][column of its group], the column XOR-ed by (row / 2) % 4:
  // a store's 32 lanes (rows 2t4, columns 4g) then fall in distinct banks
  float* fold = reinterpret_cast<float*>(smem);
  if (warp > 0) {
    const int c = warp - 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // fragment row g + 8 (e >> 1), column 2t4 + (e & 1)
          fold[(c * 16 + nt * 8 + 2 * t4 + (e & 1)) * 32 + ((4 * g + 2 * mt + (e >> 1)) ^ t4)] =
              acc[mt][nt][e];
  }
  __syncthreads();
  const int out_rows = min(16, m - m0);
  for (int o = threadIdx.x; o < out_rows * kCols; o += kThreads) {
    const int row = o / kCols, cl = o % kCols, col = n0 + cl;
    if (col >= n) continue;
    const float* fp = fold + row * 32 + ((cl % 32) ^ ((row >> 1) & 3));
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < kParts; ++h) sum += fp[(cl / 32 + kGroups * h) * 16 * 32];
    store(out + (size_t)(m0 + row) * n + col, sum * scale[col]);
  }
}

template <int kNT, typename XT, bool kTma>
int launch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
           cudaStream_t s) {
  using SX = StageX<kNT, XT>;
  CUtensorMap w_map, x_map;
  if constexpr (kTma) {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
    const cuuint64_t strides[1] = {(cuuint64_t)n};
    const cuuint32_t box[2] = {kCols, kRows};
    if (!encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  } else {
    memset(&w_map, 0, sizeof(w_map));  // unused
  }
  if (k > 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(XT)};
    const cuuint32_t box[2] = {SX::kBoxCols, 8 * kNT};
    if (!encode_map(&x_map,
                    sizeof(XT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    2, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  } else {
    memset(&x_map, 0, sizeof(x_map));  // no tiles: out = 0
  }
  auto kernel = byte_stream_kernel<kNT, XT, kTma>;
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // as many stages as fit, up to kMaxStages
  const int stages = min(kMaxStages, (kSmemMax - 1024 - 16 * kMaxStages) / SX::kStageBytes);
  const int smem = 1024 + stages * SX::kStageBytes + 16 * stages;
  const dim3 grid((n + kCols - 1) / kCols, (m + 15) / 16);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute pdl;  // programmatic dependent launch (see the producer)
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, w_map, x_map, static_cast<const uint8_t*>(w),
                                 static_cast<const float*>(scale), static_cast<XT*>(out), m, k,
                                 n, stages);
}

template <typename XT>
int dispatch(const void* x, const void* w, const void* scale, void* out, int m, int k, int n,
             cudaStream_t s) {
  const bool tma = n % 16 == 0 && k > 0;  // TMA's rows are 16-byte strided
  if (m <= 8)
    return tma ? launch<1, XT, true>(x, w, scale, out, m, k, n, s)
               : launch<1, XT, false>(x, w, scale, out, m, k, n, s);
  return tma ? launch<2, XT, true>(x, w, scale, out, m, k, n, s)
             : launch<2, XT, false>(x, w, scale, out, m, k, n, s);
}
}  // namespace bytew

}  // namespace

// K10a: x (M, K) bf16 (x_bf16 = 1) or f32; w (K, N) int8 row-major; scale
// (N,) f32; out (M, N) in x's dtype. K must be a multiple of 16.
extern "C" int mmor_w8a16_bytes(const void* x, const void* w, const void* scale, void* out,
                                int m, int k, int n, int x_bf16, void* stream) {
  if (m < 1 || n < 1 || k < 0 || k % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? bytew::dispatch<__nv_bfloat16>(x, w, scale, out, m, k, n, s)
                : bytew::dispatch<float>(x, w, scale, out, m, k, n, s);
}

// K10c's bf16 mode and K2's W8A16 branch at up to 16 rows: x (M, K) bf16;
// w (K/4, N) int32 row words (pack_int8_rows: rows 4r..4r+3 in bytes 0..3
// of word r); scale (N,) f32; out as above. K must be a multiple of 16.
extern "C" int mmor_wp_matmul(const void* x, const void* w, const void* scale, void* out,
                              int m, int k, int n, int out_bf16, void* stream) {
  return launch<Words>(x, w, scale, out, m, k, n, out_bf16, stream);
}

// K10b: x (M, parts * x_slab) bf16 (x_bf16 = 1) or f32, slab i's values
// (x's columns i*K/parts .. in its natural (M, K) order) at columns i *
// x_slab ..: x itself where x_slab = K/parts is a multiple of 8 (bf16) or 4
// (f32), else its slabs padded to such an x_slab (TMA's boxes start 16-byte
// aligned); w (K/parts, N) int32 slab words (bits 8: parts 4, pack4_int8;
// bits 4: parts 8, pack8_int4); scale (N,) f32; out (M, N) in x's dtype.
// K must be a multiple of 4 * parts (16 at int8, 32 at int4).
extern "C" int mmor_slab_matmul(const void* x, const void* w, const void* scale, void* out,
                                int m, int k, int n, int x_slab, int bits, int x_bf16,
                                void* stream) {
  const int parts = bits == 8 ? 4 : bits == 4 ? 8 : 0;
  if (parts == 0 || m < 1 || n < 1 || k < 0 || k % (4 * parts) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return x_bf16 ? slab::dispatch<8, __nv_bfloat16>(x, w, scale, out, m, k, n, x_slab, s)
                  : slab::dispatch<8, float>(x, w, scale, out, m, k, n, x_slab, s);
  return x_bf16 ? slab::dispatch<4, __nv_bfloat16>(x, w, scale, out, m, k, n, x_slab, s)
                : slab::dispatch<4, float>(x, w, scale, out, m, k, n, x_slab, s);
}
