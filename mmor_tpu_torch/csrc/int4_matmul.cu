// K3: packed int4 weight matmul, x @ (unpack4(w_p) * scale), as W4A8
// (int8_mxu) or W4A16.
//
// Replaces mmor_tpu/ops/quantized_matmul.py::int4_matmul_packed
// (_packed4_kernel, the pl.pallas_call at :441), both of its branches.
//
// What bounds it on the H100: at decode rows (M = batch) every weight byte
// is read once for 32 multiply-adds, so the product is bound by
// device-memory bandwidth on the half-size int4 weights; at prefill (M = 8
// x 708) it is bound by the tensor cores' rate: int8 for W4A8, bf16 (half
// of it) for W4A16.
//
// The JAX weight layout stays as it is (pack_int4_rows with block = group:
// byte b of word r holds rows 4r+b and group/2+4r+b of a group as biased
// nibbles u = q + 8). Masking a word with 0x0F0F0F0F, or shifting it by 4
// first, gives a pack_int8_rows word of the group's first or second half;
// removing the bias byte by byte (nibbles_s8 here, __vsub4 in w4a8.cuh)
// makes a word exactly the s8 A register of the products below. For bf16,
// a nibble u OR-ed into the bf16 128.0 (0x4300, whose 7 mantissa bits
// count units) is 128 + u, and 136 less is q, exactly; two such values are
// one bf16x2 register.
//
// Two deliberate differences from the TPU branches, which fold the bias as
// (dot(x, u) - 8 rowsum(x)) * scale in f32 (quantized_matmul.py:359-361):
// here the bias is removed exactly, byte by byte, before the product, so
// no large terms cancel; and W4A16 does not quantize x (the TPU's W4A16
// rounds x to bf16, as this kernel does, and takes no row scale either).
//
//  - W4A8: the activation rows are quantized first (act_quant.cuh, the
//    plain version's arithmetic); each K-group's dot is an exact s32 sum,
//    folded in group order, acc = acc + float(dot) * scale[group, col]
//    (__fmul_rn, __fadd_rn, never contracted), and acc * row_scale last:
//    bit for bit int4_matmul_packed_plain(int8_mxu=True).
//  - W4A16: x in bf16 (f32 x is rounded to bf16 by a pre-pass kernel,
//    act_quant.cuh's to_bf16_kernel, into the wrapper's scratch, so the
//    product kernels read bf16 only); exact bf16 products summed in f32 on
//    the tensor cores, each K-group's sum taken at its scale in group
//    order. At up to 16 rows the fold is acc = acc + dot * scale[group,
//    col]; above, it is rescaled (below). The plain version is the JAX CPU
//    path (f32 dequantization, then x @ w), so the two differ by the sums'
//    order and, for f32 x, by x's rounding.
//
// Kernels:
//  - M <= 16 (decode rows): W4A8 is w4a8.cuh's skinny kernel. W4A16 is
//    a16_skinny_kernel: a block of eight warps owns 32 columns and one
//    16-row tile; per K-group its warps split the word rows, four a k-step
//    (one a thread quad lane), and each word feeds two mma.sync.m16n8k16
//    bf16 steps (its low nibbles against the x of the group's first half,
//    its high nibbles against the second), the mma's k slots taking the
//    word's four k in the order its B registers hold them; the warps'
//    partial dots meet in shared memory, are summed in warp order and
//    folded in group order.
//  - M > 16 (prefill), both branches: each output tile is computed
//    transposed, W^T (columns x K) times x^T (K x rows): the weight words,
//    converted in registers, are the A fragments (a fragment row is a
//    weight column), and the activation rows are the K-major B operand in
//    shared memory. A block is two consumer warpgroups fed by a ring that
//    warp 0 keeps filled with TMA, paced by full and empty mbarriers, the
//    words in 32-column boxes in the 128-byte swizzle (wbox in hopper.cuh;
//    where N % 4 != 0, which TMA's 16-byte row strides cannot describe,
//    warp 0 copies them by cp.async), and blocks walk the output in groups
//    of 8 row tiles, so that a wave's activation rows and weight columns
//    stay in L2. The epilogue stages the tile through shared memory so
//    that the (M, N) stores are row-major and coalesced.
//    * W4A8, w4a8_wgmma_kernel: each warpgroup 64 weight columns by 128
//      activation rows (m64n128k32 s8); a stage is 32 word rows of 128
//      columns and the two activation boxes that pair with them, the
//      group's first half at g0 + 4 r0 and its second at g0 + group/2 +
//      4 r0, 128 rows x 128 bytes each: a word register is loaded once and
//      feeds the products of both halves. A group's partial dot (s32) and
//      the running f32 sum are two accumulator sets; at a group's last
//      stage the warpgroup waits for its products and folds the partial.
//      ptxas reports its wgmma serialized (C7520: the fold's wait sits
//      under a runtime condition), as it did before the W4A16 branch left
//      this kernel; it is timed as it was (3.63-3.70 ms at M 5664).
//    * W4A16, a16_wgmma_kernel: each warpgroup 64 weight columns by 256
//      activation rows, one m64n256k16 bf16 product a 16-k step into one
//      f32 accumulator set (128 registers a thread; a second set for the
//      group fold would not fit). Stage i is half i % 2 of word-row tile
//      i / 2: the tile's 16 word rows (8 KB) and the 256 x 64 activations
//      of that half (32 KB, 128 bytes a row), 5 stages of 40 KB, K2's
//      W8A16 sizing; a word's low nibbles feed the first half's stage, its
//      high nibbles the second's, each converted to bf16 pairs in
//      registers (nibbles_bf16).
//      The fold without a second accumulator set: acc counts in units of
//      its column's scale so far, the last nonzero one (1 before any).
//      Entering a group of scale s, the warpgroup waits for its products
//      and multiplies acc by unit / s (one multiply a register: the scale
//      is per weight column, a fragment row), and s becomes the unit; the
//      epilogue multiplies by the unit. A zero scale (quantize_weights_int4
//      never writes one; a converted checkpoint could) leaves acc and the
//      unit as they are, and its group's values convert as exact zeros
//      (the conversion's mask and fill registers, no extra instruction), so
//      nothing divides by it. The wait is in the group loop's body, not
//      under a runtime condition, so ptxas keeps the wgmma asynchronous.
//      What was built and timed against it (development builds, the four
//      7B projections at M 5664, NVIDIA H100 80GB HBM3 at 700 W; each pair
//      in one process): the other fold, the group's partial in registers
//      and the running sum in shared memory (128 KB a block, so a ring of
//      two 40 KB stages: three do not fit), 7.35 ms against 6.03 for this
//      fold built from the same source (5.63 in its final form); the tile's words
//      loaded once for both halves (a ring of 3 word tiles beside 5
//      activation stages, 10% fewer bytes a stage), 6.07 ms against 5.56;
//      each group's low halves, then its high halves (the activation boxes
//      in k order), 7.15 against 6.11; the zero scales as a warp-uniform
//      branch around a select instead of the mask and fill, 6.11 against
//      5.60. Leaving out the group waits (timing only, wrong sums) took
//      5.64 against 6.08: the waits cost about 7%. At 1.9-2.1x
//      torch.matmul it stays slower than K2's W8A16 kernel (1.5x) on the
//      same stage sizes; what holds it back beyond the waits is not
//      isolated (no ncu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "w4a8.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the biased nibbles of bytes (0, 1) (sel 0x4140) or (2, 3) (sel 0x4342) of
// w as the bf16 pair (q0, q1), the lower byte in the low half: u OR-ed into
// the bf16 128.0 is 128 + u, 136 less is q. With mask 0 and fill 0x43084308
// (136, 136) instead, the pair is (0, 0) whatever w holds: one LOP3 either way.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w, uint32_t sel,
                                                 uint32_t mask = 0x000F000Fu,
                                                 uint32_t fill = 0x43004300u) {
  uint32_t v = (__byte_perm(w, 0u, sel) & mask) | fill;
  const __nv_bfloat162 q =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&q);
}
constexpr uint32_t kNibbleMask = 0x000F000Fu, kNibbleFill = 0x43004300u, kZeroFill = 0x43084308u;
constexpr uint32_t kBytes01 = 0x4140u, kBytes23 = 0x4342u;

// the biased nibbles u of w's low (or, shifted first, high) halves as s8
// bytes q = u - 8: u + 0x78 stays below 0x88, so no byte carries into the
// next, and flipping bit 7 leaves 0x78 + u - 0x80 = u - 8 in two's
// complement (the same bytes as w4a8.cuh's __vsub4, in fewer instructions)
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t w) {
  return ((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// ------------------------------------------------------- W4A16, M <= 16
constexpr int kSkWarps = 8, kSkCols = 32;

template <typename OutT>
__global__ void __launch_bounds__(kSkWarps * 32)
a16_skinny_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ w,
                  const float* __restrict__ scale, OutT* __restrict__ out, int m, int k, int n,
                  int group) {
  __shared__ float red[kSkWarps][16][kSkCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kSkCols, m0 = blockIdx.y * 16;
  const int col0 = n0 + 4 * g;  // lane group g: columns col0..col0+3, one an n-tile
  const bool wide = (n % 4) == 0 && col0 + 3 < n;
  const bool row_a = m0 + g < m, row_b = m0 + g + 8 < m;
  const bf16* xa = x + (size_t)(m0 + g) * k;
  const bf16* xb = x + (size_t)(m0 + g + 8) * k;
  const int gw = group / 8, steps = gw / 4;  // word rows and k-steps a group
  float total[2] = {0.f, 0.f};  // outputs threadIdx.x and threadIdx.x + 256 of the tile

  for (int grp = 0; grp < k / group; ++grp) {
    float acc[4][4] = {};
#pragma unroll 4
    for (int s = warp; s < steps; s += kSkWarps) {
      const int r = grp * gw + 4 * s + t4;           // word row
      const int klo = grp * group + 4 * (4 * s + t4);  // its k in the first half
      const int khi = klo + group / 2;
      uint4 wv;
      if (wide) {
        wv = *reinterpret_cast<const uint4*>(w + (size_t)r * n + col0);
      } else {
        const uint32_t* wr = w + (size_t)r * n;
        wv.x = col0 < n ? wr[col0] : 0u;
        wv.y = col0 + 1 < n ? wr[col0 + 1] : 0u;
        wv.z = col0 + 2 < n ? wr[col0 + 2] : 0u;
        wv.w = col0 + 3 < n ? wr[col0 + 3] : 0u;
      }
      const uint2 z = make_uint2(0u, 0u);
      const uint2 la = row_a ? *reinterpret_cast<const uint2*>(xa + klo) : z;
      const uint2 lb = row_b ? *reinterpret_cast<const uint2*>(xb + klo) : z;
      const uint2 ha = row_a ? *reinterpret_cast<const uint2*>(xa + khi) : z;
      const uint2 hb = row_b ? *reinterpret_cast<const uint2*>(xb + khi) : z;
      const uint32_t alo[4] = {la.x, lb.x, la.y, lb.y}, ahi[4] = {ha.x, hb.x, ha.y, hb.y};
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t bl[2] = {nibbles_bf16(words[nt], kBytes01),
                                nibbles_bf16(words[nt], kBytes23)};
        const uint32_t bh[2] = {nibbles_bf16(words[nt] >> 4, kBytes01),
                                nibbles_bf16(words[nt] >> 4, kBytes23)};
        mma_bf16(acc[nt], alo, bl);
        mma_bf16(acc[nt], ahi, bh);
      }
    }
    // mma column c of n-tile nt is column col0 - 4g + 4c + nt of the block
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][g + (e >> 1) * 8][4 * (t4 * 2 + (e & 1)) + nt] = acc[nt][e];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * kSkWarps * 32, col = n0 + i % kSkCols;
      float dot = 0.f;
      for (int wi = 0; wi < kSkWarps; ++wi) dot = __fadd_rn(dot, red[wi][i / kSkCols][i % kSkCols]);
      if (col < n)
        total[j] = __fadd_rn(total[j], __fmul_rn(dot, scale[(size_t)grp * n + col]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * kSkWarps * 32;
    const int row = m0 + i / kSkCols, col = n0 + i % kSkCols;
    if (row < m && col < n) out[(size_t)row * n + col] = from_float<OutT>(total[j]);
  }
}

// -------------------------------------------------- both branches, M > 16
// the origin of output tile `id` (kRowsT activation rows x kColsT weight
// columns): row tiles in groups of kRaster, the columns walked within a
// group, so that a wave of tiles shares rows and columns in L2
constexpr int kRaster = 8;  // row tiles a raster group
template <int kRowsT, int kColsT>
__device__ __forceinline__ void tile_origin(int id, int n_ct, int n_rt, int& m0, int& n0) {
  const int per = kRaster * n_ct, first = (id / per) * kRaster;
  const int rows = min(n_rt - first, kRaster), pos = id % per;
  m0 = (first + pos % rows) * kRowsT;
  n0 = (pos / rows) * kColsT;
}
using wbox::swz;

// The ring's barriers: full[s] takes the TMA bytes' arrival, and each
// lane's cp.asyncs where warp 0 copies the words; empty[s] one arrival a
// consumer warp
template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int w_tma) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], w_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// warp 0's copy of word rows wr0.. (kWordRows of them) x kCols columns n0..
// where TMA cannot take the weight (N % 4 != 0): 4 bytes a cp.async, into
// the 32-column boxes' swizzled layout, zeros past N
template <int kWordRows, int kCols>
__device__ __forceinline__ void copy_words(uint8_t* ws, const uint32_t* w, int wr0, int n0,
                                           int n, int lane) {
  constexpr int kBox = wbox::kCols, kBoxBytes = kWordRows * kBox * 4;
  for (int c = lane; c < kWordRows * kCols; c += 32) {
    const int r = c / kCols, col = c % kCols;
    const bool in = n0 + col < n;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ws + (col / kBox) * kBoxBytes) + swz(r, col % kBox);
    cp_async4(dst, in ? w + (size_t)(wr0 + r) * n + n0 + col : w, in ? 4 : 0);
  }
}

// rows of kCols + 16 bytes' worth of elements: the epilogue's row-major
// tile in shared memory, its rows 16-byte aligned
template <typename OutT, int kCols>
constexpr int kTileStride = kCols + 16 / (int)sizeof(OutT);

// the block's output tile (kRows x kCols at m0, n0, staged row-major in
// `tile`) to out, 16 bytes a store where N allows
template <typename OutT, int kRows, int kCols, int kThreads>
__device__ __forceinline__ void store_tile(const OutT* tile, OutT* out, int m0, int n0, int m,
                                           int n) {
  constexpr int kStride = kTileStride<OutT, kCols>;
  constexpr int kVec = 16 / (int)sizeof(OutT);  // elements a 16-byte store
  constexpr int kChunks = kCols / kVec;
  const bool vec = (n % kVec) == 0;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int rl = c / kChunks, cl = (c % kChunks) * kVec;
    const int row = m0 + rl, col = n0 + cl;
    if (row >= m || col >= n) continue;
    const OutT* src = tile + rl * kStride + cl;
    OutT* dst = out + (size_t)row * n + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVec && col + e < n; ++e) dst[e] = src[e];
    }
  }
}

// ----------------------------------------------------------- W4A8, M > 16
namespace wg {
constexpr int kCols = 128;   // weight columns a block, 64 a consumer warpgroup
constexpr int kRows = 128;   // activation rows a block: the wgmma's N
constexpr int kBox = wbox::kCols;
constexpr int kThreads = 256;  // two consumer warpgroups; warp 0 also loads
constexpr int kWordRows = 32;                 // word rows a stage
constexpr int kHalfK = 4 * kWordRows;         // k of each half a stage: 128 bytes of a row
constexpr int kSteps = 4;                     // m64n128k32 s8 steps a half
constexpr int kXHalfBytes = kRows * 128;      // one activation box
constexpr int kBoxBytes = kWordRows * kBox * 4;
constexpr int kWBytes = kCols / kBox * kBoxBytes;
constexpr int kStageBytes = 2 * kXHalfBytes + kWBytes;  // 48 KB
constexpr int kStages = 4;
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kRows * (kCols + 4) * 4 <= kStages * kStageBytes, "epilogue tile");
}  // namespace wg

// x_map: the quantized activation rows xq, boxes of 128 rows x 128 bytes in
// the 128-byte swizzle; w_map: the weight's (N, K/8) int32 map, boxes of 32
// columns x kWordRows word rows in the 128-byte swizzle, when N % 4 == 0
// (w_tma); otherwise warp 0 copies the words, 4 bytes a cp.async. rs: the
// row scales.
template <typename OutT>
__global__ void __launch_bounds__(wg::kThreads, 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, int w_tma,
                  const uint32_t* __restrict__ w, const float* __restrict__ scale,
                  const float* __restrict__ rs, OutT* __restrict__ out, int m, int k, int n,
                  int group) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the 128-byte swizzle; offset from the __shared__ array
  // so that accesses compile to shared-memory loads, not generic ones
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  int m0, n0;
  tile_origin<kRows, kCols>(blockIdx.x, (n + kCols - 1) / kCols, (m + kRows - 1) / kRows, m0,
                            n0);
  const int tiles = k / 8 / kWordRows, per_group = group / 8 / kWordRows;
  const int lane = threadIdx.x % 32;
  init_ring<kStages>(full, empty, w_tma);

  // Warp 0 loads k-tile t into stage t % kStages, once every warp has
  // released the tile that stage held (kStages tiles before).
  auto produce = [&](int t) {
    const int s = t % kStages;
    if (lane == 0 && t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
    __syncwarp();
    uint8_t* st = smem + s * kStageBytes;
    uint8_t* ws = st + 2 * kXHalfBytes;
    const int k_lo = (t / per_group) * group + (t % per_group) * kHalfK;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * kXHalfBytes + (w_tma ? kWBytes : 0));
      tma_load_2d(st, &x_map, &full[s], k_lo, m0);
      tma_load_2d(st + kXHalfBytes, &x_map, &full[s], k_lo + group / 2, m0);
      if (w_tma) {
#pragma unroll
        for (int b = 0; b < kCols / kBox; ++b)
          tma_load_2d(ws + b * kBoxBytes, &w_map, &full[s], n0 + b * kBox, t * kWordRows);
      }
    }
    if (!w_tma) {
      copy_words<kWordRows, kCols>(ws, w, t * kWordRows, n0, n, lane);
      cp_async_arrive(&full[s]);
    }
  };
  const bool loader = threadIdx.x < 32;
  if (loader)
    for (int t = 0; t < kStages - 1 && t < tiles; ++t) produce(t);

  // ------------------------------------------------------------- consumers
  const int cw = threadIdx.x / 128;  // consumer warpgroup: weight columns 64cw..
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int box = cw * 2 + (warp >> 1);  // this warp's 32-column box
  int cls[2];  // this thread's two columns in the block (fragment rows g and g + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) cls[h] = cw * 64 + (warp >> 1) * 32 + wbox::col(warp, g + 8 * h);
  const int c_lo = cls[0] % kBox, c_hi = cls[1] % kBox;
  int acc[64];  // the group's partial dot
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  float sc[2] = {0.f, 0.f};  // the current group's scales of this thread's columns

  // The A fragments of k-tile t, once its stage has landed: a[step][half][4];
  // k32 step ks: word rows 8ks + t4 and + 4 (k 4t4.. and 16 + 4t4..).
  auto load_a = [&](uint32_t (&a)[kSteps][2][4], int t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(smem + s * kStageBytes +
                                                           2 * kXHalfBytes + box * kBoxBytes);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int r0 = ks * 8 + t4, r1 = r0 + 4;
      const uint32_t words[4] = {wb[swz(r0, c_lo)], wb[swz(r0, c_hi)], wb[swz(r1, c_lo)],
                                 wb[swz(r1, c_hi)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[ks][0][i] = nibbles_s8(words[i]);
        a[ks][1][i] = nibbles_s8(words[i] >> 4);
      }
    }
  };
  // the products of k-tile t; a group's first product starts the partial afresh
  auto issue = [&](uint32_t (&a)[kSteps][2][4], int t) {
    const uint8_t* st = smem + (t % kStages) * kStageBytes;
    const uint64_t d_lo = gmma_desc(smem_u32(st), 16, 8 * 128, gmma_layout(128));
    const uint64_t d_hi = gmma_desc(smem_u32(st + kXHalfBytes), 16, 8 * 128, gmma_layout(128));
    const int fresh = t % per_group == 0;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {  // +32 bytes of k a step
      wgmma_rs_s8_n128(acc, a[ks][0], d_lo + 2 * ks, !(fresh && ks == 0));
      wgmma_rs_s8_n128(acc, a[ks][1], d_hi + 2 * ks, 1);
    }
    wgmma_commit();
  };
  // k-tile t's products are done: release its stage, and warp 0 refills it
  // with tile t + kStages once the other warps have released it too
  auto release = [&](int t) {
    release_stage(&empty[t % kStages], lane);
    if (loader && t + kStages - 1 < tiles) produce(t + kStages - 1);
  };
  auto fence_a = [&](uint32_t (&a)[kSteps][2][4]) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      fence_regs(a[ks][0]);
      fence_regs(a[ks][1]);
    }
  };

  float accf[64];  // the folded sum
#pragma unroll
  for (int i = 0; i < 64; ++i) accf[i] = 0.f;
  // One tile's products stay in flight while the next tile's fragments load
  // (cur and nxt alternate; a buffer is reloaded only after the products
  // that read it have completed), except at a group's last tile, whose
  // products are waited for before the fold. Every step waits for the tile
  // before it unconditionally, so that ptxas sees each buffer's products
  // complete before the buffer is rewritten (a wait on a runtime condition
  // made it inject waits of its own).
  auto step = [&](uint32_t (&cur)[kSteps][2][4], uint32_t (&nxt)[kSteps][2][4], int t) {
    const int pos = t % per_group;
    if (pos == 0) {
      const int grp = t / per_group;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sc[h] = n0 + cls[h] < n ? scale[(size_t)grp * n + n0 + cls[h]] : 0.f;
    }
    issue(cur, t);
    wgmma_wait<1>();
    fence_a(nxt);
    if (pos != 0) release(t - 1);  // a group's last tile is released at its fold
    if (pos == per_group - 1) {  // fold the group's dot in group order
      wgmma_wait<0>();
      fence_regs(acc);
      fence_a(cur);
      release(t);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        accf[i] = __fadd_rn(accf[i], __fmul_rn((float)acc[i], sc[(i >> 1) & 1]));
    }
    if (t + 1 < tiles) load_a(nxt, t + 1);
  };
  uint32_t a0[kSteps][2][4], a1[kSteps][2][4];
  load_a(a0, 0);
  for (int t = 0; t < tiles; t += 2) {
    step(a0, a1, t);
    if (t + 1 < tiles) step(a1, a0, t + 1);
  }

  // epilogue: accf times the row scale, staged row-major in the ring
  __syncthreads();  // both consumer warpgroups are done with the ring
  constexpr int kStride = kTileStride<OutT, kCols>;
  OutT* tile = reinterpret_cast<OutT*>(smem);
#pragma unroll
  for (int c = 0; c < kRows / 8; ++c) {  // rows 8c + 2t4 and + 1
    const int rl = c * 8 + t4 * 2;
    const float r0 = m0 + rl < m ? rs[m0 + rl] : 0.f;
    const float r1 = m0 + rl + 1 < m ? rs[m0 + rl + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __fmul_rn(accf[4 * c + e], (e & 1) ? r1 : r0);
      tile[(rl + (e & 1)) * kStride + cls[e >> 1]] = from_float<OutT>(v);
    }
  }
  __syncthreads();
  store_tile<OutT, kRows, kCols, kThreads>(tile, out, m0, n0, m, n);
}

// ---------------------------------------------------------- W4A16, M > 16
namespace a16 {
constexpr int kCols = 128;      // weight columns a block, 64 a consumer warpgroup
constexpr int kRows = 256;      // activation rows a block: the wgmma's N
constexpr int kBox = wbox::kCols;
constexpr int kThreads = 256;   // two consumer warpgroups; warp 0 also loads
constexpr int kWordRows = 16;   // word rows a tile: 64 k of each half of a group
constexpr int kSteps = 4;       // m64n256k16 steps a stage: 64 bf16 k, 128 bytes of a row
constexpr int kXBytes = kRows * 128;               // 32 KB
constexpr int kBoxBytes = kWordRows * kBox * 4;    // 2 KB
constexpr int kWBytes = kCols / kBox * kBoxBytes;  // 8 KB
constexpr int kStageBytes = kXBytes + kWBytes;     // 40 KB
constexpr int kStages = 5;
constexpr int kAcc = kRows / 2;  // accumulators a thread
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kRows * (kCols + 4) * 4 <= kStages * kStageBytes, "epilogue tile");
}  // namespace a16

// W4A16 above 16 rows: x_map the bf16 rows, boxes of 256 rows x 64 k (128
// bytes) in the 128-byte swizzle; w_map the weight's (N, K/8) int32 map,
// boxes of 32 columns x 16 word rows, when N % 4 == 0 (w_tma), else warp 0
// copies the words by cp.async. Stage i is word-row tile i / 2 (16 word
// rows, 64 k of each half of its group) and half i % 2 of it: the tile's
// words (8 KB, loaded with each half) and the 64 activations of that half.
template <typename OutT>
__global__ void __launch_bounds__(a16::kThreads, 1)
a16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map, int w_tma,
                 const uint32_t* __restrict__ w, const float* __restrict__ scale,
                 OutT* __restrict__ out, int m, int k, int n, int group) {
  using namespace a16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  int m0, n0;
  tile_origin<kRows, kCols>(blockIdx.x, (n + kCols - 1) / kCols, (m + kRows - 1) / kRows, m0,
                            n0);
  const int stages = k / 64, per_group = group / 64, tiles_per_group = group / 128;
  const int groups = k / group;
  const int lane = threadIdx.x % 32;
  init_ring<kStages>(full, empty, w_tma);

  // warp 0 loads stage i into ring slot i % kStages once it is released
  auto produce = [&](int i) {
    const int s = i % kStages, t = i >> 1;
    if (lane == 0 && i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
    __syncwarp();
    uint8_t* st = smem + s * kStageBytes;
    uint8_t* ws = st + kXBytes;
    const int kx = (t / tiles_per_group) * group + (i & 1) * (group / 2) +
                   (t % tiles_per_group) * 64;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], kXBytes + (w_tma ? kWBytes : 0));
      tma_load_2d(st, &x_map, &full[s], kx, m0);
      if (w_tma) {
#pragma unroll
        for (int b = 0; b < kCols / kBox; ++b)
          tma_load_2d(ws + b * kBoxBytes, &w_map, &full[s], n0 + b * kBox, t * kWordRows);
      }
    }
    if (!w_tma) {
      copy_words<kWordRows, kCols>(ws, w, t * kWordRows, n0, n, lane);
      cp_async_arrive(&full[s]);
    }
  };
  const bool loader = threadIdx.x < 32;
  constexpr int kAhead = kStages - 1;  // a slot is refilled one step after its release
  if (loader)
    for (int i = 0; i < kAhead && i < stages; ++i) produce(i);

  // ------------------------------------------------------------- consumers
  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int box = cw * 2 + (warp >> 1);
  int cls[2];  // this thread's two columns (fragment rows g and g + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) cls[h] = cw * 64 + (warp >> 1) * 32 + wbox::col(warp, g + 8 * h);
  const int c_lo = cls[0] % kBox, c_hi = cls[1] % kBox;
  const uint32_t sel = (t4 & 1) ? kBytes23 : kBytes01;
  auto col_scale = [&](int grp, int h) {  // 1 past N: those columns are not stored
    return n0 + cls[h] < n ? scale[(size_t)grp * n + n0 + cls[h]] : 1.f;
  };
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // sld: the scales of the group whose fragments load; spre: the next
  // group's, loaded a group ahead; unit: the scale acc counts in (the last
  // nonzero one so far); zero: the column's scale is 0 in the loading
  // group, whose values then convert as 0 (mask and fill)
  float sld[2], spre[2] = {col_scale(0, 0), col_scale(0, 1)}, unit[2] = {1.f, 1.f};
  bool zero[2] = {false, false};
  uint32_t mask[2], fill[2];

  // A fragments of stage i: k16 step ks takes word rows 4ks + t4/2 and + 2
  // (k 2t4, 2t4 + 1 and 2t4 + 8, 2t4 + 9: bytes 0-1 or 2-3 of the word), the
  // low nibbles for the group's first half, the high ones for its second
  auto load_a = [&](uint32_t (&a)[kSteps][4], int i) {
    if (i % per_group == 0) {
      const int grp = i / per_group;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sld[h] = spre[h];
        spre[h] = grp + 1 < groups ? col_scale(grp + 1, h) : 1.f;
        zero[h] = sld[h] == 0.f;
        mask[h] = zero[h] ? 0u : kNibbleMask;
        fill[h] = zero[h] ? kZeroFill : kNibbleFill;
      }
    }
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(smem + s * kStageBytes + kXBytes +
                                                           box * kBoxBytes);
    const uint32_t shift = (i & 1) * 4;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int r0 = ks * 4 + (t4 >> 1), r1 = r0 + 2;
      const uint32_t words[4] = {wb[swz(r0, c_lo)], wb[swz(r0, c_hi)], wb[swz(r1, c_lo)],
                                 wb[swz(r1, c_hi)]};
#pragma unroll
      for (int j = 0; j < 4; ++j)  // words 0, 2: column cls[0]; 1, 3: cls[1]
        a[ks][j] = nibbles_bf16(words[j] >> shift, sel, mask[j & 1], fill[j & 1]);
    }
  };
  auto issue = [&](uint32_t (&a)[kSteps][4], int i) {
    const uint64_t db = gmma_desc(smem_u32(smem + (i % kStages) * kStageBytes), 16, 8 * 128,
                                  gmma_layout(128));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) wgmma_rs_bf16_n256<0>(acc, a[ks], db + 2 * ks, 1);
    wgmma_commit();
  };
  auto release = [&](int i) {
    release_stage(&empty[i % kStages], lane);
    if (loader && i + kAhead < stages) produce(i + kAhead);
  };
  auto fence_a = [&](uint32_t (&a)[kSteps][4]) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) fence_regs(a[ks]);
  };
  // the rescaled fold: entering a group of scales sld, acc (in units of
  // `unit`) is multiplied by unit / sld where sld != 0, which then becomes
  // the unit; a zero scale's group adds nothing (its values convert as 0)
  // and leaves acc as it is. Nothing divides by a zero scale.
  auto enter_group = [&](bool apply) {
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f[h] = zero[h] ? 1.f : __fdiv_rn(unit[h], sld[h]);
      unit[h] = zero[h] ? unit[h] : sld[h];
    }
    if (apply) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) acc[j] = __fmul_rn(acc[j], f[(j >> 1) & 1]);
    }
  };
  // One stage's products stay in flight while the next stage's fragments
  // load (cur and nxt alternate). The products are waited for at each
  // group's end, a wait in the group loop's body and not under a runtime
  // condition (ptxas serializes every wgmma of a kernel that waits under
  // one), before acc is rescaled; the next group's first fragments are
  // loaded before that wait.
  auto step = [&](uint32_t (&cur)[kSteps][4], uint32_t (&nxt)[kSteps][4], int i) {
    issue(cur, i);
    wgmma_wait<1>();
    fence_a(nxt);
    if (i > 0) release(i - 1);
    if (i + 1 < stages) load_a(nxt, i + 1);
  };
  uint32_t a0[kSteps][4], a1[kSteps][4];
  load_a(a0, 0);
  enter_group(false);
  for (int grp = 0; grp < groups; ++grp) {
    for (int i = grp * per_group; i < (grp + 1) * per_group; i += 2) {  // per_group is even
      step(a0, a1, i);
      step(a1, a0, i + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_a(a0);
    fence_a(a1);
    enter_group(true);  // past the last group: unit / sld = 1, acc stays
  }
  release(stages - 1);

  // epilogue: acc times its unit, staged row-major through shared memory
  const float fin[2] = {unit[0], unit[1]};
  __syncthreads();  // both consumer warpgroups are done with the ring
  constexpr int kStride = kTileStride<OutT, kCols>;
  OutT* tile = reinterpret_cast<OutT*>(smem);
#pragma unroll
  for (int c = 0; c < kRows / 8; ++c) {  // rows 8c + 2t4 and + 1
    const int rl = c * 8 + t4 * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(rl + (e & 1)) * kStride + cls[e >> 1]] =
          from_float<OutT>(__fmul_rn(acc[4 * c + e], fin[e >> 1]));
  }
  __syncthreads();
  store_tile<OutT, kRows, kCols, kThreads>(tile, out, m0, n0, m, n);
}

// the weight's (N, K/8) int32 map, boxes of 32 columns x `rows` word rows in
// the 128-byte swizzle; false where cuTensorMapEncodeTiled refuses it
inline bool word_map(CUtensorMap* map, const uint32_t* w, int k, int n, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)(k / 8)};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {wbox::kCols, (cuuint32_t)rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename OutT>
cudaError_t launch_w4a8_wgmma(const int8_t* xq, const uint32_t* w, const float* scale,
                              const float* rs, OutT* out, int m, int k, int n, int group,
                              cudaStream_t s) {
  using namespace wg;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k};
  const cuuint32_t x_box[2] = {(cuuint32_t)kHalfK, kRows};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // TMA rows must be 16-byte strided: the weight's when N % 4 == 0
  const int w_tma = (n % 4) == 0;
  if (w_tma && !word_map(&w_map, w, k, n, kWordRows)) return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a8_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int blocks = ((n + kCols - 1) / kCols) * ((m + kRows - 1) / kRows);
  w4a8_wgmma_kernel<OutT><<<blocks, kThreads, kSmem, s>>>(x_map, w_map, w_tma, w, scale, rs,
                                                           out, m, k, n, group);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_a16_wgmma(const bf16* xs, const uint32_t* w, const float* scale, OutT* out,
                             int m, int k, int n, int group, cudaStream_t s) {
  using namespace a16;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t x_box[2] = {64, kRows};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const int w_tma = (n % 4) == 0;
  if (w_tma && !word_map(&w_map, w, k, n, kWordRows)) return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        a16_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int blocks = ((n + kCols - 1) / kCols) * ((m + kRows - 1) / kRows);
  a16_wgmma_kernel<OutT><<<blocks, kThreads, kSmem, s>>>(x_map, w_map, w_tma, w, scale, out, m,
                                                         k, n, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w4a8(const T* x, int8_t* xq, float* rs, const uint32_t* w,
                        const float* scale, T* out, int m, int k, int n, int group,
                        cudaStream_t s) {
  quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(x, xq, rs, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (m > 16) return launch_w4a8_wgmma<T>(xq, w, scale, rs, out, m, k, n, group, s);
  w4a8::SkinnyArgs p{reinterpret_cast<const uint32_t*>(xq), rs, w, scale, nullptr, out,
                     m, k, n, group, group};
  return w4a8::launch_skinny<w4a8::kRowScale, T>(p, s);
}

template <typename T>
cudaError_t launch_w4a16(const T* x, bf16* xb, const uint32_t* w, const float* scale,
                         T* out, int m, int k, int n, int group, cudaStream_t s) {
  const bf16* xs = reinterpret_cast<const bf16*>(x);
  if constexpr (std::is_same<T, float>::value) {  // the pre-pass: x rounded to bf16
    const cudaError_t e = round_to_bf16(x, xb, (size_t)m * k, s);
    if (e != cudaSuccess) return e;
    xs = xb;
  }
  if (m > 16) return launch_a16_wgmma<T>(xs, w, scale, out, m, k, n, group, s);
  const dim3 grid((n + kSkCols - 1) / kSkCols, (m + 15) / 16);
  a16_skinny_kernel<T><<<grid, kSkWarps * 32, 0, s>>>(xs, w, scale, out, m, k, n, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* xs, void* row_scale, const void* w, const void* scale,
                   void* out, int m, int k, int n, int group, int int8_mxu, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const uint32_t* w32 = static_cast<const uint32_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  T* o = static_cast<T*>(out);
  if (int8_mxu)
    return launch_w4a8<T>(xt, static_cast<int8_t*>(xs), static_cast<float*>(row_scale), w32, sc,
                          o, m, k, n, group, s);
  return launch_w4a16<T>(xt, static_cast<bf16*>(xs), w32, sc, o, m, k, n, group, s);
}

}  // namespace

// x (M, K) bf16 (x_bf16 = 1) or f32; w (K/8, N) int32 packed by
// pack_int4_rows(block=group), scale (K/group, N) f32; out (M, N) in x's
// dtype. K and group must be multiples of 256, K of group. Scratch: W4A8
// (int8_mxu = 1): xs (M, K) int8 and row_scale (M,) f32, which the
// activation quantization fills; W4A16: xs (M, K) bf16 for f32 x (the
// pre-pass rounds x into it), unused (and row_scale always) otherwise.
extern "C" int mmor_int4_matmul(const void* x, void* xs, void* row_scale, const void* w,
                                const void* scale, void* out, int m, int k, int n, int group,
                                int x_bf16, int int8_mxu, void* stream) {
  if (group % 256 != 0 || k % group != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? (int)launch<bf16>(x, xs, row_scale, w, scale, out, m, k, n, group, int8_mxu, s)
                : (int)launch<float>(x, xs, row_scale, w, scale, out, m, k, n, group, int8_mxu,
                                     s);
}
