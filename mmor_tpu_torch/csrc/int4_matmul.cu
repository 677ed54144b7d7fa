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
//    product kernels read bf16 only); each K-group's dot sums exact bf16
//    products in f32 on the tensor cores and folds the same way, acc = acc
//    + dot * scale[group, col]. The plain version is the JAX CPU path (f32
//    dequantization, then x @ w), so the two differ by the sums' order and,
//    for f32 x, by x's rounding.
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
//  - M > 16 (prefill): wgmma_kernel<W4A8 or W4A16>, K2's prefill form
//    (int8_matmul.cu's wgmma_kernel<true>) for int4 words. Each output tile is
//    computed transposed, W^T (columns x K) times x^T (K x rows): the
//    weight words, converted in registers, are the A fragments (a fragment
//    row is a weight column), and the activation rows are the K-major B
//    operand in shared memory. A block is two consumer warpgroups, each 64
//    weight columns by 128 activation rows (m64n128), fed by a ring that
//    warp 0 keeps filled with TMA, paced by full and empty mbarriers: a
//    stage is a run of word rows of 128 columns (32-column boxes in the
//    128-byte swizzle, wbox in hopper.cuh) and the two activation boxes
//    that pair with them, the group's first half at g0 + 4 r0 and its
//    second at g0 + group/2 + 4 r0, 128 rows x 128 bytes each (W4A8: 32
//    word rows, 128 int8 k of each half, m64n128k32 s8; W4A16: 16 word
//    rows, 64 bf16 k of each half, m64n128k16 bf16). A word register is
//    loaded once and feeds the products of both halves. Where N % 4 != 0,
//    which TMA's 16-byte row strides cannot describe, warp 0 copies the
//    words by cp.async instead.
//    Registers: a group's partial dot and the running f32 sum are two
//    accumulator sets, 64 + 64 registers a thread at m64n128 (two m64n256
//    sets, K2's width, would need 256 of the 255 a thread may hold), plus
//    two stages of converted A fragments (32 each), one stage's products
//    in flight while the next stage's fragments load. At a group's last
//    stage the warpgroup waits for its products, folds the partial with
//    the group's scales (loaded at its first stage) and starts the next
//    group's partial afresh (the first product's scale-d is 0). The
//    bf16 A fragment takes k in pairs (2t, 2t+1 and 2t+8, 2t+9), so a
//    word of four consecutive k feeds two lanes, which both load it (one
//    broadcast read): a stage converted into a bf16 tile for the ss form
//    would cost a pass through shared memory and a barrier. A 128 x 128
//    tile moves as many bytes a multiply-add as K2's 128 x 256 one (the
//    int4 weights are half as wide), and blocks walk the output in groups
//    of 8 row tiles, so a wave's activation rows and weight columns stay
//    in L2. The epilogue stages the tile through shared memory so that
//    the (M, N) stores are row-major and coalesced.
//    What bounds it, in development builds timed on an H100 at M 5664 x
//    4096 x 12288: the stages' bytes more than the products (issuing only
//    the first half's products saved far less than half the time, a ring
//    of one stage fewer was slower, and folding once instead of every
//    1024-row group saved little). Three forms that moved fewer bytes or
//    overlapped more were built and were slower in both branches, so none
//    is kept: persistent blocks that load the next tile's stages
//    during a tile's epilogue, a 2-block cluster sharing each activation
//    box by TMA multicast, and stages of half the word rows (64-byte
//    activation rows, twice the stages in the same ring; the cause was
//    not isolated for any of them). A call's fixed cost is small beside
//    its main loop: the time grows about linearly with K.

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
// w as the bf16 pair (q0, q1), the lower byte in the low half
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w, uint32_t sel) {
  uint32_t v = (__byte_perm(w, 0u, sel) & 0x000F000Fu) | 0x43004300u;  // 128 + u
  const __nv_bfloat162 q =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&q);
}
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
namespace wg {
constexpr int kCols = 128;   // weight columns a block, 64 a consumer warpgroup
constexpr int kRows = 128;   // activation rows a block: the wgmma's N
constexpr int kBox = wbox::kCols;
constexpr int kThreads = 256;  // two consumer warpgroups; warp 0 also loads
constexpr int kRaster = 8;     // row tiles a raster group

// the origin of output tile `id`: row tiles in groups of kRaster, the
// columns walked within a group, so that a wave of tiles shares rows and
// columns in L2
__device__ __forceinline__ void tile_origin(int id, int n_ct, int n_rt, int& m0, int& n0) {
  const int per = kRaster * n_ct, first = (id / per) * kRaster;
  const int rows = min(n_rt - first, kRaster), pos = id % per;
  m0 = (first + pos % rows) * kRows;
  n0 = (pos / rows) * kCols;
}

template <bool kA8>
struct Cfg {
  static constexpr int kWordRows = kA8 ? 32 : 16;  // word rows a stage
  static constexpr int kHalfK = 4 * kWordRows;     // k of each half a stage: 128 bytes of a row
  static constexpr int kSteps = 4;                 // mma k-steps a half: k32 s8 or k16 bf16
  static constexpr int kXHalfBytes = kRows * 128;  // one activation box
  static constexpr int kBoxBytes = kWordRows * kBox * 4;
  static constexpr int kWBytes = kCols / kBox * kBoxBytes;
  static constexpr int kStageBytes = 2 * kXHalfBytes + kWBytes;
  static constexpr int kStages = kA8 ? 4 : 5;  // W4A8 48 KB stages, W4A16 40 KB
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  using Acc = typename std::conditional<kA8, int, float>::type;
};
static_assert(kRows * (kCols + 4) * 4 <= Cfg<true>::kStages * Cfg<true>::kStageBytes &&
              kRows * (kCols + 4) * 4 <= Cfg<false>::kStages * Cfg<false>::kStageBytes,
              "epilogue tile");
using wbox::swz;
}  // namespace wg

// x_map: the activation rows (xq int8 for W4A8, bf16 for W4A16), boxes of
// 128 rows x 128 bytes in the 128-byte swizzle; w_map: the weight's (N,
// K/8) int32 map, boxes of 32 columns x kWordRows word rows in the 128-byte
// swizzle, when N % 4 == 0 (w_tma); otherwise warp 0 copies the words, 4
// bytes a cp.async. rs: W4A8's row scales.
template <bool kA8, typename OutT>
__global__ void __launch_bounds__(wg::kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
             const __grid_constant__ CUtensorMap w_map, int w_tma,
             const uint32_t* __restrict__ w, const float* __restrict__ scale,
             const float* __restrict__ rs, OutT* __restrict__ out, int m, int k, int n,
             int group) {
  using namespace wg;
  using C = Cfg<kA8>;
  using Acc = typename C::Acc;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the 128-byte swizzle; offset from the __shared__ array
  // so that accesses compile to shared-memory loads, not generic ones
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  int m0, n0;
  tile_origin(blockIdx.x, (n + kCols - 1) / kCols, (m + kRows - 1) / kRows, m0, n0);
  const int tiles = k / 8 / C::kWordRows, per_group = group / 8 / C::kWordRows;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      // the TMA bytes' arrival, and each lane's cp.asyncs where they copy the weights
      mbar_init(&full[s], w_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Warp 0 loads k-tile t into stage t % kStages, once every warp has
  // released the tile that stage held (kStages tiles before).
  auto produce = [&](int t) {
    const int s = t % C::kStages;
    if (lane == 0 && t >= C::kStages) mbar_wait(&empty[s], ((t / C::kStages) - 1) & 1);
    __syncwarp();
    uint8_t* st = smem + s * C::kStageBytes;
    uint8_t* ws = st + 2 * C::kXHalfBytes;
    const int k_lo = (t / per_group) * group + (t % per_group) * C::kHalfK;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * C::kXHalfBytes + (w_tma ? C::kWBytes : 0));
      tma_load_2d(st, &x_map, &full[s], k_lo, m0);
      tma_load_2d(st + C::kXHalfBytes, &x_map, &full[s], k_lo + group / 2, m0);
      if (w_tma) {
#pragma unroll
        for (int b = 0; b < kCols / kBox; ++b)
          tma_load_2d(ws + b * C::kBoxBytes, &w_map, &full[s], n0 + b * kBox,
                      t * C::kWordRows);
      }
    }
    if (!w_tma) {  // kWordRows word rows x 128 columns, into the boxes' swizzled layout
      for (int c = lane; c < C::kWordRows * kCols; c += 32) {
        const int r = c / kCols, col = c % kCols;
        const int wr = t * C::kWordRows + r;
        const bool in = n0 + col < n;
        uint32_t* dst = reinterpret_cast<uint32_t*>(ws + (col / kBox) * C::kBoxBytes) +
                        swz(r, col % kBox);
        cp_async4(dst, in ? w + (size_t)wr * n + n0 + col : w, in ? 4 : 0);
      }
      cp_async_arrive(&full[s]);
    }
  };
  const bool loader = threadIdx.x < 32;
  if (loader)
    for (int t = 0; t < C::kStages - 1 && t < tiles; ++t) produce(t);

  // ------------------------------------------------------------- consumers
  const int cw = threadIdx.x / 128;  // consumer warpgroup: weight columns 64cw..
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int box = cw * 2 + (warp >> 1);  // this warp's 32-column box
  int cls[2];  // this thread's two columns in the block (fragment rows g and g + 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) cls[h] = cw * 64 + (warp >> 1) * 32 + wbox::col(warp, g + 8 * h);
  const int c_lo = cls[0] % kBox, c_hi = cls[1] % kBox;
  Acc acc[64];  // the group's partial dot
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  float sc[2] = {0.f, 0.f};  // the current group's scales of this thread's columns

  // The A fragments of k-tile t, once its stage has landed: a[step][half][4].
  // W4A8, k32 step ks: word rows 8ks + t4 and + 4 (k 4t4.. and 16 + 4t4..).
  // W4A16, k16 step ks: word rows 4ks + t4/2 and + 2 (k 2t4, 2t4 + 1 and
  // 2t4 + 8, 2t4 + 9: bytes 0-1 or 2-3 of the word).
  auto load_a = [&](uint32_t (&a)[C::kSteps][2][4], int t) {
    const int s = t % C::kStages;
    mbar_wait(&full[s], (t / C::kStages) & 1);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(smem + s * C::kStageBytes +
                                                           2 * C::kXHalfBytes + box * C::kBoxBytes);
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      const int r0 = kA8 ? ks * 8 + t4 : ks * 4 + (t4 >> 1), r1 = r0 + (kA8 ? 4 : 2);
      const uint32_t words[4] = {wb[swz(r0, c_lo)], wb[swz(r0, c_hi)], wb[swz(r1, c_lo)],
                                 wb[swz(r1, c_hi)]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kA8) {
          a[ks][0][i] = nibbles_s8(words[i]);
          a[ks][1][i] = nibbles_s8(words[i] >> 4);
        } else {
          const uint32_t sel = (t4 & 1) ? kBytes23 : kBytes01;
          a[ks][0][i] = nibbles_bf16(words[i], sel);
          a[ks][1][i] = nibbles_bf16(words[i] >> 4, sel);
        }
      }
    }
  };
  // the products of k-tile t; a group's first product starts the partial afresh
  auto issue = [&](uint32_t (&a)[C::kSteps][2][4], int t) {
    const uint8_t* st = smem + (t % C::kStages) * C::kStageBytes;
    const uint64_t d_lo = gmma_desc(smem_u32(st), 16, 8 * 128, gmma_layout(128));
    const uint64_t d_hi = gmma_desc(smem_u32(st + C::kXHalfBytes), 16, 8 * 128,
                                    gmma_layout(128));
    const int fresh = t % per_group == 0;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {  // +32 bytes of k a step
      if constexpr (kA8) {
        wgmma_rs_s8_n128(acc, a[ks][0], d_lo + 2 * ks, !(fresh && ks == 0));
        wgmma_rs_s8_n128(acc, a[ks][1], d_hi + 2 * ks, 1);
      } else {
        wgmma_rs_bf16_n128<0>(acc, a[ks][0], d_lo + 2 * ks, !(fresh && ks == 0));
        wgmma_rs_bf16_n128<0>(acc, a[ks][1], d_hi + 2 * ks, 1);
      }
    }
    wgmma_commit();
  };
  // k-tile t's products are done: release its stage, and warp 0 refills it
  // with tile t + kStages once the other warps have released it too
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % C::kStages]);
    if (loader && t + C::kStages - 1 < tiles) produce(t + C::kStages - 1);
  };
  auto fence_a = [&](uint32_t (&a)[C::kSteps][2][4]) {
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
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
  auto step = [&](uint32_t (&cur)[C::kSteps][2][4], uint32_t (&nxt)[C::kSteps][2][4], int t) {
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
  uint32_t a0[C::kSteps][2][4], a1[C::kSteps][2][4];
  load_a(a0, 0);
  for (int t = 0; t < tiles; t += 2) {
    step(a0, a1, t);
    if (t + 1 < tiles) step(a1, a0, t + 1);
  }

  // epilogue: accf (times the row scale for W4A8), staged row-major in the ring
  __syncthreads();  // both consumer warpgroups are done with the ring
  constexpr int kStride = kCols + 16 / (int)sizeof(OutT);  // padded row, 16-byte aligned
  OutT* tile = reinterpret_cast<OutT*>(smem);
#pragma unroll
  for (int c = 0; c < kRows / 8; ++c) {  // rows 8c + 2t4 and + 1
    const int rl = c * 8 + t4 * 2;
    float r0 = 1.f, r1 = 1.f;
    if constexpr (kA8) {
      r0 = m0 + rl < m ? rs[m0 + rl] : 0.f;
      r1 = m0 + rl + 1 < m ? rs[m0 + rl + 1] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = kA8 ? __fmul_rn(accf[4 * c + e], (e & 1) ? r1 : r0) : accf[4 * c + e];
      tile[(rl + (e & 1)) * kStride + cls[e >> 1]] = from_float<OutT>(v);
    }
  }
  __syncthreads();
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

template <bool kA8, typename OutT>
cudaError_t launch_wgmma(const void* xs, const uint32_t* w, const float* scale, const float* rs,
                         OutT* out, int m, int k, int n, int group, cudaStream_t s) {
  using namespace wg;
  using C = Cfg<kA8>;
  CUtensorMap x_map, w_map;
  const int elem = kA8 ? 1 : 2;  // bytes an activation
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k * elem};
  const cuuint32_t x_box[2] = {(cuuint32_t)C::kHalfK, kRows};
  if (!encode_map(&x_map, kA8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, xs, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // TMA rows must be 16-byte strided: the weight's when N % 4 == 0
  const int w_tma = (n % 4) == 0;
  const cuuint64_t w_dims[2] = {(cuuint64_t)n, (cuuint64_t)(k / 8)};
  const cuuint64_t w_strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t w_box[2] = {kBox, C::kWordRows};
  if (w_tma && !encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, w_dims, w_strides,
                           w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_kernel<kA8, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int blocks = ((n + kCols - 1) / kCols) * ((m + kRows - 1) / kRows);
  wgmma_kernel<kA8, OutT><<<blocks, kThreads, C::kSmem, s>>>(x_map, w_map, w_tma, w, scale, rs,
                                                             out, m, k, n, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w4a8(const T* x, int8_t* xq, float* rs, const uint32_t* w,
                        const float* scale, T* out, int m, int k, int n, int group,
                        cudaStream_t s) {
  quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(x, xq, rs, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (m > 16) return launch_wgmma<true, T>(xq, w, scale, rs, out, m, k, n, group, s);
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
  if (m > 16) return launch_wgmma<false, T>(xs, w, scale, nullptr, out, m, k, n, group, s);
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
