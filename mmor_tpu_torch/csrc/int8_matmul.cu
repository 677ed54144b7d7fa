// K2: packed int8 weight matmul, x @ (unpack(w_p) * scale), K8: the same
// W8A8 product on an unpacked row-major int8 weight, and K10c's mxu8 mode:
// K2's packed words with K8's activation rule.
//
// Replaces mmor_tpu/ops/quantized_matmul.py::int8_matmul_packed
// (_packed_kernel, the pl.pallas_call at :250),
// mmor_tpu/ops/quantized_matmul.py::int8_matmul (_kernel, the pl.pallas_call
// at :102) and the mxu8 mode of tools/perf/bench_bitcast.py::w8b_matmul
// (_kernel, the pl.pallas_call at :95).
//
// What bounds it on the H100: at decode (M = batch = 8) every weight byte
// is read once per token for 16 multiply-adds, so the product is bound by
// device-memory bandwidth; at prefill (M = 8 x 708) it is bound by the int8
// tensor-core rate.
//
// Design: pack_int8_rows stores rows 4r..4r+3 of one output column in one
// int32 word, and the activations are quantized to int8 rows packed the same
// way along K. Those words are exactly the B and A operands of
// mma.sync.m16n8k32.s8 (a thread's A register holds 4 consecutive k of one
// row, its B register 4 consecutive k of one column), so the TPU's weight
// layout stays as it is and no unpacking happens at all.
//  - W8A8 (int8_mxu): a first kernel quantizes the activation rows (one
//    block per row, the plain version's arithmetic, so the two agree bit for
//    bit); then int32 accumulation, acc * col_scale * row_scale in f32,
//    stored in the caller's dtype.
//    * skinny kernel (M <= 16, decode): one 16-row m-tile; a block of eight
//      warps covers 32 columns and splits K between its warps, so a 4096
//      column weight spreads over 128 blocks; operands load straight from
//      device memory (each weight word is used once), four k-steps of loads
//      in flight per warp before their products, and the warps' partial
//      sums meet in shared memory. The mma takes any 8 columns in its n
//      slots, so lane group g owns the four neighbouring columns 4g..4g+3
//      of the block, one in each 8-column mma tile, and fetches their words
//      of a word row at once (weight_words.cuh's w_words4).
//    * wgmma kernel (M > 16, prefill; packed words only): see below.
//    * tiled kernel (M > 16 on K8's byte layout, which no serving path
//      runs): 64 x 64 block tiles, a 2 x 2 warp grid of 32 x 32 warp tiles
//      on mma.sync, K staged through shared memory 64 at a time.
//  - The wgmma kernel computes each output tile transposed, as
//    W^T (columns x K) times xq^T (K x rows), so that the packed words need
//    no transpose: a word, four consecutive k of one output column, is one
//    8-bit A register of wgmma.m64nNk32 (the same map as mma.m16n8k32's A),
//    and the int8 activation rows are the K-major B operand that 8-bit
//    wgmma requires. A block is two consumer warpgroups, each covering 64
//    weight columns by 256 activation rows (one m64n256k32 a 32-k step, s32
//    accumulators in registers), fed by a ring of 4 stages of 128 k that
//    warp 0 keeps filled with TMA three tiles ahead: the activation tile
//    (256 rows x 128 bytes) and the weight tile (32 word rows x 128
//    columns, four boxes of 32) in the 128-byte swizzle, so that wgmma
//    reads the activations as they land and a consumer's 32-bit loads of
//    its A fragments hit 32 distinct banks: the columns are assigned to the
//    fragment's rows in the order that makes them so (wg_col). Where
//    N % 4 != 0, which TMA's 16-byte row strides cannot describe, warp 0
//    copies the words by cp.async instead. Full and empty mbarriers pace
//    the ring; a consumer keeps one tile's products in flight while it
//    loads the next tile's fragments. No warp only loads: with 8 warps a
//    block, two on each SM sub-partition, a thread may hold up to 255
//    registers (a ninth warp would cap them at 168 and spill the
//    accumulators). The epilogue, acc * scale[col] * rs[row] in f32 in that
//    order, stages the tile through shared memory so that the (M, N) stores
//    are row-major and coalesced. The s32 sums are exact, so the result is
//    bit for bit the plain version's.
//  - K8 is the same W8A8 kernels with two template parameters changed:
//    the weight layout (WLayout::kBytes, the unpacked (K, N) int8 weight:
//    a thread reads four neighbouring columns of each of four rows as one
//    4-byte load a row and transposes the 4 x 4 bytes into their words) and
//    the activation rule (QuantRule::kDivide: x / row_scale in f32, K8's
//    quantized_matmul.py:81-84). Its epilogue is K2's, in JAX's order.
//  - K10c's mxu8 mode is the same two kernels on K2's own packed words
//    (WLayout::kWords) with K8's rule (QuantRule::kDivide): bench_bitcast's
//    pack_rows_int8 is pack_int8_rows, and its epilogue, acc * scale in f32
//    and then times the row scale, is K2's.
//  - W8A16 (int8_mxu off): a plain FMA kernel over bf16/f32 activations and
//    int8 weights converted in registers, f32 accumulation, times col_scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "hopper.cuh"
#include "weight_words.cuh"

namespace {

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- W8A8 skinny
constexpr int kSkinnyWarps = 8;
constexpr int kSkinnyN = 32;
constexpr int kSkinnyUnroll = 4;  // k-steps a warp loads before its products

template <typename OutT, WLayout L>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
s8_skinny_kernel(const uint32_t* __restrict__ xq, const void* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ rs,
                 OutT* __restrict__ out, int m, int kw, int n) {
  __shared__ int red[kSkinnyWarps][16][kSkinnyN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kSkinnyN;
  const int steps = kw / 8;  // 8 words = 32 k per step

  int acc[kSkinnyN / 8][4] = {};
  // each warp takes kSkinnyUnroll consecutive steps at a time and issues all
  // their loads before the products, so enough bytes are in flight
  for (int s0 = warp * kSkinnyUnroll; s0 < steps; s0 += kSkinnyWarps * kSkinnyUnroll) {
    uint32_t a[kSkinnyUnroll][4], b[kSkinnyUnroll][kSkinnyN / 8][2];
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const bool live = s0 + u < steps;
      const int k0 = (s0 + u) * 8;
      a[u][0] = live && g < m ? xq[(size_t)g * kw + k0 + t4] : 0u;
      a[u][1] = live && g + 8 < m ? xq[(size_t)(g + 8) * kw + k0 + t4] : 0u;
      a[u][2] = live && g < m ? xq[(size_t)g * kw + k0 + t4 + 4] : 0u;
      a[u][3] = live && g + 8 < m ? xq[(size_t)(g + 8) * kw + k0 + t4 + 4] : 0u;
      // lane group g owns the four neighbouring columns n0 + 4g .. 4g + 3,
      // one in each 8-column mma tile
      const int col = n0 + 4 * g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = k0 + t4 + 4 * h;
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (live && (n % 4) == 0 && col + 3 < n) {
          q = w_words4<L>(w, r, col, n);
        } else if (live) {
          q.x = col < n ? w_word<L>(w, r, col, n) : 0u;
          q.y = col + 1 < n ? w_word<L>(w, r, col + 1, n) : 0u;
          q.z = col + 2 < n ? w_word<L>(w, r, col + 2, n) : 0u;
          q.w = col + 3 < n ? w_word<L>(w, r, col + 3, n) : 0u;
        }
        b[u][0][h] = q.x, b[u][1][h] = q.y, b[u][2][h] = q.z, b[u][3][h] = q.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u)
#pragma unroll
      for (int nt = 0; nt < kSkinnyN / 8; ++nt) mma_s8(acc[nt], a[u], b[u][nt]);
  }
#pragma unroll
  for (int nt = 0; nt < kSkinnyN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = t4 * 2 + (e & 1);  // the mma column, block column 4c + nt
      red[warp][g + (e >> 1) * 8][4 * c + nt] = acc[nt][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * kSkinnyN; i += kSkinnyWarps * 32) {
    const int row = i / kSkinnyN, cl = i % kSkinnyN, col = n0 + cl;
    if (row >= m || col >= n) continue;
    int sum = 0;
    for (int wi = 0; wi < kSkinnyWarps; ++wi) sum += red[wi][row][cl];
    out[(size_t)row * n + col] = from_float<OutT>((float)sum * scale[col] * rs[row]);
  }
}

// ----------------------------------------------------------------- W8A8 tiled
// K8's byte-layout weight at M > 16 (no serving path; the packed words take
// the wgmma kernel below)
constexpr int kTileM = 64, kTileN = 64, kTileKW = 16;  // KW = K / 4 words
constexpr int kXStride = kTileKW + 4;   // conflict-free A fragment reads
constexpr int kWStride = kTileN + 8;    // conflict-free B fragment reads

template <typename OutT, WLayout L>
__global__ void __launch_bounds__(128)
s8_tiled_kernel(const uint32_t* __restrict__ xq, const void* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ rs,
                OutT* __restrict__ out, int m, int kw, int n) {
  __shared__ __align__(16) uint32_t xs[kTileM * kXStride];
  __shared__ __align__(16) uint32_t ws[kTileKW * kWStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const bool vec_w = (n % 4) == 0;

  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < kw; k0 += kTileKW) {
    // stage X (64 rows x 16 words) and W (16 words x 64 cols), 16 bytes a load
    for (int c = threadIdx.x; c < kTileM * kTileKW / 4; c += 128) {
      const int r = c / (kTileKW / 4), cw = (c % (kTileKW / 4)) * 4;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m)
        val = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * kw + k0 + cw);
      *reinterpret_cast<uint4*>(xs + r * kXStride + cw) = val;
    }
    for (int c = threadIdx.x; c < kTileKW * kTileN / 4; c += 128) {
      const int r = c / (kTileN / 4), cc = (c % (kTileN / 4)) * 4;
      const int col = n0 + cc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (vec_w && col + 3 < n) {
        val = w_words4<L>(w, k0 + r, col, n);
      } else {
        val.x = col < n ? w_word<L>(w, k0 + r, col, n) : 0u;
        val.y = col + 1 < n ? w_word<L>(w, k0 + r, col + 1, n) : 0u;
        val.z = col + 2 < n ? w_word<L>(w, k0 + r, col + 2, n) : 0u;
        val.w = col + 3 < n ? w_word<L>(w, k0 + r, col + 3, n) : 0u;
      }
      *reinterpret_cast<uint4*>(ws + r * kWStride + cc) = val;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileKW / 8; ++ks) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* xr = xs + (wm * 32 + mt * 16 + g) * kXStride + ks * 8 + t4;
        a[mt][0] = xr[0];
        a[mt][1] = xr[8 * kXStride];
        a[mt][2] = xr[4];
        a[mt][3] = xr[8 * kXStride + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* wr = ws + (ks * 8 + t4) * kWStride + wn * 32 + nt * 8 + g;
        b[nt][0] = wr[0];
        b[nt][1] = wr[4 * kWStride];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + t4 * 2 + (e & 1);
        if (row < m && col < n)
          out[(size_t)row * n + col] =
              from_float<OutT>((float)acc[mt][nt][e] * scale[col] * rs[row]);
      }
    }
  }
}

// ----------------------------------------------------------------- W8A8 wgmma
namespace wg {
constexpr int kCols = 128;          // weight columns a block, 64 a consumer warpgroup
constexpr int kRows = 256;          // activation rows a block: the wgmma's N
constexpr int kTileK = 128;         // k a stage: 128 bytes of a row, 32 word rows
constexpr int kWordRows = kTileK / 4;
constexpr int kStages = 4;
constexpr int kBox = 32;            // weight columns a 128-byte swizzled box
constexpr int kBoxBytes = kWordRows * kBox * 4;      // 4 KB
constexpr int kXBytes = kRows * kTileK;              // 32 KB
constexpr int kWBytes = kCols / kBox * kBoxBytes;    // 16 KB
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kThreads = 256;       // two consumer warpgroups; warp 0 also loads
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kRows * (kCols + 4) * 4 <= kStages * kStageBytes, "epilogue tile");

// The weight column (within its 32-column box) of A-fragment row j (0-15) of
// warp `warp`: the rows take the columns whose 16-byte chunks, swizzled by
// the word rows t4 and t4 + 4 the lanes read, fall in 32 distinct banks.
__device__ __forceinline__ int wg_col(int warp, int j) {
  const int chunk = (warp & 1) * 2 + (j >> 3) + 4 * ((j >> 2) & 1);
  return chunk * 4 + (j & 3);
}
// word (r, c) of a 32 x 32 box in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}
}  // namespace wg

// w_map is the weight's (N, K/4) int32 map, boxes of 32 x 32 words in the
// 128-byte swizzle, when N % 4 == 0 (w_tma); otherwise warp 0 copies the
// words itself, 4 bytes a cp.async.
template <typename OutT>
__global__ void __launch_bounds__(wg::kThreads, 1)
s8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w_map, int w_tma,
                const uint32_t* __restrict__ w, const float* __restrict__ scale,
                const float* __restrict__ rs, OutT* __restrict__ out, int m, int k, int n) {
  using namespace wg;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the 128-byte swizzle; offset from the __shared__ array
  // so that accesses compile to shared-memory loads, not generic ones
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;
  const int kw = k / 4, tiles = (k + kTileK - 1) / kTileK;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA bytes' arrival, and each lane's cp.asyncs where they copy the weights
      mbar_init(&full[s], w_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Warp 0 loads tile t into stage t % kStages, once every warp has released
  // the tile that stage held (kStages tiles before).
  auto produce = [&](int t) {
    const int s = t % kStages;
    if (lane == 0 && t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
    __syncwarp();
    uint8_t* st = smem + s * kStageBytes;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], kXBytes + (w_tma ? kWBytes : 0));
      tma_load_2d(st, &x_map, &full[s], t * kTileK, m0);
      if (w_tma) {
#pragma unroll
        for (int b = 0; b < kCols / kBox; ++b)
          tma_load_2d(st + kXBytes + b * kBoxBytes, &w_map, &full[s], n0 + b * kBox,
                      t * kWordRows);
      }
    }
    if (!w_tma) {  // 32 word rows x 128 columns, into the boxes' swizzled layout
      for (int c = lane; c < kWordRows * kCols; c += 32) {
        const int r = c / kCols, col = c % kCols;
        const int wr = t * kWordRows + r;
        const bool in = wr < kw && n0 + col < n;
        uint32_t* dst = reinterpret_cast<uint32_t*>(st + kXBytes + (col / kBox) * kBoxBytes) +
                        swz(r, col % kBox);
        cp_async4(dst, in ? w + (size_t)wr * n + n0 + col : w, in ? 4 : 0);
      }
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
  const int c_lo = wg_col(warp, g), c_hi = wg_col(warp, g + 8);
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  // A fragments of tile t (rows g, g + 8 of this warp; k 4t4.. and 16 + 4t4..
  // of each 32-k step), once the stage has landed
  auto load_a = [&](uint32_t (&a)[4][4], int t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t* wb =
        reinterpret_cast<const uint32_t*>(smem + s * kStageBytes + kXBytes + box * kBoxBytes);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int r0 = ks * 8 + t4, r1 = r0 + 4;
      a[ks][0] = wb[swz(r0, c_lo)];
      a[ks][1] = wb[swz(r0, c_hi)];
      a[ks][2] = wb[swz(r1, c_lo)];
      a[ks][3] = wb[swz(r1, c_hi)];
    }
  };
  auto issue = [&](uint32_t (&a)[4][4], int t) {
    const uint64_t db = gmma_desc(smem_u32(smem + (t % kStages) * kStageBytes), 16, 8 * 128,
                                  gmma_layout(128));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs_s8_n256(acc, a[ks], db + 2 * ks, 1);  // +32 B of k
    wgmma_commit();
  };
  // tile t's products are done: release its stage, and warp 0 refills it
  // with tile t + kStages once the other warps have released it too
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % kStages]);
    if (loader && t + kStages - 1 < tiles) produce(t + kStages - 1);
  };
  // one tile's products stay in flight while the next tile's fragments load:
  // a0 and a1 alternate, and a buffer is reloaded only after the products
  // that read it have completed
  uint32_t a0[4][4], a1[4][4];
  load_a(a0, 0);
  for (int t = 0; t < tiles; t += 2) {
    issue(a0, t);
    if (t > 0) {
      wgmma_wait<1>();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(a1[ks]);
      release(t - 1);
    }
    if (t + 1 < tiles) {
      load_a(a1, t + 1);
      issue(a1, t + 1);
      wgmma_wait<1>();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(a0[ks]);
      release(t);
      if (t + 2 < tiles) load_a(a0, t + 2);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    fence_regs(a0[ks]);
    fence_regs(a1[ks]);
  }
  release(tiles - 1);

  // epilogue: (float)acc * scale[col] * rs[row], staged row-major in the ring
  __syncthreads();  // both consumer warpgroups are done with the ring
  constexpr int kStride = kCols + 16 / (int)sizeof(OutT);  // padded row, 16-byte aligned
  OutT* tile = reinterpret_cast<OutT*>(smem);
  int cls[2];  // this thread's two columns (fragment rows g and g + 8)
  float csc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cls[h] = cw * 64 + (warp >> 1) * 32 + wg_col(warp, g + 8 * h);
    csc[h] = n0 + cls[h] < n ? scale[n0 + cls[h]] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {  // rows 8c + 2t4 and + 1
    const int rl = c * 8 + t4 * 2;
    const float r0 = m0 + rl < m ? rs[m0 + rl] : 0.f;
    const float r1 = m0 + rl + 1 < m ? rs[m0 + rl + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float v = (float)acc[4 * c + e] * csc[h] * ((e & 1) ? r1 : r0);
      tile[(rl + (e & 1)) * kStride + cls[h]] = from_float<OutT>(v);
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / (int)sizeof(OutT);  // elements a 16-byte store
  constexpr int kChunks = kCols / kVec;
  const bool vec = (n % kVec) == 0;
  for (int c = threadIdx.x; c < kRows * kChunks; c += 256) {
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

template <typename OutT>
cudaError_t launch_s8_wgmma(const int8_t* xq, const uint32_t* w, const float* scale,
                            const float* rs, OutT* out, int m, int k, int n, cudaStream_t s) {
  using namespace wg;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k};
  const cuuint32_t x_box[2] = {kTileK, kRows};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // TMA rows must be 16-byte strided: the weight's when N % 4 == 0
  const int w_tma = (n % 4) == 0;
  const cuuint64_t w_dims[2] = {(cuuint64_t)n, (cuuint64_t)(k / 4)};
  const cuuint64_t w_strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t w_box[2] = {kBox, kWordRows};
  if (w_tma && !encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, w_dims, w_strides,
                           w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  s8_wgmma_kernel<OutT><<<grid, kThreads, kSmem, s>>>(x_map, w_map, w_tma, w, scale, rs, out,
                                                      m, k, n);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------- W8A16
template <typename T>
__global__ void __launch_bounds__(128)
w8a16_kernel(const T* __restrict__ x, const uint32_t* __restrict__ w,
             const float* __restrict__ scale, T* __restrict__ out, int m,
             int kw, int n) {
  const int col = blockIdx.x * 128 + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= n) return;
  const T* xr = x + (size_t)row * kw * 4;
  float acc = 0.f;
  for (int r = 0; r < kw; ++r) {
    const uint32_t word = w[(size_t)r * n + col];
#pragma unroll
    for (int byte = 0; byte < 4; ++byte)
      acc += to_float(xr[4 * r + byte]) *
             (float)(int8_t)((word >> (8 * byte)) & 0xffu);
  }
  out[(size_t)row * n + col] = from_float<T>(acc * scale[col]);
}

template <typename T, WLayout L = WLayout::kWords,
          QuantRule R = QuantRule::kInverse>
cudaError_t launch_w8a8(const void* x, void* xq, void* row_scale, const void* w,
                        const float* scale, void* out, int m, int k, int n,
                        cudaStream_t s) {
  float* rs = static_cast<float*>(row_scale);
  quantize_rows_kernel<T, R><<<m, kQuantThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), rs, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int kw = k / 4;
  const uint32_t* x32 = static_cast<const uint32_t*>(xq);
  T* o = static_cast<T*>(out);
  if (m <= 16) {
    s8_skinny_kernel<T, L><<<(n + kSkinnyN - 1) / kSkinnyN, kSkinnyWarps * 32, 0, s>>>(
        x32, w, scale, rs, o, m, kw, n);
  } else if constexpr (L == WLayout::kWords) {
    return launch_s8_wgmma<T>(static_cast<const int8_t*>(xq), static_cast<const uint32_t*>(w),
                              scale, rs, o, m, k, n, s);
  } else {
    dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
    s8_tiled_kernel<T, L><<<grid, 128, 0, s>>>(x32, w, scale, rs, o, m, kw, n);
  }
  return cudaGetLastError();
}

}  // namespace

// W8A8: x (M, K) bf16 (x_bf16 = 1) or f32; xq (M, K) int8 and row_scale
// (M,) f32 are scratch the activation quantization fills; w (K/4, N) int32
// packed by pack_int8_rows, scale (N,) f32; out (M, N) in x's dtype. K must be
// a multiple of 64.
extern "C" int mmor_int8_matmul_w8a8(const void* x, void* xq, void* row_scale,
                                     const void* w, const void* scale, void* out,
                                     int m, int k, int n, int x_bf16,
                                     void* stream) {
  if (k % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return x_bf16 ? (int)launch_w8a8<__nv_bfloat16>(x, xq, row_scale, w, sc, out, m, k, n, s)
                : (int)launch_w8a8<float>(x, xq, row_scale, w, sc, out, m, k, n, s);
}

// K8, W8A8 on an unpacked weight: x (M, K) bf16 (x_bf16 = 1) or f32; xq
// (M, K) int8 and row_scale (M,) f32 are scratch the activation quantization
// (x / row_scale in f32) fills; w (K, N) int8 row-major, scale (N,) f32; out
// (M, N) in x's dtype. K must be a multiple of 64.
extern "C" int mmor_int8_matmul_bytes(const void* x, void* xq, void* row_scale,
                                      const void* w, const void* scale, void* out,
                                      int m, int k, int n, int x_bf16, void* stream) {
  if (k % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  constexpr WLayout L = WLayout::kBytes;
  constexpr QuantRule R = QuantRule::kDivide;
  return x_bf16
             ? (int)launch_w8a8<__nv_bfloat16, L, R>(x, xq, row_scale, w, sc, out, m, k, n, s)
             : (int)launch_w8a8<float, L, R>(x, xq, row_scale, w, sc, out, m, k, n, s);
}

// K10c mxu8, W8A8 on packed words with K8's activation rule: x (M, K) bf16
// (x_bf16 = 1) or f32; xq, row_scale as above (filled by x / row_scale in
// f32); w (K/4, N) int32 packed by pack_int8_rows, scale (N,) f32; out (M, N)
// in x's dtype. K must be a multiple of 64.
extern "C" int mmor_int8_matmul_w8b(const void* x, void* xq, void* row_scale, const void* w,
                                    const void* scale, void* out, int m, int k, int n,
                                    int x_bf16, void* stream) {
  if (k % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  constexpr WLayout L = WLayout::kWords;
  constexpr QuantRule R = QuantRule::kDivide;
  return x_bf16
             ? (int)launch_w8a8<__nv_bfloat16, L, R>(x, xq, row_scale, w, sc, out, m, k, n, s)
             : (int)launch_w8a8<float, L, R>(x, xq, row_scale, w, sc, out, m, k, n, s);
}

// W8A16: x (M, K) bf16 (x_bf16 = 1) or f32, w and scale as above, out (M, N)
// in x's dtype. K must be a multiple of 4.
extern "C" int mmor_int8_matmul_w8a16(const void* x, const void* w,
                                      const void* scale, void* out, int m,
                                      int k, int n, int x_bf16, void* stream) {
  if (k % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + 127) / 128, m);
  const uint32_t* w32 = static_cast<const uint32_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (x_bf16)
    w8a16_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w32, sc,
        static_cast<__nv_bfloat16*>(out), m, k / 4, n);
  else
    w8a16_kernel<float><<<grid, 128, 0, s>>>(static_cast<const float*>(x), w32,
                                             sc, static_cast<float*>(out), m,
                                             k / 4, n);
  return (int)cudaGetLastError();
}
