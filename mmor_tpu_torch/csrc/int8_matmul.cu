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
//    * skinny kernel (M <= 16, decode; packed words only): one 16-row
//      m-tile; a block of eight warps covers 32 columns and splits K
//      between its warps, so a 4096 column weight spreads over 128 blocks;
//      operands load straight from device memory (each weight word is used
//      once), four k-steps of loads in flight per warp before their
//      products, and the warps' partial sums meet in shared memory. The mma
//      takes any 8 columns in its n slots, so lane group g owns the four
//      neighbouring columns 4g..4g+3 of the block, one in each 8-column mma
//      tile, and fetches their words of a word row at once
//      (weight_words.cuh's w_words4).
//    * stream kernel (M <= 16 on K8's byte layout): see below.
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
//  - K8 takes the activation rule QuantRule::kDivide (x / row_scale in f32,
//    K8's quantized_matmul.py:81-84) and the unpacked (K, N) int8 weight
//    (WLayout::kBytes); its epilogue is K2's, in JAX's order. At M > 16 it
//    is the tiled kernel with a byte-layout loader. At M <= 16 (the decode
//    shape the perf tools time: 16 x 4096 x 11264) it streams 46 MB of
//    weight bytes for 16 multiply-adds a byte, so device-memory bytes bound
//    it. Its first form was the skinny kernel with a byte loader: four
//    4-byte loads a thread a k-step (a warp load moved 128 bytes), 32
//    column strips 8 warps apart in K, and the quantize kernel exposed
//    before it: 0.92 TB/s. The stream kernel instead:
//    * gives a block a strip of 128 columns (128 bytes of each row) over
//      all of K. Warp 0 keeps a ring of 6 stages of 128 rows (16 KB) full
//      with one TMA box a stage in the 128-byte swizzle (cp.async of 4
//      bytes, or plain byte loads, where N % 16 != 0 and TMA cannot
//      describe the rows), 96 KB in flight a block, paced by mbarriers;
//      88 blocks walk the rows of the weight together. Splitting K (2 or
//      3 ranks a strip, every SM busy, the sums folded through an L2
//      workspace) was slower on the card, with or without the products;
//    * has 4 consumer warps take 32 rows of each stage: a lane loads 16
//      bytes of each of 8 rows (its 16 columns) from the swizzled stage
//      without bank conflicts, transposes them into 32 mma words with
//      __byte_perm and runs 16 mma.sync.m16n8k32.s8 (wgmma's 8-bit form
//      needs both operands K-major, and this weight is N-major); at 16
//      multiply-adds a byte the tensor cores stay far from their limit;
//    * quantizes x in a kernel of its own (one block a row, the row held in
//      registers between its amax and its quantization, stored in the k
//      order the A registers want, see mma_order), launched before the
//      product with programmatic dependent launch: the product's blocks
//      start while it runs, issue their first weight tiles, and wait
//      (griddepcontrol.wait) only before the activation tiles. Quantizing
//      inside every product block was twice as slow: each block repeats
//      all the rows' divisions;
//    * folds its warps' s32 sums through shared memory (exact, so the
//      result is the plain version's bit for bit) and applies acc *
//      scale[col] * rs[row].
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

template <typename OutT>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
s8_skinny_kernel(const uint32_t* __restrict__ xq, const void* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ rs,
                 OutT* __restrict__ out, int m, int kw, int n) {
  constexpr WLayout L = WLayout::kWords;  // K2's and K10c's packed words
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

// --------------------------------------------- W8A8 skinny, byte weight (K8)
namespace sk {
constexpr int kCols = 128;                // weight columns a block: a 128-byte strip of each row
constexpr int kConsumers = 4;             // consumer warps, 32 k rows of each tile apiece
constexpr int kTileK = 32 * kConsumers;   // k rows a tile
constexpr int kStages = 6;
constexpr int kWBytes = kTileK * kCols;   // 16 KB: one TMA box
constexpr int kXBytes = 16 * kTileK;      // 2 KB: the 16 activation rows' k
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kThreads = 32 * (1 + kConsumers);  // warp 0 loads
constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kConsumers * 16 * kCols * 4 <= kStages * kStageBytes, "fold buffer");

// byte (r, c) of a tile of 128-byte rows in the 128-byte swizzle (TMA's:
// the 16-byte chunk index XOR the row mod 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}
__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}
// int (row, col) of a consumer warp's 16 x 128 partial tile: columns XOR
// (row, col bits 5-6) in bits 0-4, so that both the fragments' stores and
// the fold's row-wise reads hit 32 banks
__device__ __forceinline__ int red_at(int row, int col) {
  return row * kCols + (col ^ ((row & 7) | (((col >> 5) & 3) << 3)));
}

// The product reads its A registers from xq rows whose k are reordered
// within each 32: k = 16h + 8a + 2t + b (h, a, b in {0, 1}, t in 0..3) is
// stored at 16h + 4t + 2a + b, so that the four bytes at 4t.. are the k of
// the weight rows a lane's 16-byte shared-memory loads gather (below).
__device__ __forceinline__ int mma_order(int k) {
  return (k & ~15) | (((k >> 1) & 3) << 2) | (((k >> 3) & 1) << 1) | (k & 1);
}

// 8 activations of 16 bytes of a row, in f32 (bf16 x: 8 values; f32 x: the
// first 4 of two loads)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w = word_of(u, q);
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
}  // namespace sk

// K8's activation rows (quantize_rows_kernel's kDivide rule: x / scale in
// f32, rounded half to even, clipped to +-127), one block a row, each
// thread 16 neighbouring k a pass held in registers between the row's amax
// and its quantization, stored as one 16-byte chunk in mma_order. The
// product launched after it may start at once (programmatic dependent
// launch).
constexpr int kQuantK = 16;
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_mma_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ row_scale, int k) {
  using namespace sk;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float red[kQuantThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * k;
  int8_t* qr = xq + (size_t)blockIdx.x * k;
  const int passes = (k + kQuantThreads * kQuantK - 1) / (kQuantThreads * kQuantK);
  // pass ps: this thread's k i.. i + 15 of the row, zeros past its end
  auto load = [&](int ps, float (&u)[kQuantK]) {
    const int i = (ps * kQuantThreads + threadIdx.x) * kQuantK;
    float lo[8], hi[8];
    if (i < k) {
      load8(xr + i, lo);
      load8(xr + i + 8, hi);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      u[e] = i < k ? lo[e] : 0.f;
      u[8 + e] = i < k ? hi[e] : 0.f;
    }
  };
  // k i + e goes to byte mma_order(e) of the 16 (i is a multiple of 16)
  auto store = [&](int ps, const float (&u)[kQuantK], float scale) {
    const int i = (ps * kQuantThreads + threadIdx.x) * kQuantK;
    if (i >= k) return;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kQuantK; ++e) {
      const int pos = mma_order(e);
      const uint32_t b = (uint32_t)(int)fminf(fmaxf(rintf(u[e] / scale), -127.f), 127.f) & 0xffu;
      q[pos >> 2] |= b << (8 * (pos & 3));
    }
    *reinterpret_cast<uint4*>(qr + i) = make_uint4(q[0], q[1], q[2], q[3]);
  };
  constexpr int kHeld = 2;  // passes held in registers (K <= 8192); later ones read x again
  float v[kHeld][kQuantK];
  float amax = 0.f;
#pragma unroll
  for (int ps = 0; ps < kHeld; ++ps) {
    load(ps, v[ps]);
#pragma unroll
    for (int e = 0; e < kQuantK; ++e) amax = fmaxf(amax, fabsf(v[ps][e]));
  }
  for (int ps = kHeld; ps < passes; ++ps) {
    float u[kQuantK];
    load(ps, u);
#pragma unroll
    for (int e = 0; e < kQuantK; ++e) amax = fmaxf(amax, fabsf(u[e]));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? amax / 127.f : 1.f;
  if (threadIdx.x == 0) row_scale[blockIdx.x] = scale;
#pragma unroll
  for (int ps = 0; ps < kHeld; ++ps) store(ps, v[ps], scale);
  for (int ps = kHeld; ps < passes; ++ps) {
    float u[kQuantK];
    load(ps, u);
    store(ps, u, scale);
  }
}

// Block `strip` multiplies weight columns 128 strip.. over every k tile of
// 128 rows. w_map is the (K, N) byte weight, boxes of 128 rows x 128 bytes
// in the 128-byte swizzle, when N % 16 == 0 (w_tma); otherwise warp 0 copies
// the bytes itself. x_map is xq (M, K) in mma_order, boxes of 16 rows x 128
// bytes.
template <typename OutT>
__global__ void __launch_bounds__(sk::kThreads, 1)
s8_stream_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map, int w_tma,
                 const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ rs, OutT* __restrict__ out, int m, int k, int n) {
  using namespace sk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kCols;
  const int nt = (k + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA bytes' arrival, and each lane's where warp 0 copies the weights
      mbar_init(&full[s], w_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int acc[16][4] = {};
  if (warp == 0) {
    // ------------------------------------------------------------ producer
    // weight tile i into stage i % kStages, once the consumers have
    // released the tile that stage held
    auto load_w = [&](int i) {
      const int s = i % kStages;
      if (lane == 0 && i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      __syncwarp();
      uint8_t* st = smem + s * kStageBytes;
      const int r0 = i * kTileK;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], kXBytes + (w_tma ? kWBytes : 0));
        if (w_tma) tma_load_2d(st, &w_map, &full[s], n0, r0);
      }
      if (w_tma) return;
      // 4 bytes a copy, lanes along the row: by cp.async where N % 4 == 0,
      // else byte by byte
      for (int c = lane; c < kTileK * kCols / 4; c += 32) {
        const int r = c / (kCols / 4), cb = (c % (kCols / 4)) * 4;
        const int row = r0 + r, col = n0 + cb;
        uint8_t* dst = st + swz(r, cb);
        const uint8_t* src = w + (size_t)row * n + col;
        if (n % 4 == 0) {
          const bool in = row < k && col < n;
          cp_async4(dst, in ? src : w, in ? 4 : 0);
        } else {
          uint32_t v = 0;
          for (int e = 0; e < 4; ++e)
            if (row < k && col + e < n) v |= (uint32_t)src[e] << (8 * e);
          *reinterpret_cast<uint32_t*>(dst) = v;
        }
      }
      if (n % 4 == 0) cp_async_arrive(&full[s]);
      else mbar_arrive(&full[s]);
    };
    auto load_x = [&](int i) {
      if (lane == 0)
        tma_load_2d(smem + (i % kStages) * kStageBytes + kWBytes, &x_map, &full[i % kStages],
                    i * kTileK, 0);
    };
    // the weight tiles that fit go out while the quantize kernel runs; the
    // activation tiles once it has finished
    const int pre = nt < kStages ? nt : kStages;
    for (int i = 0; i < pre; ++i) load_w(i);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < pre; ++i) load_x(i);
    for (int i = pre; i < nt; ++i) {
      load_w(i);
      load_x(i);
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Consumer c takes k rows 32c.. of each tile: one m16n8k32 step. Lane
    // (g, t4) loads 16 bytes (columns 16g..16g+15) of each of its 8 rows
    // 2t4 + {0, 1, 8, 9, 16, 17, 24, 25}: in a quarter warp the rows' swizzle
    // (2t4 + 0 or 1) and the lanes' chunks g meet 8 distinct bank groups.
    // Rows 0-3 of those are B register 0 of 16 products and rows 4-7
    // register 1, transposed from the 16-byte loads by __byte_perm: product
    // j takes column 16g + j in its n slot g. xq's mma_order puts the same k
    // in the A registers' bytes.
    const int c = warp - 1, g = lane / 4, t4 = lane % 4;
    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* st = smem + s * kStageBytes;
      const uint8_t* xs = st + kWBytes;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xs + swz(g, 32 * c + 4 * t4));
      a[1] = *reinterpret_cast<const uint32_t*>(xs + swz(g + 8, 32 * c + 4 * t4));
      a[2] = *reinterpret_cast<const uint32_t*>(xs + swz(g, 32 * c + 16 + 4 * t4));
      a[3] = *reinterpret_cast<const uint32_t*>(xs + swz(g + 8, 32 * c + 16 + 4 * t4));
      uint4 rw[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rw[j] = *reinterpret_cast<const uint4*>(
            st + swz(32 * c + 2 * t4 + (j & 1) + 8 * (j >> 1), 16 * g));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the tile's bytes are in registers
      uint32_t b[16][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // columns 16g + 4q .. + 3: byte e of row i to byte i of word e
          const uint32_t r0 = word_of(rw[4 * h], q), r1 = word_of(rw[4 * h + 1], q);
          const uint32_t r2 = word_of(rw[4 * h + 2], q), r3 = word_of(rw[4 * h + 3], q);
          const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
          const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
          const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
          const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
          b[4 * q][h] = __byte_perm(lo01, lo23, 0x5410);
          b[4 * q + 1][h] = __byte_perm(lo01, lo23, 0x7632);
          b[4 * q + 2][h] = __byte_perm(hi01, hi23, 0x5410);
          b[4 * q + 3][h] = __byte_perm(hi01, hi23, 0x7632);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) mma_s8(acc[j], a, b[j]);
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // rs is the quantize kernel's

  // the consumers' partial tiles meet in shared memory (the ring is idle:
  // every tile has been consumed), then acc * scale[col] * rs[row]
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
  if (warp > 0) {
    const int c = warp - 1, g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[c * 16 * kCols + red_at(g + 8 * (e >> 1), 16 * (2 * t4 + (e & 1)) + j)] = acc[j][e];
  }
  __syncthreads();
  const int rows = m < 16 ? m : 16;
  for (int o = threadIdx.x; o < rows * kCols; o += kThreads) {
    const int row = o / kCols, cl = o % kCols, col = n0 + cl;
    if (col >= n) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) sum += red[w * 16 * kCols + red_at(row, cl)];
    out[(size_t)row * n + col] = from_float<OutT>((float)sum * scale[col] * rs[row]);
  }
}

template <typename T>
cudaError_t launch_s8_stream(const T* x, int8_t* xq, float* rs, const uint8_t* w,
                             const float* scale, T* out, int m, int k, int n, cudaStream_t s) {
  using namespace sk;
  if (m > 16) return cudaErrorInvalidValue;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k};
  const cuuint32_t x_box[2] = {kTileK, 16};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // TMA rows must be 16-byte strided: the weight's when N % 16 == 0
  const int w_tma = (n % 16) == 0;
  const cuuint64_t w_dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t w_strides[1] = {(cuuint64_t)n};
  const cuuint32_t w_box[2] = {kCols, kTileK};
  if (w_tma && !encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims, w_strides,
                           w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  quantize_mma_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(x, xq, rs, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the product may start while the quantize kernel runs and issue its
  // first weight tiles; it reads xq and rs only after griddepcontrol.wait
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kCols - 1) / kCols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, s8_stream_kernel<T>, x_map, w_map, w_tma, w, scale,
                            static_cast<const float*>(rs), out, m, k, n);
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
  if constexpr (L == WLayout::kWords) {
    if (m > 16)
      return launch_s8_wgmma<T>(static_cast<const int8_t*>(xq),
                                static_cast<const uint32_t*>(w), scale, rs, o, m, k, n, s);
    s8_skinny_kernel<T><<<(n + kSkinnyN - 1) / kSkinnyN, kSkinnyWarps * 32, 0, s>>>(
        x32, w, scale, rs, o, m, kw, n);
  } else {  // K8 at M > 16 (at M <= 16 it is launch_s8_stream)
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
  if (m <= 16) {
    using bf16 = __nv_bfloat16;
    int8_t* q = static_cast<int8_t*>(xq);
    float* rs = static_cast<float*>(row_scale);
    const uint8_t* w8 = static_cast<const uint8_t*>(w);
    return x_bf16 ? (int)launch_s8_stream<bf16>(static_cast<const bf16*>(x), q, rs, w8, sc,
                                                 static_cast<bf16*>(out), m, k, n, s)
                  : (int)launch_s8_stream<float>(static_cast<const float*>(x), q, rs, w8, sc,
                                                 static_cast<float*>(out), m, k, n, s);
  }
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
