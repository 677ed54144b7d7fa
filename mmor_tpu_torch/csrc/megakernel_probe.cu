// K10e: the kernels of the megakernel design probes
// (tools/perf/bench_megakernel_probe.py): the x-read product (W8A8 or W8A16
// on K2's packed words, x held in shared memory or read from L2), the tiny
// identity kernel of the launch-overhead probe, the int4 nibble stream
// (W4A16) and the row read/write probe (a decode-attention matvec over a KV
// block, one output row written at a dynamic index).
//
// Replaces tools/perf/bench_megakernel_probe.py: _kern_stack (once_b, the
// pl.pallas_call at :146), _kern_dslice (once_c, :168), _kern_tiny (call,
// :199), _kern_nib (nibble_part's once, :288) and _kern_rowrw (rowrw_part's
// once, :359).
//
// What bounds them on the H100: device-memory bytes. The x-read and nibble
// products stream 46.1 and 23.1 MB of weights for 32 rows (a few
// multiply-adds a byte), the row probe 100.7 MB of keys for one query row a
// block; the tiny kernel moves 16 KB and measures a launch's fixed cost.
//
// x-read product (lines b and c): out = (sum over K-tiles, in order, of each
// tile's product as f32) * scale, in bf16, the TPU kernels' numerics: an int8
// tile's exact int32 sum cast to f32, a bf16 tile's taken in f32.
//
// int8 x (the probe's path), xr::xread_stream_kernel. Its first form was an
// int8 branch of probe_kernel below: a block of eight warps on 32-column
// units fetching the words with 16-byte loads, four k-steps in flight, at
// 41% (b) and 44% (c) of the byte bound; each of its 352 unit walks read
// all of x again. This kernel is K2's W8A8 word stream (int8_matmul.cu's
// s8_word_stream_kernel) widened to 32 x rows and 96 columns:
//  - a block owns 96 columns (3 TMA boxes of 32 word columns) of one 32-row
//    group over all of K: 118 blocks at 11264 columns, one an SM, so x is
//    read from L2 118 times a call, not 352;
//  - warp 0 keeps a ring of stages full by TMA: up to 128 word rows of each
//    box (the largest of 128, 64, 32, 16 dividing a K-tile's CK / 4 rows, so
//    a stage never spans two tiles; 128-byte swizzle), as many stages as fit
//    (3); each stage is released through hopper.cuh's release_stage. The
//    words load under L2's evict-first policy, so that x, which every block
//    reads, stays in L2 (a few percent faster on an H100 than without);
//  - where x comes from keeps the question each line asks. b, the (n_k, mpad,
//    CK) tile stack: warp 1 copies a block's K-tile of its 32 rows (64 KB at
//    CK 2048) by TMA into shared memory once, where it stays for the tile's
//    stages, and loads the next tile once the consumers have released it
//    (the word ring runs on meanwhile). c, the (mpad, K) array: each stage
//    carries, by TMA, the x columns its word rows meet (128-column boxes of
//    32 rows), so x is read from L2 once a block, a stage at a time. No
//    wrapper copy in either;
//  - the product is taken transposed, W^T x^T, on mma.m16n8k32.s8: a word (4
//    k of one column) is an A register as it lies in the stage, and the 32 x
//    rows are four n-tiles. Lane (g, t4) loads the 16-byte chunk g (columns
//    4g .. 4g + 3: m-tile 0's fragment rows g, g + 8 the first two, m-tile
//    1's the last two) of word rows 2t4 and 2t4 + 1 of each 8-row k-step,
//    whose swizzled places are 8 distinct chunks in each quarter warp, and
//    the 8 bytes of x those two rows meet (slots 4t4.. take row 2t4, slots
//    16 + 4t4.. row 2t4 + 1); n-tile column g is x row rho(g) = 2(g % 4) +
//    g / 4 of its 8, so that a half warp's x loads fall in 8 distinct
//    chunks;
//  - twelve consumer warps, four a box, split each stage's k-steps; at each
//    K-tile's end their int32 sums meet exactly in shared memory (integer
//    atomics: any order), each tile's sum is cast to f32 and added to the
//    f32 totals in tile order, and out = total * scale rounds to bf16 once:
//    bit for bit with the plain version, as the TPU's int32 dot cast to f32;
//  - launched with programmatic dependent launch: the first stages' words
//    load while the kernel before still runs (the words and scales must not
//    be its output); x only after griddepcontrol.wait.
//
// bf16 x (off the probe's path), probe_kernel, the first form: a block of
// eight warps owns 32 rows (two m-tiles) and works on units of 32 columns: lane
// group g owns columns 4g..4g+3 of a unit, one in each 8-column mma tile, so
// one 16-byte load fetches a thread's weight words of a word row
// (weight_words.cuh); the warps split each tile's k-steps, four steps of
// loads in flight before their products (mma.sync.m16n8k16 bf16), and meet
// in shared memory once a tile, where each thread folds four outputs' warp
// sums (f32, warp order) into their f32 tile sums. Each thread's A registers
// take the x of the k its B words hold: one 8-byte load a row. Where x comes
// from (XSrc):
//  - kSmem (b): x is the (n_k, mpad, CK) stack; the grid is as many blocks
//    as fit on the card, each walking its units with the tile loop
//    outermost, so a block copies each K-tile of its 32 rows into shared
//    memory once (128 KB: the whole 256 KB x would not fit a block's 227
//    KB, a tile does) and keeps its units' f32 sums in shared memory;
//  - kGlobal2D (c): x is the (mpad, K) array; a block a unit, each warp
//    loading its A fragments from device memory (L2) at every k-step.
//
// Nibble stream (W4A16): the words are tools/perf/bench_megakernel_probe.py's
// pack_int4_rows (nibble i of word r is row 8r + i, signed), x the (n_k,
// mpad, CK) stack with each chunk's columns [even rows | odd rows]; out =
// (sum over chunks of xe . lo + xo . hi in f32) * scale, in bf16. Its first
// form was the probe kernel above with x read as kGlobal2D reads, at 16% of
// the byte bound: each 32-column block's warps read all of x from L2 at
// every k-step (90 MB a call for 23 MB of words), each value went through a
// shift pair and an I2F (about 12 us a call at 16 a clock an SM, against a
// 7.2 us bound), and the products shared the conversion warps' issue with
// four steps of loads in flight. This kernel:
//  - gives a block 96 columns (3 TMA boxes of 32 word columns) of one
//    32-row group over all of K (118 blocks at 11264 columns, one an SM);
//  - streams the words through a ring of 4 stages of up to 64 word rows (512
//    k) that warp 0 keeps full with TMA, and with each stage, by TMA from the
//    stack, the x those rows meet: for each group of 16 word rows its
//    chunk's even and odd halves' 64 columns (boxes of 32 rows x 128 bytes;
//    a stage never spans two chunks, its rows dividing the chunk's), so x
//    is read from L2 once a block. All of it in the 128-byte swizzle: boxes
//    of 64-byte rows (8 word rows a box) held the ring to TMA's request rate;
//    launched with programmatic dependent launch, its first stages' words
//    load while the kernel before still runs;
//  - takes the product transposed, W^T x^T, on mma.m16n8k16 bf16 with the 32
//    x rows as four n-tiles: a k-step's slots are the even (or odd) nibbles
//    of four word rows, one a thread quad lane, so a B pair is x at two
//    neighbouring columns of the chunk's even (or odd) half and an A pair
//    two nibbles of one word, the TPU kernel's xe . lo + xo . hi. Lane (g,
//    t4) reads its 16-byte chunk g (4 columns) of word rows s ^ j of each
//    group, s = {0, 10, 4, 14}[t4], j = 0 .. 3, and one 16-byte chunk of
//    x for each pair of rows: the swizzled chunks of a quarter warp's
//    loads, words and x alike, are then 8 distinct ones;
//  - converts without I2F: a byte permute sets two nibbles of a word side by
//    side, one LOP3 masks them, flips their sign bit (s becomes s + 8) and
//    ORs them into the bf16 128.0, one bf16 pair subtract of 136 gives s
//    (exact; bf16_mma.cuh's nibble_pair_bf16x2);
//  - each warp's f32 sums run through the chunks in order; the 12 warps'
//    sums meet in shared memory, out = sum * scale in f32, rounded to bf16
//    once.
//
// Row probe: grid (S programs, T / 128); a block's 8 warps split the G
// heads and its 32 lanes four columns each (one 16-byte load of a key word
// row); key bytes convert to f32 exactly by a byte permute into 2^23 + b
// (no int-to-float conversion instruction); a head's dot is summed in f32
// over its 128 rows, the heads added in f32. Every block writes its
// columns of the full (S, T) acc; block (s, 0) writes the output row.
// The TPU grid runs in order, so in static mode every program's write of
// row [0, 0] leaves the last program's; here block (S - 1, 0) writes it on
// purpose, and blocks (s, 0), s > 0, write row s as zeros, the port's
// definition of the rows the TPU left undefined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "w4a8.cuh"  // mma_s8
#include "weight_words.cuh"

namespace {

enum class XSrc { kSmem, kGlobal2D };

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;  // rows a block
constexpr int kCols = 32;  // columns a unit
constexpr int kUnroll = 4;
constexpr int kStage = 8;  // 16-byte loads a thread has in flight while staging x
constexpr int kPadBytes = 32;  // a staged x row's padding: conflict-free 8-byte loads
constexpr int kRedStride = kCols + 1;  // a warp-partial row: conflict-free stores
constexpr size_t kRedBytes = (size_t)kWarps * kRows * kRedStride * 4;
constexpr size_t kUnitBytes = (size_t)kRows * kCols * 4;

struct ProbeArgs {
  const unsigned char* x;
  const void* w;
  const float* scale;
  __nv_bfloat16* out;
  int mpad, k, n, ck, units, upb;
};

// a k-step's (16 k) operands of one thread: weight words of its four
// columns, and bf16 x of its 4 rows (m-tile mt, half h: rows 16mt + g + 8h)
struct Frag {
  uint4 w;
  uint2 x[2][2];  // [mt][h]
};

__device__ __forceinline__ uint2 load8(const unsigned char* p, bool live) {
  return live ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
}

// the address of x element (row, tile kk, tile-local k lk) for each source
// (row is the block-local row for kSmem, the global row otherwise)
template <XSrc X>
__device__ __forceinline__ const unsigned char* x_at(const ProbeArgs& p,
                                                     const unsigned char* xs, int row, int kk,
                                                     int lk) {
  if constexpr (X == XSrc::kSmem) {
    return xs + (size_t)row * (p.ck * 2 + kPadBytes) + (size_t)lk * 2;
  } else {
    return p.x + ((size_t)row * p.k + (size_t)kk * p.ck + lk) * 2;
  }
}

template <XSrc X>
__device__ __forceinline__ void load_step(Frag& f, const ProbeArgs& p, const unsigned char* xs,
                                          int kk, int s, int col0, int r0, int g, int t4) {
  // word row wr: tile-local k 16s + 4t4 .. + 3
  const int wr = (kk * p.ck + 16 * s) / 4 + t4;
  f.w = w_words4<WLayout::kWords>(p.w, wr, col0, p.n);
  const int lk = 16 * s + 4 * t4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int local = 16 * mt + g + 8 * h;  // x rows: global (kGlobal2D) or block-local (kSmem)
      const bool live = X == XSrc::kSmem || r0 + local < p.mpad;
      f.x[mt][h] = load8(x_at<X>(p, xs, X == XSrc::kSmem ? local : r0 + local, kk, lk), live);
    }
}

__device__ __forceinline__ int s8_byte(uint32_t w, int i) { return (int)(int8_t)(w >> (8 * i)); }

__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const Frag& f) {
  const uint32_t w0[4] = {f.w.x, f.w.y, f.w.z, f.w.w};
  uint32_t b[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {  // values 0..3: k 4t4 .. 4t4 + 3
    const uint32_t w = w0[nt];
    b[nt][0] = pair(bf16_bits(s8_byte(w, 0)), bf16_bits(s8_byte(w, 1)));
    b[nt][1] = pair(bf16_bits(s8_byte(w, 2)), bf16_bits(s8_byte(w, 3)));
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint32_t a[4] = {f.x[mt][0].x, f.x[mt][1].x, f.x[mt][0].y, f.x[mt][1].y};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
  }
}

// bf16 x. grid (blocks, ceil(mpad / 32)); dynamic shared memory: [the staged
// x tile (kSmem)] [warp partials 8 x 32 x 33] [f32 sums, upb units x 32 x 32]
template <XSrc X>
__global__ void __launch_bounds__(kThreads) probe_kernel(ProbeArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t xs_bytes = X == XSrc::kSmem ? (size_t)kRows * (p.ck * 2 + kPadBytes) : 0;
  const unsigned char* xs = smem;
  float* red = reinterpret_cast<float*>(smem + xs_bytes);
  float* sums = reinterpret_cast<float*>(smem + xs_bytes + kRedBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = blockIdx.y * kRows;
  const int n_k = p.k / p.ck, steps = p.ck / 16;
  for (int i = threadIdx.x; i < p.upb * kRows * kCols; i += kThreads) sums[i] = 0.f;

  for (int kk = 0; kk < n_k; ++kk) {
    if constexpr (X == XSrc::kSmem) {  // this tile of the block's rows, once
      __syncthreads();
      const int chunks = p.ck * 2 / 16, total = kRows * chunks;
      for (int i0 = threadIdx.x; i0 < total; i0 += kStage * kThreads) {
        uint4 v[kStage];  // a thread's loads in flight together
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads, r = i / chunks;
          v[u] = i < total && r0 + r < p.mpad
                     ? reinterpret_cast<const uint4*>(
                           p.x + ((size_t)kk * p.mpad + r0 + r) * p.ck * 2)[i % chunks]
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kStage; ++u) {
          const int i = i0 + u * kThreads;
          if (i < total)
            *reinterpret_cast<uint4*>(smem + (size_t)(i / chunks) * (p.ck * 2 + kPadBytes) +
                                      16 * (i % chunks)) = v[u];
        }
      }
      __syncthreads();
    }
    for (int ui = 0; ui < p.upb; ++ui) {
      const int unit = blockIdx.x + ui * gridDim.x;
      if (unit >= p.units) break;
      const int col0 = unit * kCols + 4 * g;
      float acc[2][4][4] = {};
      for (int s0 = warp * kUnroll; s0 < steps; s0 += kWarps * kUnroll) {
        Frag f[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (s0 + u < steps) {
            load_step<X>(f[u], p, xs, kk, s0 + u, col0, r0, g, t4);
          } else {
            f[u] = Frag{};
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) mma_step(acc, f[u]);
      }
      // accumulator e of tile (mt, nt): row 16mt + g + 8(e / 2), unit
      // column 4(2t4 + e % 2) + nt
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(warp * kRows + 16 * mt + g + 8 * (e >> 1)) * kRedStride +
                4 * (2 * t4 + (e & 1)) + nt] = acc[mt][nt][e];
      __syncthreads();
      for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
        float tile = 0.f;
        for (int wi = 0; wi < kWarps; ++wi)
          tile += red[(wi * kRows + o / kCols) * kRedStride + o % kCols];
        sums[ui * kRows * kCols + o] += tile;
      }
      __syncthreads();
    }
  }
  for (int ui = 0; ui < p.upb; ++ui) {
    const int unit = blockIdx.x + ui * gridDim.x;
    if (unit >= p.units) break;
    for (int o = threadIdx.x; o < kRows * kCols; o += kThreads) {
      const int row = r0 + o / kCols, col = unit * kCols + o % kCols;
      if (row < p.mpad)
        p.out[(size_t)row * p.n + col] =
            __float2bfloat16_rn(sums[ui * kRows * kCols + o] * p.scale[col]);
    }
  }
}

template <XSrc X>
int launch_probe(const void* x, const void* w, const void* scale, void* out, int mpad, int k,
                 int n, int ck, void* stream) {
  if (mpad < 1 || ck < 64 || ck % 64 || k % ck || n < kCols || n % kCols)
    return (int)cudaErrorInvalidValue;
  ProbeArgs p{static_cast<const unsigned char*>(x), w, static_cast<const float*>(scale),
              static_cast<__nv_bfloat16*>(out), mpad, k, n, ck, n / kCols, 1};
  int grid = p.units;
  size_t smem = kRedBytes + kUnitBytes;
  if constexpr (X == XSrc::kSmem) {
    // as many blocks as fit on the card, each with its units' sums
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int upb_max = (p.units + sms - 1) / sms;
    smem = (size_t)kRows * (ck * 2 + kPadBytes) + kRedBytes + upb_max * kUnitBytes;
    e = cudaFuncSetAttribute(probe_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel<X>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = p.units < per_sm * sms ? p.units : per_sm * sms;
    p.upb = (p.units + grid - 1) / grid;
  }
  probe_kernel<X><<<dim3(grid, (mpad + kRows - 1) / kRows), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- x-read word stream (int8 x)
namespace xr {
constexpr int kBoxCols = 32;                     // word columns a TMA box: 128 bytes a word row
constexpr int kBoxes = 3;                        // boxes a block: 96 columns
constexpr int kCols = kBoxes * kBoxCols;
constexpr int kParts = 4;                        // consumer warps a box
constexpr int kConsumers = kBoxes * kParts;
constexpr int kThreads = 32 * (2 + kConsumers);  // warp 0 streams the words, warp 1 x's tiles (b)
constexpr int kXRows = 32;                       // x rows a block: four 8-row n-tiles
constexpr int kMaxRows = 128;                    // word rows a stage, at most (512 k)
constexpr int kWBoxBytes = kMaxRows * kBoxCols * 4;  // 16 KB
constexpr int kWBytes = kBoxes * kWBoxBytes;         // 48 KB
constexpr int kXBoxBytes = kXRows * 128;             // 128 k of the block's 32 rows: 4 KB
constexpr int kTSumBytes = kXRows * kCols * 4;       // a K-tile's int32 sums: 12 KB
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024;
static_assert(kXRows * kCols % (32 * kConsumers) == 0, "whole outputs a consumer thread");

// a stage's bytes: its word boxes, and in c the x boxes its rows meet
template <bool kStack>
__host__ __device__ constexpr int stage_bytes() {
  return kWBytes + (kStack ? 0 : kMaxRows * 4 / 128 * kXBoxBytes);
}

// n-tile column g's x row within its 8: a half warp's 8-byte x loads (rows
// rho(0..3) = 0, 2, 4, 6 or rho(4..7) = 1, 3, 5, 7) then fall in 8 distinct
// swizzled chunks
__device__ __forceinline__ int rho(int g) { return ((g & 3) << 1) | (g >> 2); }

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// Block (strip, row group): word columns 96 strip.. over all of K, x rows 32
// group... w_map is the (K/4, N) int32 word map in boxes of 32 columns x sr
// word rows; x_map the (mpad, K) array's (c) or the (n_k, mpad, CK) stack's
// (b) in boxes of 128 k x 32 rows; all in the 128-byte swizzle. sr (128, 64,
// 32 or 16) divides a K-tile's CK / 4 word rows.
template <bool kStack>
__global__ void __launch_bounds__(kThreads, 1)
xread_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, int mpad, int k, int n, int ck, int sr,
                    int stages) {
  constexpr int kStageBytes = stage_bytes<kStack>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tile_boxes = (ck + 127) / 128;  // x boxes of a K-tile (b)
  uint8_t* xtile = smem + stages * kStageBytes;
  int* tsum = reinterpret_cast<int*>(xtile + (kStack ? tile_boxes * kXBoxBytes : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(tsum + kXRows * kCols);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;  // b: x's K-tile in, and released
  uint64_t* xempty = xfull + 1;
  const int n0 = blockIdx.x * kCols, r0 = blockIdx.y * kXRows;
  const int per_tile = ck / 4 / sr, n_k = k / ck, nst = n_k * per_tile;
  const int xboxes = sr * 4 / 128 > 1 ? sr * 4 / 128 : 1;  // c: x boxes a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the next kernel may start its own first stages while this one runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, kConsumers);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < kXRows * kCols; i += kThreads) tsum[i] = 0;
  __syncthreads();

  if (warp == 0) {
    // ------------------------------------------------------- word producer
    // stage i into slot i % stages once the consumers have released it: its
    // words, and in c the x its rows meet. The first stages' words go out at
    // once, while the kernel before may still run (the words are not written
    // by it); x only after griddepcontrol.wait
    if (lane == 0) {
      const uint64_t policy = l2_evict_first();  // the words are read once, x by every block
      auto load_w = [&](int i) {
        const int s = i % stages;
        uint8_t* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s],
                              kBoxes * sr * kBoxCols * 4 + (kStack ? 0 : xboxes * kXBoxBytes));
        for (int b = 0; b < kBoxes; ++b)
          tma_load_2d_hint(st + b * kWBoxBytes, &w_map, &full[s], n0 + b * kBoxCols, i * sr,
                           policy);
      };
      auto load_x = [&](int i) {
        uint8_t* xs = smem + (i % stages) * kStageBytes + kWBytes;
        for (int j = 0; j < xboxes; ++j)
          tma_load_2d(xs + j * kXBoxBytes, &x_map, &full[i % stages], 4 * i * sr + 128 * j, r0);
      };
      const int pre = min(stages, nst);
      for (int i = 0; i < pre; ++i) load_w(i);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      if (!kStack)
        for (int i = 0; i < pre; ++i) load_x(i);
      for (int i = pre; i < nst; ++i) {
        mbar_wait(&empty[i % stages], ((i / stages) - 1) & 1);
        load_w(i);
        if (!kStack) load_x(i);
      }
    }
  } else if (warp == 1) {
    // ------------------------------------------------ x's tiles (b only)
    // K-tile kk of the block's 32 rows into the tile buffer once the
    // consumers have released tile kk - 1
    if (kStack && lane == 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int kk = 0; kk < n_k; ++kk) {
        if (kk > 0) mbar_wait(xempty, (kk - 1) & 1);
        mbar_arrive_expect_tx(xfull, tile_boxes * kXBoxBytes);
        for (int j = 0; j < tile_boxes; ++j)
          tma_load_3d(xtile + j * kXBoxBytes, &x_map, xfull, 128 * j, r0, kk);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Consumer c takes box c % kBoxes and k-steps (8 word rows each) c /
    // kBoxes, + kParts, .. of each stage. Lane (g, t4) loads the 16-byte
    // chunk g of word rows 2t4 and 2t4 + 1 of a k-step (the A registers of
    // m-tile 0's fragment rows g, g + 8 the first two columns, m-tile 1's
    // the last two) and, for each n-tile nt, the 8 bytes of x row 8nt +
    // rho(g) at those rows' k (its B registers).
    const int c = warp - 2, box = c % kBoxes, part = c / kBoxes;
    const int g = lane / 4, t4 = lane % 4, ct = threadIdx.x - 64;
    const int steps = sr / 8;
    constexpr int kOuts = kXRows * kCols / (32 * kConsumers);
    float total[kOuts] = {};
    int acc[2][4][4] = {};  // 16-column m-tile, 8-row n-tile
    for (int kk = 0; kk < n_k; ++kk) {
      if (kStack) mbar_wait(xfull, kk & 1);
      for (int ti = 0; ti < per_tile; ++ti) {
        const int i = kk * per_tile + ti, s = i % stages;
        mbar_wait(&full[s], (i / stages) & 1);
        const uint8_t* st = smem + s * kStageBytes;
        const uint32_t* wst = reinterpret_cast<const uint32_t*>(st + box * kWBoxBytes);
        const uint8_t* xb = kStack ? xtile : st + kWBytes;
        const int xk0 = kStack ? 4 * ti * sr : 0;  // the stage's first k in xb
        for (int j = part; j < steps; j += kParts) {
          const int r = 8 * j + 2 * t4;  // r % 8 == 2 t4
          const uint4 v1 = *reinterpret_cast<const uint4*>(wst + r * kBoxCols + ((g ^ (2 * t4)) << 2));
          const uint4 v2 =
              *reinterpret_cast<const uint4*>(wst + (r + 1) * kBoxCols + ((g ^ (2 * t4 + 1)) << 2));
          const uint32_t a0[4] = {v1.x, v1.y, v2.x, v2.y}, a1[4] = {v1.z, v1.w, v2.z, v2.w};
          const int kb = xk0 + 4 * r;  // x's k of word row r: 8 bytes, 8-byte aligned
          const uint8_t* xbox = xb + (kb >> 7) * kXBoxBytes;
          const int chunk = (kb & 127) >> 4;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int row = 8 * nt + rho(g);  // 128-byte swizzle: chunk ^ row % 8
            const uint2 xv = *reinterpret_cast<const uint2*>(
                xbox + 128 * row + ((chunk ^ (row & 7)) << 4) + (kb & 8));
            const uint32_t b[2] = {xv.x, xv.y};
            w4a8::mma_s8(acc[0][nt], a0, b);
            w4a8::mma_s8(acc[1][nt], a1, b);
          }
        }
        release_stage(&empty[s], lane);  // the stage's words (and x) are in registers
      }
      if (kStack) release_stage(xempty, lane);  // every read of the tile is done
      // the tile's exact int32 sum of each output (integer adds: any order),
      // cast to f32 and added to the totals in tile order
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // fragment row g + 8 (e >> 1), column 2t4 + (e & 1)
            atomicAdd(&tsum[(8 * nt + rho(2 * t4 + (e & 1))) * kCols + box * kBoxCols + 4 * g +
                            2 * mt + (e >> 1)],
                      acc[mt][nt][e]);
            acc[mt][nt][e] = 0;
          }
      consumer_sync();
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        int* t = tsum + ct + j * 32 * kConsumers;
        total[j] += (float)*t;
        *t = 0;
      }
      consumer_sync();
    }
    // out is written only after the kernel before has finished
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kOuts; ++j) {
      const int o = ct + j * 32 * kConsumers, row = r0 + o / kCols, col = n0 + o % kCols;
      if (row < mpad && col < n)
        out[(size_t)row * n + col] = __float2bfloat16_rn(total[j] * scale[col]);
    }
  }
}

// the stage rows and the ring's stages of a K-tile of ck, or 0 stages where
// a tile (b) and two stages do not fit a block's shared memory
template <bool kStack>
void plan(int ck, int* sr, int* stages, int* smem) {
  *sr = kMaxRows;  // the largest of 128, 64, 32, 16 dividing a tile's ck / 4 word rows
  while ((ck / 4) % *sr) *sr /= 2;
  const int fixed = 1024 + (kStack ? (ck + 127) / 128 * kXBoxBytes : 0) + kTSumBytes +
                    16 * (kMaxStages + 1);
  const int fit = (kSmemMax - fixed) / stage_bytes<kStack>();
  *stages = fit < 2 ? 0 : (fit < kMaxStages ? fit : kMaxStages);
  *smem = fixed + *stages * stage_bytes<kStack>();
}

template <bool kStack>
int launch(const void* x, const void* w, const void* scale, void* out, int mpad, int k, int n,
           int ck, cudaStream_t s) {
  if (mpad < 1 || ck < 64 || ck % 64 || k < ck || k % ck || n < kBoxCols || n % kBoxCols)
    return (int)cudaErrorInvalidValue;
  int sr, stages, smem;
  plan<kStack>(ck, &sr, &stages, &smem);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap w_map, x_map;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)(k / 4)};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {kBoxCols, (cuuint32_t)sr};
    if (!encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  if (kStack) {
    const cuuint64_t dims[3] = {(cuuint64_t)ck, (cuuint64_t)mpad, (cuuint64_t)(k / ck)};
    const cuuint64_t strides[2] = {(cuuint64_t)ck, (cuuint64_t)mpad * ck};
    const cuuint32_t box[3] = {128, kXRows, 1};
    if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)mpad};
    const cuuint64_t strides[1] = {(cuuint64_t)k};
    const cuuint32_t box[2] = {128, kXRows};
    if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = xread_stream_kernel<kStack>;
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((n + kCols - 1) / kCols, (mpad + kXRows - 1) / kXRows);
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
  return (int)cudaLaunchKernelEx(&cfg, kernel, w_map, x_map, static_cast<const float*>(scale),
                                 static_cast<__nv_bfloat16*>(out), mpad, k, n, ck, sr, stages);
}
}  // namespace xr

// ------------------------------------------------------------ nibble stream
namespace nib {
constexpr int kBoxCols = 32;                       // word columns a TMA box: 128 bytes a word row
constexpr int kBoxes = 3;                          // boxes a block: 96 columns
constexpr int kParts = 4;                          // consumer warps a box
constexpr int kConsumers = kBoxes * kParts;
constexpr int kThreads = 32 * (1 + kConsumers);    // warp 0 loads
constexpr int kXRows = 32;                         // x rows a block: four 8-row n-tiles
constexpr int kGroupRows = 16;                     // word rows of an x box: 64 columns of a half
constexpr int kMaxRows = 64;                       // word rows a stage, at most (512 k)
constexpr int kWBoxBytes = kMaxRows * kBoxCols * 4;               // 8 KB
constexpr int kWBytes = kBoxes * kWBoxBytes;                      // 24 KB
constexpr int kXBoxBytes = kXRows * 128;                          // 4 KB
constexpr int kXBytes = kMaxRows / kGroupRows * 2 * kXBoxBytes;   // an even and an odd box a group
constexpr int kStageBytes = kWBytes + kXBytes;                    // 56 KB
constexpr int kSmemMax = 227 * 1024;
constexpr int kStages = (kSmemMax - 1024 - 16 * 8) / kStageBytes;  // 4
static_assert(kStages >= 2 && kStageBytes % 1024 == 0, "a ring of 1024-byte aligned stages");

// Block (strip, row group): word columns 96 strip.. over all of K, x rows 32
// group... w_map is the (K/8, N) int32 word map in boxes of 32 columns x sr
// word rows, x_map the (n_k, mpad, CK) stack's in boxes of 64 columns x 32
// rows, both in the 128-byte swizzle; sr (64, 32, 16 or 8) divides the
// chunk's CK / 8 word rows.
__global__ void __launch_bounds__(kThreads, 1)
nibble_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                     const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ out, int mpad, int k, int n, int ck, int sr) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBoxes * kBoxCols, r0 = blockIdx.y * kXRows;
  const int chunk_rows = ck / 8, tiles = k / 8 / sr;
  const int groups = (sr + kGroupRows - 1) / kGroupRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the next kernel may start its own first stages while this one runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[2][4][4] = {};  // 16-column m-tile, 8-row n-tile
  if (warp == 0) {
    // ------------------------------------------------------------ producer
    // tile i into stage i % kStages once the consumers have released it:
    // its words, and for each group of 16 of its word rows the chunk's even
    // and odd halves at those rows (x's 64-column boxes: 128-byte rows, as
    // the words', for the requests a byte). The first stages' words go out
    // at once, while the kernel before may still run (the words and scales
    // are not written by it); x only after griddepcontrol.wait
    if (lane == 0) {
      auto load_w = [&](int i) {
        const int s = i % kStages;
        uint8_t* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kBoxes * sr * kBoxCols * 4 + groups * 2 * kXBoxBytes);
        for (int b = 0; b < kBoxes; ++b)
          tma_load_2d(st + b * kWBoxBytes, &w_map, &full[s], n0 + b * kBoxCols, i * sr);
      };
      auto load_x = [&](int i) {
        uint8_t* xs = smem + (i % kStages) * kStageBytes + kWBytes;
        const int kk = i * sr / chunk_rows, lw = i * sr - kk * chunk_rows;
        for (int gp = 0; gp < groups; ++gp)
          for (int h = 0; h < 2; ++h)
            tma_load_3d(xs + (2 * gp + h) * kXBoxBytes, &x_map, &full[i % kStages],
                        h * (ck / 2) + 4 * (lw + kGroupRows * gp), r0, kk);
      };
      const int pre = min(kStages, tiles);
      for (int i = 0; i < pre; ++i) load_w(i);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int i = 0; i < pre; ++i) load_x(i);
      for (int i = pre; i < tiles; ++i) {
        mbar_wait(&empty[i % kStages], ((i / kStages) - 1) & 1);
        load_w(i);
        load_x(i);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    // Consumer c takes box c % kBoxes and groups c / kBoxes, + kParts, .. of
    // 16 word rows of each stage. In a group, lane (g, t4) takes word rows
    // q = s ^ j (s = {0, 10, 4, 14}[t4], j = 0 .. 3), the even and odd row
    // of a pair together: the 16-byte chunk g of each row (columns 4g ..
    // 4g + 3; m-tile 0's fragment rows g, g + 8 the first two, m-tile 1's
    // the last two), and for each n-tile's row g + 8 nt the 16 bytes of x's
    // even or odd half at the pair's columns 4q .. 4q + 7. k-step (q, h):
    // slots 2t4, 2t4 + 1 are the row's nibbles (h, 2 + h), slots 2t4 + 8,
    // 2t4 + 9 nibbles (4 + h, 6 + h), and x's half h at columns 4q, 4q + 1
    // and 4q + 2, 4q + 3. Rows past a stage of 8 convert as zeros (their x
    // box columns are the next rows', or zeros).
    const int c = warp - 1, box = c % kBoxes, part = c / kBoxes;
    const int s16 = ((10 * (t4 & 1)) ^ (5 * (t4 >> 1))) & ~1;
    const uint32_t bias = 0x43084308u;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* st = smem + s * kStageBytes;
      const uint32_t* wst = reinterpret_cast<const uint32_t*>(st + box * kWBoxBytes);
      for (int gp = part; gp < groups; gp += kParts) {
#pragma unroll
        for (int jj = 0; jj < 4; jj += 2) {
          // word rows q0 (even) and q0 + 1: their x columns 4q0 .. 4q0 + 7
          // are one 16-byte chunk of each x row
          const int q0 = s16 ^ jj;
          uint32_t lo[2][4], hi[2][4];  // nibbles of bytes (0, 1) and (2, 3) side by side
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const int q = q0 + jp, r = kGroupRows * gp + q;
            uint4 v = *reinterpret_cast<const uint4*>(wst + r * kBoxCols + ((g ^ (q & 7)) << 2));
            if (sr < kGroupRows && r >= sr) v = make_uint4(0u, 0u, 0u, 0u);  // nibbles 0: values 0
            const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              lo[jp][cc] = __byte_perm(wv[cc], 0u, 0x0100u);
              hi[jp][cc] = __byte_perm(wv[cc], 0u, 0x0302u);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint8_t* xb = st + kWBytes + (2 * gp + h) * kXBoxBytes;
            uint4 xv[4];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)  // row g + 8nt; 128-byte swizzle: chunk ^ row % 8
              xv[nt] = *reinterpret_cast<const uint4*>(xb + 128 * (g + 8 * nt) +
                                                       (((q0 >> 1) ^ g) << 4));
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const uint32_t a[4] = {nibble_pair_bf16x2(lo[jp][2 * mt], h, bias),
                                       nibble_pair_bf16x2(lo[jp][2 * mt + 1], h, bias),
                                       nibble_pair_bf16x2(hi[jp][2 * mt], h, bias),
                                       nibble_pair_bf16x2(hi[jp][2 * mt + 1], h, bias)};
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                  const uint32_t b[2] = {jp ? xv[nt].z : xv[nt].x, jp ? xv[nt].w : xv[nt].y};
                  mma_bf16(acc[mt][nt], a, b);
                }
              }
            }
          }
        }
      }
      release_stage(&empty[s], lane);  // the stage's words and x are in registers
    }
  }

  // the consumers' f32 sums meet in shared memory (the ring is idle: every
  // tile has been consumed) and are added in warp order; out is written
  // only after the kernel before has finished (griddepcontrol.wait)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  // [consumer][x row][column of its box], the column XOR-ed by (row / 2) % 4:
  // a store's 32 lanes (rows 2t4, columns 4g) then fall in distinct banks
  float* fold = reinterpret_cast<float*>(smem);
  if (warp > 0) {
    const int c = warp - 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // fragment row g + 8 (e >> 1), column 2t4 + (e & 1)
          fold[(c * kXRows + nt * 8 + 2 * t4 + (e & 1)) * kBoxCols +
               ((4 * g + 2 * mt + (e >> 1)) ^ t4)] = acc[mt][nt][e];
  }
  __syncthreads();
  constexpr int kCols = kBoxes * kBoxCols;
  for (int o = threadIdx.x; o < kXRows * kCols; o += kThreads) {
    const int row = o / kCols, cl = o % kCols, col = n0 + cl;
    if (r0 + row >= mpad || col >= n) continue;
    const float* f = fold + row * kBoxCols + ((cl % kBoxCols) ^ ((row >> 1) & 3));
    float sum = 0.f;
#pragma unroll
    for (int h = 0; h < kParts; ++h) sum += f[(cl / kBoxCols + kBoxes * h) * kXRows * kBoxCols];
    out[(size_t)(r0 + row) * n + col] = __float2bfloat16_rn(sum * scale[col]);
  }
}

int launch(const void* x, const void* w, const void* scale, void* out, int mpad, int k, int n,
           int ck, cudaStream_t s) {
  if (mpad < 1 || ck < 64 || ck % 64 || k < ck || k % ck || n < kBoxCols || n % kBoxCols)
    return (int)cudaErrorInvalidValue;
  int sr = kMaxRows;  // a stage's word rows: the largest of 64, 32, 16, 8 dividing a chunk's
  while ((ck / 8) % sr) sr /= 2;
  CUtensorMap w_map, x_map;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)(k / 8)};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {kBoxCols, (cuuint32_t)sr};
    if (!encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)ck, (cuuint64_t)mpad, (cuuint64_t)(k / ck)};
    const cuuint64_t strides[2] = {(cuuint64_t)ck * 2, (cuuint64_t)mpad * ck * 2};
    const cuuint32_t box[3] = {4 * kGroupRows, kXRows, 1};
    if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nibble_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((n + kBoxes * kBoxCols - 1) / (kBoxes * kBoxCols), (mpad + kXRows - 1) / kXRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 1024 + kStages * kStageBytes + 16 * kStages;
  cfg.stream = s;
  cudaLaunchAttribute pdl;  // programmatic dependent launch (see the producer)
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nibble_stream_kernel, w_map, x_map,
                                 static_cast<const float*>(scale),
                                 static_cast<__nv_bfloat16*>(out), mpad, k, n, ck, sr);
}
}  // namespace nib

// ------------------------------------------------------------ tiny kernel
__global__ void tiny_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int n8) {
  // the TPU kernel's weakly typed 1.0000001 becomes the bf16 1.0
  const __nv_bfloat162 c = __float2bfloat162_rn(1.0000001f);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  uint4 v = x[i];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __hmul2(h[j], c);
  out[i] = v;
}

// ------------------------------------------------------------ row probe
constexpr int kRowCols = 128;  // key columns a block

// byte i of w ^ 0x80808080 (the byte plus 128) as the float 2^23 + byte,
// minus 2^23 + 128: the signed byte, exactly
__device__ __forceinline__ float key_byte(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}

template <bool kDyn>
__global__ void __launch_bounds__(kThreads)
rowrw_kernel(const uint16_t* __restrict__ q, const uint4* __restrict__ kp, float* __restrict__ out,
             float* __restrict__ acc, int ns, int heads, int t) {
  extern __shared__ float qs[];  // the query row, heads * 128 f32
  __shared__ float part[kWarps][kRowCols];
  __shared__ float acc0;
  const int s = blockIdx.x, t0 = blockIdx.y * kRowCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int width = heads * 128;
  const uint16_t* qrow = q + (size_t)(kDyn ? s : 0) * width;
  for (int i = threadIdx.x; i < width; i += kThreads)
    qs[i] = __uint_as_float((uint32_t)qrow[i] << 16);
  __syncthreads();

  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  const int words_row = t / 4;  // 16-byte chunks of a key word row
  for (int hd = warp; hd < heads; hd += kWarps) {
    const uint4* kw = kp + ((size_t)s * heads + hd) * 32 * words_row + t0 / 4 + lane;
    const float* qh = qs + hd * 128;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const uint4 v = kw[(size_t)r * words_row];
      const uint32_t cols[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                                v.w ^ 0x80808080u};
#pragma unroll
      for (int b = 0; b < 4; ++b) {  // key row 4r + b
        const float qv = qh[4 * r + b];
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[c] = fmaf(qv, key_byte(cols[c], b), dot[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] += dot[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) part[warp][4 * lane + c] = sum[c];
  __syncthreads();
  if (threadIdx.x < kRowCols) {
    float a = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) a += part[wi][threadIdx.x];
    acc[(size_t)s * t + t0 + threadIdx.x] = a;
    if (threadIdx.x == 0) acc0 = a;
  }
  if (blockIdx.y != 0) return;
  __syncthreads();
  if (kDyn) {
    for (int i = threadIdx.x; i < width; i += kThreads) out[(size_t)s * width + i] = acc0;
  } else {
    if (s == ns - 1)
      for (int i = threadIdx.x; i < width; i += kThreads) out[i] = acc0;
    if (s != 0)
      for (int i = threadIdx.x; i < width; i += kThreads) out[(size_t)s * width + i] = 0.f;
  }
}

}  // namespace

// x-read probe: w (K/4, N) int32 pack_int8_rows words; scale (N,) f32; out
// (mpad, N) bf16. x8 = 1: int8 x, W8A8 (the word stream); 0: bf16 x, W8A16
// (probe_kernel). stack = 1: x the (K/ck, mpad, ck) tile stack, a K-tile at a
// time in shared memory (b); 0: x the (mpad, K) array (c). ck a multiple of
// 64 dividing K; N a multiple of 32; int8 x in b also a K-tile of 32 rows
// that fits beside two stages (ck up to 3712).
extern "C" int mmor_xread_probe(const void* x, const void* w, const void* scale, void* out,
                                int mpad, int k, int n, int ck, int x8, int stack,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x8 && stack) return xr::launch<true>(x, w, scale, out, mpad, k, n, ck, s);
  if (x8) return xr::launch<false>(x, w, scale, out, mpad, k, n, ck, s);
  if (stack) return launch_probe<XSrc::kSmem>(x, w, scale, out, mpad, k, n, ck, stream);
  return launch_probe<XSrc::kGlobal2D>(x, w, scale, out, mpad, k, n, ck, stream);
}

// nibble probe: x (K/ck, mpad, ck) bf16, each chunk [even rows | odd rows];
// w (K/8, N) int32, nibble i of word r = row 8r + i; scale (N,) f32; out
// (mpad, N) bf16.
extern "C" int mmor_nibble_probe(const void* x, const void* w, const void* scale, void* out,
                                 int mpad, int k, int n, int ck, void* stream) {
  return nib::launch(x, w, scale, out, mpad, k, n, ck, static_cast<cudaStream_t>(stream));
}

// tiny probe: out = x * bf16(1.0000001) over n bf16 values, n % 8 == 0.
extern "C" int mmor_tiny_probe(const void* x, void* out, int n, void* stream) {
  if (n < 0 || n % 8) return (int)cudaErrorInvalidValue;
  const int n8 = n / 8;
  if (n8 == 0) return 0;
  tiny_kernel<<<(n8 + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n8);
  return (int)cudaGetLastError();
}

// row probe: q (S, heads * 128) bf16 query rows (row s in dyn mode, row 0
// in static mode); kp (S, heads, 32, T) int32, byte b of word row r = key
// row 4r + b; out (S, heads * 128) f32; acc (S, T) f32. T % 128 == 0.
extern "C" int mmor_rowrw_probe(const void* q, const void* kp, void* out, void* acc, int ns,
                                int heads, int t, int dyn, void* stream) {
  if (ns < 1 || heads < 1 || t < kRowCols || t % kRowCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(ns, t / kRowCols);
  const size_t smem = (size_t)heads * 128 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* qb = static_cast<const uint16_t*>(q);
  const uint4* k4 = static_cast<const uint4*>(kp);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (dyn)
    rowrw_kernel<true><<<grid, kThreads, smem, s>>>(qb, k4, static_cast<float*>(out),
                                                     static_cast<float*>(acc), ns, heads, t);
  else
    rowrw_kernel<false><<<grid, kThreads, smem, s>>>(qb, k4, static_cast<float*>(out),
                                                      static_cast<float*>(acc), ns, heads, t);
  return (int)cudaGetLastError();
}
