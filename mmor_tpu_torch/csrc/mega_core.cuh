// K5's weight core: every matmul phase of the decode megakernel
// (mega_decode.cu), at both weight widths, over the decode rows and the
// piggyback-prefill rows together: the W4A8 and W8A8 products of
// mmor_tpu/ops/mega_decode.py::mega_decode_layers (_mega_kernel's qkv, o,
// gate_up and down matmuls, :663-760 and :941-978 at wbits 8), whose
// arithmetic is mega_decode_layers_reference's mm_quant (:1477-1485).
//
// Operands: R activation rows quantized to int8 per (row, K-chunk), (R, K)
// bytes with (R, K/chunk) f32 scales; the weights are one layer's packed
// words, pack_int4_rows (K/8, N) with (K/group, N) f32 scales, or
// pack_int8_rows (K/4, N) with (N,) f32 per-channel scales.
//
// What bounds it on the H100: the weight bytes. At R = 8 every weight byte
// meets 8 (int8) or 16 (int4) multiply-adds; at R = 136 (a 128-row chunk
// riding along) the int8 operations at the card's peak take about as long
// as the bytes.
//
// Design: every block owns a strip of weight columns, one or two TMA boxes
// of 32 columns (128 bytes of words; the o and down phases take one box so
// that N = 4096 still gives 128 blocks, qkv two, gate_up the 32 gate
// columns and the 32 up columns that pair with them), and walks all of K
// once for all R rows of its slab:
//  - warp 0 keeps a ring of stages full by TMA in the 128-byte swizzle,
//    paced by full/empty mbarriers: a stage is `stage_rows` word rows of
//    each box (128 with one box, 64 with two: 16 KB of words a stage; 32
//    past 32 rows, where the activations dominate) and the slab's
//    activation bytes for those K rows, one 3-D TMA box of 128-byte slices
//    of rows (two at int4: the group's low and high halves). Boxes of 32
//    word rows streamed the narrow phases several times slower than boxes
//    of 128 on the H100 (weight loads alone, in builds whose consumers only
//    released the stages; not kept). Where N %
//    4 != 0, which TMA's 16-byte row strides cannot describe, warp 0
//    copies the words by cp.async into the same layout. The kernel is
//    launched with programmatic dependent launch: warp 0 issues the first
//    weight tiles while the kernel before it (norm and quantization, or
//    attention) is still running, and waits (griddepcontrol.wait) only
//    before the first activation tile;
//  - one to nine consumer warps take the stages: K falls into units (a
//    chunk, or at int8 a few chunks that fill whole stages; a weight group
//    at int4: what one warp multiplies whole), and the warps form row sets of
//    gw 8-row groups (one set up to 16 rows; at 136 nine sets of two
//    groups, so that each SM sub-partition has warps to switch between:
//    in chip_smoke.py's phase 2 four sets of five groups ran slower, and
//    so did two slabs of 72 rows with deeper rings),
//    each set's wu warps taking its units in turn (four at R = 8, so that
//    the SM's one block of the o and down phases still has four warps at
//    work), each from a sub-ring of its own. A warp multiplies every k of
//    its stages for all rows of its set, so each weight word is loaded from
//    shared memory once per row set. The product is taken transposed,
//    W^T x^T, on mma.sync.m16n8k32.s8: a weight word (4 k of one column) is
//    an A register as it lies in the stage (int8), or its low or high
//    nibbles masked out (int4: the biased values 0..15, the bias taken off
//    afterwards as 8 times the activations' exact row sums, kept beside the
//    products by __dp4a), and a lane's 16-byte load of a swizzled word row
//    gives the A registers of four columns; the n = 8 slots are the 8 rows
//    of a group, so R = 8 wastes no slot. The 8 word rows of a 32-k step go
//    to the fragment's k slots in the order (2t, 2t + 1), and a group's
//    rows to its n slots in the order (0, 2, 4, 6, 1, 3, 5, 7), which makes
//    both the weight loads and the 8-byte activation loads conflict-free;
//  - the numerics are the plain version's (_w4a8_chunks / _w8a8_chunks):
//    each (row, column, activation chunk) dot is an exact int32 in
//    registers, and the chunks fold in chunk order with __fmul_rn /
//    __fadd_rn into f32 sums in registers: acc += (dot *
//    w_scale[group, col]) * rs[row, c] at int4, acc += dot * rs[row, c]
//    then * scale[col] at int8, the scales staged in shared memory once.
//    Where warps split a row set's units, a term (dot * w_scale) * rs does
//    not depend on the running sum: each warp stores its chunks' terms, and
//    at the end the set's warps add them in chunk order, each warp a share
//    of the outputs (a first form passed the sums from warp to warp in unit
//    order, and its chain of folds held the narrow phases back). A warp
//    alone on its rows folds each chunk as it completes; at
//    int4 the o-projection's chunks (kDh = 128, a head) split a group, so a
//    stage completes a low and a high chunk, and the high ones wait in the
//    warp's table in shared memory until the group's low ones are folded.
//    So each output is bit for bit the plain version's, whatever the plan
//    (ops/mega_decode.py::core_plan);
//  - the epilogues are the old core's: f32 store (qkv), f32 residual (o,
//    down), SwiGLU on the paired gate and up columns (gate_up).
//
// K split across a cluster (Plan::ranks): a strip's `ranks` blocks each
// take a run of the units in K order and store their chunk terms into rank
// 0's shared memory; after one cluster barrier rank 0 adds them in chunk
// order, so the bits do not change. Against one block a strip at R = 8
// (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3 at 700 W, ms): int4 down 0.0139, 2 ranks 0.0119
// (the winner, 14% faster), 3 ranks 0.0188; int4 o 0.0096, 0.0105, 4
// ranks 0.0188; int8 down 0.0220, 0.0225, 3 ranks 0.0217; int8 o 0.0121,
// 0.0119, 4 ranks 0.0216. So core_plan splits only the int4 down phase at
// up to 8 rows, over 2 ranks (in the int4 decode step, phase 5, that took
// the union of K5's kernel intervals from 3.907-3.909 ms a step to
// 3.830-3.835); elsewhere one block streams a strip's K.
// The row sets run mma.sync over all of their row groups. The transposed
// wgmma form (weight words as register A fragments, n = R rounded up to
// 8), the other form considered for R = 136, was not built or measured: the
// reasoning against it at R = 8 (its 64-column warpgroup tiles would leave
// a quarter of the blocks of the o and down phases) is untested, and at R =
// 136, where this core runs at 0.2-0.7 TB/s, it is the open question.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "w4a8.cuh"

namespace mc {

namespace cg = cooperative_groups;

enum Epilogue {
  kStoreF32 = 0,  // out f32 (R, N) = acc
  kResidF32 = 1,  // out f32 (R, N) = resid + acc
  kSwiGLU = 2,    // N = 2F columns [gate | up]: out f32 (R, F) = silu(gate) * up
};

constexpr int kBoxCols = 32;      // word columns of a TMA box
constexpr int kStepWords = 32;    // word rows of a 32-k step's 8 word rows x 4
constexpr int kSliceBytes = 128;  // activation bytes of a row a step (a slice)
constexpr int kMaxWarps = 9;      // consumer warps
constexpr int kMaxUnitWarps = 4;  // warps that split a row set's units
constexpr int kMaxStages = 24;
constexpr int kMaxRanks = 8;         // the largest portable cluster
constexpr int kMaxSlabRows = 256;    // a TMA box's rows
constexpr int kSmemLimit = 232448;   // a block's shared memory on the H100
constexpr int kAlign = 1024;         // the 128-byte swizzle's period

__host__ __device__ constexpr int boxes_of(int epi) { return epi == kResidF32 ? 1 : 2; }
__host__ __device__ constexpr int slices_of(int wbits) { return wbits == 4 ? 2 : 1; }

struct Args {
  const int8_t* xq;     // (m, k) int8 activations
  const float* rs;      // (m, k / chunk) their scales
  const uint32_t* w;    // (k / 8, n) or (k / 4, n) words
  const float* sc;      // (k / group, n) at wbits 4; (n,) at wbits 8
  const float* resid;   // kResidF32: (m, n)
  float* out;           // (m, n), or (m, n / 2) for kSwiGLU
  int m, k, n, group, chunk;
};

// a launch's tiling (ops/mega_decode.py::core_plan): 8-row groups a
// consumer warp, row sets (warps that split the slab's rows), warps that
// split each row set's units of K, rows of a slab (a grid row), ring
// stages, word rows a stage, K rows a unit, the blocks of a cluster that
// split a strip's units of K (1: no cluster)
struct Plan {
  int gw, wr, wu, slab_rows, stages, stage_rows, unit_k, ranks;
};

// host: the int4 halves' chunks split a group (the o-projection's heads)
inline bool split_halves(int wbits, int group, int chunk) {
  return wbits == 4 && chunk != group;
}

// host: the int32 chunk dots a warp keeps: where one warp takes every
// unit of its rows, an int4 group's high chunks while its low ones fold
inline int table_slots(int wbits, int group, int chunk, const Plan& pl) {
  return split_halves(wbits, group, chunk) && pl.wu == 1 && pl.ranks == 1 ? group / 2 / chunk
                                                                          : 0;
}

// host: the f32 scales a block stages: its rows' chunk scales, then its
// columns' weight scales (a row of them per int4 group, one at int8)
inline size_t scale_floats(int wbits, int epi, int k, int group, int chunk, const Plan& pl) {
  return (size_t)pl.slab_rows * (k / chunk) +
         (size_t)boxes_of(epi) * kBoxCols * (wbits == 4 ? k / group : 1);
}

// host: bytes of a ring stage: its boxes of words and activation slices
inline size_t stage_bytes(int wbits, int epi, const Plan& pl) {
  return (size_t)boxes_of(epi) * pl.stage_rows * kBoxCols * 4 +
         (size_t)slices_of(wbits) * (pl.stage_rows / kStepWords) * pl.slab_rows * kSliceBytes;
}

// host: shared memory of a launch, the alignment slack included: the ring,
// the int32 tables, the row sets' chunk terms (where warps split the
// units), the staged scales, the barriers
inline size_t smem_bytes(int wbits, int epi, int k, int group, int chunk, const Plan& pl) {
  const size_t frag = (size_t)boxes_of(epi) * 2 * pl.gw * 4 * 32 * 4;  // a warp's accumulators
  return kAlign + pl.stages * stage_bytes(wbits, epi, pl) +
         (size_t)pl.wr * pl.wu * table_slots(wbits, group, chunk, pl) * frag +
         (pl.wu > 1 || pl.ranks > 1 ? (size_t)pl.wr * (k / chunk) * frag : 0) +
         4 * scale_floats(wbits, epi, k, group, chunk, pl) +
         2 * sizeof(uint64_t) * pl.stages;
}

// byte `byte` of row r of a tile of 128-byte rows in the 128-byte swizzle
// (TMA's: the 16-byte chunk index XOR the row mod 8)
__device__ __forceinline__ int swz(int r, int byte) {
  return r * 128 + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// the row of a group that n slot s multiplies: slots 0-3 take its even rows
// and 4-7 its odd ones, so that the 8-byte loads of a half warp meet 16
// distinct bank pairs
__device__ __forceinline__ int slot_row(int s) { return ((s & 3) << 1) | (s >> 2); }

// grid (strips * ranks, slabs), clusters of `ranks` blocks along x,
// 32 * (1 + wr * wu) threads. SPLIT: int4 with chunk < group. `slots`
// chunk dots a warp keeps in its table.
template <int WBITS, int EPI, int GW, bool SPLIT>
__global__ void __launch_bounds__(32 * (1 + kMaxWarps), 1)
core_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
            int w_tma, Args p, Plan pl, int slots) {
  constexpr int B = boxes_of(EPI);
  constexpr int NA = B * 2 * GW * 4;  // a lane's accumulators
  const int wr = pl.wr, wu = pl.wu, slab_rows = pl.slab_rows, stages = pl.stages;
  const int srows = pl.stage_rows, nsub = srows / kStepWords;  // 32-k steps x 4: sub-steps
  const int box_bytes = srows * kBoxCols * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int tile = slab_rows * kSliceBytes;  // a slice's activation tile
  const int xbytes = slices_of(WBITS) * nsub * tile;
  const int sbytes = B * box_bytes + xbytes;
  const int warps = wr * wu;
  int* tab = reinterpret_cast<int*>(smem + (size_t)stages * sbytes);
  const int nch = p.k / p.chunk;
  const int ranks = pl.ranks, rank = blockIdx.x % ranks;
  // warps or a cluster's blocks split the units: chunk terms, summed at the end
  const bool lazy = wu > 1 || ranks > 1;
  float* term_s = reinterpret_cast<float*>(tab + (size_t)warps * slots * NA * 32);  // [wr][nch][NA][32]
  float* rs_s = term_s + (lazy ? (size_t)wr * nch * NA * 32 : 0);  // [slab_rows][nch]
  float* ws_s = rs_s + (size_t)slab_rows * nch;                   // [groups or 1][B * 32]
  const int nws = WBITS == 4 ? p.k / p.group : 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws_s + (size_t)nws * B * kBoxCols);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = blockIdx.x / ranks, row0 = blockIdx.y * slab_rows;
  const int f = p.n / 2;
  // a unit is what one warp folds at once; spu ring loads of it lie
  // together on the K walk, a load `nsub` 32-row steps of it
  const int unit_k = pl.unit_k, cpu = unit_k / p.chunk;  // chunks a unit
  const int spu = unit_k / (srows * (WBITS == 8 ? 4 : 8));
  // the cluster's ranks take runs of the units in K order: this block's
  // first unit and its count (the loads and warps below count its own)
  const int ub = rank * (p.k / unit_k) / ranks, units = (rank + 1) * (p.k / unit_k) / ranks - ub;
  // ring load i, in load order: rounds of wu units, a stage of each of the
  // round's units in turn. Unit warp w of a round takes its loads from its
  // own sub-ring of sw = stages / wu slots, in order, so no warp ever waits
  // on a slot more than one fill ahead (an mbarrier's parity tells only
  // two fills apart).
  const int sw = stages / wu;
  struct Load {
    int step, slot, parity, nth;  // first 32-row step; slot; its fill's parity; the warp's nth
  };
  auto load_of = [&](int i) {
    const int r = i / (wu * spu), rem = i % (wu * spu);
    const int nr = units - r * wu < wu ? units - r * wu : wu;
    const int w = rem % nr, t = rem / nr, nth = r * spu + t;
    return Load{((ub + r * wu + w) * spu + t) * nsub, w * sw + nth % sw, (nth / sw) & 1, nth};
  };
  // first weight column of box b
  auto col0 = [&](int b) {
    return EPI == kSwiGLU ? b * f + strip * kBoxCols : (strip * B + b) * kBoxCols;
  };
  // the first K row of step st's low (int8: only) slice
  auto step_k = [&](int st) {
    if (WBITS == 8) return st * kSliceBytes;
    const int gwr = p.group / 8, wr0 = st * kStepWords;
    return (wr0 / gwr) * p.group + 4 * (wr0 % gwr);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // the TMA bytes' arrival, and each lane's where warp 0 copies the words
      mbar_init(&full[s], w_tma ? 1 : 1 + 32);
      mbar_init(&empty[s], wr);  // the warps of each row set take every stage of a unit
    }
    mbar_fence_init();
  }
  __syncthreads();
  // every block of the cluster must have started before another writes to
  // its shared memory (the chunk terms, into rank 0's)
  if (ranks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int nloads = units * spu;
  if (warp == 0) {
    // ------------------------------------------------------------ producer
    const uint32_t tx = xbytes + (w_tma ? B * box_bytes : 0);
    // the weight words of ring load i, once the consumers have released its slot
    auto load_w = [&](int i) {
      const Load ld = load_of(i);
      const int s = ld.slot;
      if (ld.nth >= sw) {
        if (lane == 0) mbar_wait(&empty[s], ld.parity ^ 1);
        __syncwarp();
      }
      uint8_t* st = smem + (size_t)s * sbytes;
      const int r0 = ld.step * kStepWords;
      if (lane == 0) mbar_arrive_expect_tx(&full[s], tx);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (w_tma) {
          if (lane == 0) tma_load_2d(st + b * box_bytes, &w_map, &full[s], col0(b), r0);
          continue;
        }
        for (int e = lane; e < srows * kBoxCols; e += 32) {
          const int r = e / kBoxCols, c = e % kBoxCols, col = col0(b) + c;
          const bool in = col < p.n;
          cp_async4(st + b * box_bytes + swz(r, 4 * c),
                    in ? p.w + (size_t)(r0 + r) * p.n + col : p.w, in ? 4 : 0);
        }
      }
      if (!w_tma) cp_async_arrive(&full[s]);
    };
    // its activation slices: [slice][row][128 bytes], the slices of its
    // steps' K rows (at int4 the low halves', then the high halves')
    auto load_x = [&](int i) {
      if (lane != 0) return;
      const Load ld = load_of(i);
      uint8_t* xs = smem + (size_t)ld.slot * sbytes + B * box_bytes;
      const int k0 = step_k(ld.step);
      tma_load_3d(xs, &x_map, &full[ld.slot], 0, row0, k0 / kSliceBytes);
      if (WBITS == 4)
        tma_load_3d(xs + nsub * tile, &x_map, &full[ld.slot], 0, row0,
                    (k0 + p.group / 2) / kSliceBytes);
    };
    // the weight tiles that fit go out while the kernel before runs; the
    // activation tiles once it has finished (the loads' nth only grows)
    int pre = 0;
    while (pre < nloads && load_of(pre).nth < sw) ++pre;
    for (int i = 0; i < pre; ++i) load_w(i);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int i = 0; i < pre; ++i) load_x(i);
    for (int i = pre; i < nloads; ++i) {
      load_w(i);
      load_x(i);
    }
    if (ranks > 1) {  // every thread of the cluster meets its two barriers
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      cg::this_cluster().sync();
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  // Warp cw owns row set ru (GW groups of 8 rows) and, of every round of wu
  // units, unit uu: it multiplies those units' stages for its rows. Alone
  // on its rows (wu == 1) it folds each chunk into its f32 sums (in
  // registers) as the chunk completes. Where warps split the units,
  // each stores its chunks' terms (dot * w_scale) * rs, which do not
  // depend on the running sum, and at the end the row set's warps add the
  // terms in chunk order, each warp a share of the outputs: the same f32
  // additions in the same order as the plain version's fold.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // rs, resid and out
  const int cw = warp - 1, ru = cw / wu, uu = cw % wu, g = lane / 4, t4 = lane % 4;
  // the scales the folds read, staged once: the slab's chunk scales and the
  // block's weight scales (0 past the rows and columns)
  for (int i = threadIdx.x - 32; i < slab_rows * nch; i += 32 * warps) {
    const int row = row0 + i / nch;
    rs_s[i] = row < p.m ? p.rs[(size_t)row * nch + i % nch] : 0.f;
  }
  for (int i = threadIdx.x - 32; i < nws * B * kBoxCols; i += 32 * warps) {
    const int gr = i / (B * kBoxCols), b = i / kBoxCols % B, col = col0(b) + i % kBoxCols;
    ws_s[i] = col < p.n ? p.sc[(size_t)gr * p.n + col] : 0.f;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * warps) : "memory");  // the consumer warps
  // lane (g, t4) holds columns 4g..4g+3 of each box (u = 2 mt + e / 2) and
  // rows slot_row(2 t4), slot_row(2 t4 + 1) of each of its groups (e % 2)
  bool live[GW];
  int rows[GW][2], cols[B][4];
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    const int q = ru * GW + j;
    live[j] = 8 * q < slab_rows && row0 + 8 * q < p.m;
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[j][h] = row0 + 8 * q + slot_row(2 * t4 + h);
  }
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int u = 0; u < 4; ++u) cols[b][u] = col0(b) + 4 * g + u;
  // int32 dots of the current chunk (SPLIT: of its low half) and, SPLIT,
  // of the current high chunk; int4: this lane's share of the slot-g row
  // sums of the same activations (the nibbles multiply biased by +8)
  int d[B][2][GW][4], dh[SPLIT ? B : 1][2][SPLIT ? GW : 1][4];
  int xsum[GW], xsumh[GW];
  float acc[B][2][GW][4];  // with wu == 1: the folded f32 sums
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    xsum[j] = xsumh[j] = 0;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[b][mt][j][e] = 0;
          acc[b][mt][j][e] = 0.f;
          if constexpr (SPLIT) dh[b][mt][j][e] = 0;
        }
  }
  if (ranks > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the chunk terms go to rank 0's shared memory (its own, without a cluster)
  float* my_terms = (ranks > 1 ? cg::this_cluster().map_shared_rank(term_s, 0) : term_s) +
                    (size_t)ru * nch * NA * 32 + lane;
  int* my_tab = tab + (size_t)cw * slots * NA * 32 + lane;
  auto at = [](int b, int mt, int j, int e) { return ((b * 2 + mt) * GW + j) * 4 + e; };

  // dd -= 8 * the row sums of its activations (the nibbles' bias); part = 0
  auto debias = [&](int (&dd)[B][2][GW][4], int (&part)[GW]) {
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      int v = part[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int s0 = __shfl_sync(0xffffffffu, v, 8 * t4);
      const int s1 = __shfl_sync(0xffffffffu, v, 8 * t4 + 4);
      part[j] = 0;
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[b][mt][j][e] -= 8 * ((e & 1) ? s1 : s0);
    }
  };
  // the fold of dots dd of chunk c (int4: of weight group grp) with
  // __fmul_rn/__fadd_rn: with wu == 1 the sums += its terms, else the
  // terms stored in fragment order ([chunk][NA][32]) for the end; dd = 0
  auto fold = [&](int (&dd)[B][2][GW][4], int c, int grp) {
    float ws[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ws[b][u] = WBITS == 4 ? ws_s[(grp * B + b) * kBoxCols + 4 * g + u] : 0.f;
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      if (!live[j]) continue;
      float r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) r[h] = rs_s[(rows[j][h] - row0) * nch + c];
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t = (float)dd[b][mt][j][e];
            if constexpr (WBITS == 4)
              t = __fmul_rn(__fmul_rn(t, ws[b][2 * mt + (e >> 1)]), r[e & 1]);
            else
              t = __fmul_rn(t, r[e & 1]);
            if (lazy)
              my_terms[((size_t)c * NA + at(b, mt, j, e)) * 32] = t;
            else
              acc[b][mt][j][e] = __fadd_rn(acc[b][mt][j][e], t);
          }
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < GW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[b][mt][j][e] = 0;
  };
  // dots kept in the warp's table slot sl until the unit folds
  auto keep = [&](int (&dd)[B][2][GW][4], int sl) {
    int* t = my_tab + (size_t)sl * NA * 32;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < GW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            t[at(b, mt, j, e) * 32] = dd[b][mt][j][e];
            dd[b][mt][j][e] = 0;
          }
  };
  auto fetch = [&](int (&dd)[B][2][GW][4], int sl) {
    const int* t = my_tab + (size_t)sl * NA * 32;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < GW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[b][mt][j][e] = t[at(b, mt, j, e) * 32];
  };
  for (int u = uu; u < units; u += wu) {
    const int r = u / wu, nr = units - r * wu < wu ? units - r * wu : wu, ug = ub + u;
    for (int t = 0; t < spu; ++t) {
      const Load ld = load_of(r * wu * spu + t * nr + (u - r * wu));  // this warp's ring load
      const int s = ld.slot;
      mbar_wait(&full[s], ld.parity);
      const uint8_t* wst = smem + (size_t)s * sbytes;
      for (int sub = 0; sub < nsub; ++sub) {
        const uint8_t* xs = wst + B * box_bytes + sub * tile;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // 8 word rows a 32-k step
          if (!live[0]) break;  // a warp with no rows (the slab's last) only releases
          // every fragment's loads first, then the products, without a
          // branch between them (a group past the rows reads the warp's
          // first group and its products are never folded)
          uint32_t bl[GW][2], bh[GW][2];
#pragma unroll
          for (int j = 0; j < GW; ++j) {
            const int xr = 8 * (ru * GW + (live[j] ? j : 0)) + slot_row(g);
            const uint2 lo = *reinterpret_cast<const uint2*>(xs + swz(xr, 32 * ks + 8 * t4));
            bl[j][0] = lo.x;
            bl[j][1] = lo.y;
            if constexpr (WBITS == 4) {
              const uint2 hi = *reinterpret_cast<const uint2*>(xs + nsub * tile +
                                                               swz(xr, 32 * ks + 8 * t4));
              bh[j][0] = hi.x;
              bh[j][1] = hi.y;
            }
          }
          uint32_t a[B][2][4], ah[B][2][4];
          const int wrow = sub * kStepWords + 8 * ks + 2 * t4;
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const uint4 u0 = *reinterpret_cast<const uint4*>(wst + b * box_bytes + swz(wrow, 16 * g));
            const uint4 u1 =
                *reinterpret_cast<const uint4*>(wst + b * box_bytes + swz(wrow + 1, 16 * g));
            // m-tile mt: slot g is column 4g + 2 mt, slot g + 8 column 4g + 2 mt + 1
            const uint32_t raw[2][4] = {{u0.x, u0.y, u1.x, u1.y}, {u0.z, u0.w, u1.z, u1.w}};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if constexpr (WBITS == 4) {  // the biased nibbles, 0..15
                  a[b][mt][q] = raw[mt][q] & 0x0F0F0F0Fu;
                  ah[b][mt][q] = (raw[mt][q] >> 4) & 0x0F0F0F0Fu;
                } else {
                  a[b][mt][q] = raw[mt][q];
                }
              }
          }
#pragma unroll
          for (int j = 0; j < GW; ++j) {
#pragma unroll
            for (int b = 0; b < B; ++b)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) w4a8::mma_s8(d[b][mt][j], a[b][mt], bl[j]);
            if constexpr (WBITS == 4) {
              xsum[j] = __dp4a((int)bl[j][0], 0x01010101,
                               __dp4a((int)bl[j][1], 0x01010101, xsum[j]));
              const int hs =
                  __dp4a((int)bh[j][0], 0x01010101, __dp4a((int)bh[j][1], 0x01010101, 0));
              if constexpr (SPLIT)
                xsumh[j] += hs;
              else
                xsum[j] += hs;
#pragma unroll
              for (int b = 0; b < B; ++b)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  if constexpr (SPLIT)
                    w4a8::mma_s8(dh[b][mt][j], ah[b][mt], bh[j]);
                  else
                    w4a8::mma_s8(d[b][mt][j], ah[b][mt], bh[j]);
                }
            }
          }
        }
        // the chunks this 32-row step completes
        const int step = ld.step + sub;
        if constexpr (SPLIT) {
          // a low chunk and a high chunk end together (chunk divides the half)
          const int pos = step * kStepWords % (p.group / 8);
          if ((4 * pos + 128) % p.chunk == 0) {
            debias(d, xsum);
            debias(dh, xsumh);
            const int lo_sl = 4 * pos / p.chunk;
            fold(d, ug * cpu + lo_sl, ug);
            if (lazy)
              fold(dh, ug * cpu + cpu / 2 + lo_sl, ug);
            else
              keep(dh, lo_sl);  // it folds after the group's low chunks
          }
        } else if constexpr (WBITS == 8) {
          const int kr = step * 128;  // a unit of several chunks
          if (cpu > 1 && (kr + 128) % p.chunk == 0) fold(d, kr / p.chunk, 0);
        }
      }
      release_stage(&empty[s], lane);  // the stage's words are in registers
    }
    // the unit's end
    if constexpr (SPLIT) {
      for (int sl = 0; sl < slots; ++sl) {  // wu == 1: the group's high chunks
        fetch(dh, sl);
        fold(dh, ug * cpu + cpu / 2 + sl, ug);
      }
    } else if (cpu == 1) {
      if constexpr (WBITS == 4) debias(d, xsum);
      fold(d, ug, ug);  // chunk == unit: its chunk index, and at int4 its group
    }
  }

  // ------------------------------------------------------------ epilogue
  // each warp of a row set takes the outputs (mt, j, e) of its turn, every
  // box's: where warps split the units, their sums of the chunk terms in
  // chunk order once every warp has stored its terms; in a cluster rank 0's
  // warps, once every rank's have
  if (ranks > 1) {
    cg::this_cluster().sync();
    if (rank != 0) return;
  } else if (lazy) {
    asm volatile("bar.sync 2, %0;\n" ::"r"(32 * warps) : "memory");
  }
  auto total = [&](int b, int mt, int j, int e) {
    if (!lazy) return acc[b][mt][j][e];
    const int i = at(b, mt, j, e);
    float sum = 0.f;
    for (int c = 0; c < nch; ++c) sum = __fadd_rn(sum, my_terms[((size_t)c * NA + i) * 32]);
    return sum;
  };
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    if (!live[j]) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (((j * 2 + mt) * 4 + e) % wu != uu) continue;
        const int row = rows[j][e & 1], u = 2 * mt + (e >> 1);
        if (row >= p.m) continue;
        if constexpr (EPI == kSwiGLU) {
          const int jc = cols[0][u];  // gate column jc pairs with up column f + jc
          if (jc >= f) continue;
          float gate = total(0, mt, j, e), up = total(1, mt, j, e);
          if constexpr (WBITS == 8) {
            gate = __fmul_rn(gate, ws_s[4 * g + u]);
            up = __fmul_rn(up, ws_s[kBoxCols + 4 * g + u]);
          }
          p.out[(size_t)row * f + jc] = gate * (1.f / (1.f + expf(-gate))) * up;
        } else {
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const int col = cols[b][u];
            if (col >= p.n) continue;
            float v = total(b, mt, j, e);
            if constexpr (WBITS == 8) v = __fmul_rn(v, ws_s[b * kBoxCols + 4 * g + u]);
            const size_t o = (size_t)row * p.n + col;
            p.out[o] = EPI == kResidF32 ? __fadd_rn(p.resid[o], v) : v;
          }
        }
      }
  }
}

// Checks the operands and the plan, encodes the tensor maps and launches
// core_kernel on `s` with programmatic dependent launch; returns the
// launch's error (cudaErrorInvalidValue for what the kernel does not take).
template <int WBITS, int EPI, int GW, bool SPLIT>
cudaError_t launch(const Args& p, const Plan& pl, cudaStream_t s) {
  const int words = p.k / (WBITS == 4 ? 8 : 4);
  CUtensorMap x_map, w_map;
  // the activations as (K / 128 slices, rows, 128 bytes)
  const cuuint64_t x_dims[3] = {(cuuint64_t)kSliceBytes, (cuuint64_t)p.m,
                                (cuuint64_t)(p.k / kSliceBytes)};
  const cuuint64_t x_strides[2] = {(cuuint64_t)p.k, (cuuint64_t)kSliceBytes};
  const cuuint32_t x_box[3] = {kSliceBytes, (cuuint32_t)pl.slab_rows,
                               (cuuint32_t)(pl.stage_rows / kStepWords)};
  if (!encode_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, p.xq, x_dims, x_strides, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // TMA rows must be 16-byte strided: the words' when N % 4 == 0
  const int w_tma = p.n % 4 == 0;
  const cuuint64_t w_dims[2] = {(cuuint64_t)p.n, (cuuint64_t)words};
  const cuuint64_t w_strides[1] = {(cuuint64_t)p.n * 4};
  const cuuint32_t w_box[2] = {kBoxCols, (cuuint32_t)pl.stage_rows};
  if (w_tma && !encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, p.w, w_dims, w_strides,
                           w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (!w_tma) w_map = x_map;  // unused
  const auto kernel = core_kernel<WBITS, EPI, GW, SPLIT>;
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int out_cols = EPI == kSwiGLU ? p.n / 2 : p.n;
  const int strip = EPI == kSwiGLU ? kBoxCols : boxes_of(EPI) * kBoxCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_cols + strip - 1) / strip * pl.ranks,
                     (p.m + pl.slab_rows - 1) / pl.slab_rows);
  cfg.blockDim = dim3(32 * (1 + pl.wr * pl.wu));
  cfg.dynamicSmemBytes = smem_bytes(WBITS, EPI, p.k, p.group, p.chunk, pl);
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = pl.ranks;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = pl.ranks > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, x_map, w_map, w_tma, p, pl,
                            table_slots(WBITS, p.group, p.chunk, pl));
}

// What the core takes (the wrapper, ops/mega_decode.py::mega_project,
// checks the same): int4 K % 256, group % 256, K % group, chunk % 128, and
// chunk == group or, with the f32 residual epilogue, (group / 2) % chunk;
// int8 K % 128, chunk % 128, K % chunk; SwiGLU an even N; a plan with gw 1
// or 2, at most 9 consumer warps (4 to split units), slab rows a multiple
// of 8 within what
// its row sets cover, 32, 64 or 128 word rows a stage, units of whole
// stages (at int4 the group; at int8 whole chunks) that divide K, 1-24
// stages that its unit warps share out evenly, and its shared memory within
// the H100's 227 KB.
inline bool takes(int wbits, int epi, const Args& p, const Plan& pl) {
  if (p.m < 1 || p.n < 1 || p.k < 1 || p.chunk < 1) return false;
  if (epi != kStoreF32 && epi != kResidF32 && epi != kSwiGLU) return false;
  if (epi == kSwiGLU && p.n % 2) return false;
  if (wbits == 4) {
    if (p.group < 1 || p.k % 256 || p.group % 256 || p.k % p.group || p.chunk % 128) return false;
    if (p.chunk != p.group && (epi != kResidF32 || (p.group / 2) % p.chunk)) return false;
    if (pl.unit_k != p.group) return false;
  } else if (wbits == 8) {
    if (p.k % 128 || p.chunk % 128 || p.k % p.chunk) return false;
    if (pl.unit_k < p.chunk || pl.unit_k % p.chunk || p.k % pl.unit_k) return false;
  } else {
    return false;
  }
  if (pl.stage_rows != 32 && pl.stage_rows != 64 && pl.stage_rows != 128) return false;
  if ((pl.unit_k / (wbits == 4 ? 8 : 4)) % pl.stage_rows) return false;
  if ((pl.gw != 1 && pl.gw != 2) || pl.wr < 1 || pl.wu < 1 || pl.wu > kMaxUnitWarps ||
      pl.wr * pl.wu > kMaxWarps || pl.stages % pl.wu)
    return false;
  // every rank of a cluster takes at least one unit
  if (pl.ranks < 1 || pl.ranks > kMaxRanks || p.k / pl.unit_k < pl.ranks) return false;
  if (pl.slab_rows < 8 || pl.slab_rows % 8 || pl.slab_rows > 8 * pl.gw * pl.wr ||
      pl.slab_rows > kMaxSlabRows || pl.stages < 1 || pl.stages > kMaxStages)
    return false;
  return smem_bytes(wbits, epi, p.k, p.group, p.chunk, pl) <= (size_t)kSmemLimit;
}

template <int WBITS, int EPI, int GW>
cudaError_t project_gw(const Args& p, const Plan& pl, cudaStream_t s) {
  if constexpr (WBITS == 4 && EPI == kResidF32) {
    if (split_halves(WBITS, p.group, p.chunk)) return launch<WBITS, EPI, GW, true>(p, pl, s);
  }
  return launch<WBITS, EPI, GW, false>(p, pl, s);
}

// One weight phase at the weights' width and epilogue EPI.
template <int WBITS, int EPI>
cudaError_t project(const Args& p, const Plan& pl, cudaStream_t s) {
  if (!takes(WBITS, EPI, p, pl)) return cudaErrorInvalidValue;
  return pl.gw == 1 ? project_gw<WBITS, EPI, 1>(p, pl, s) : project_gw<WBITS, EPI, 2>(p, pl, s);
}

}  // namespace mc
