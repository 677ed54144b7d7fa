// K9: the post-attention tail of a LLaMA block in one persistent launch:
//   x2  = x_res + attn @ Wo                   (f32)
//   h   = rmsnorm(x2) * norm_scale            (rounded to bf16)
//   gu  = h @ Wgu;  m = silu(gu[:, :F]) * gu[:, F:]   (m rounded to bf16)
//   out = x2 + m @ Wd                          (cast to x_res's dtype)
// with int8 weights packed four to an int32 along K (pack_int8_rows) and f32
// per-channel scales applied after each K sum, bf16 operands and f32 sums:
// the numerics of the TPU kernel's body.
//
// Replaces mmor_tpu/ops/fused_mlp.py::fused_o_mlp (_kernel, the
// pl.pallas_call at :186).
//
// What bounds it on the H100: device-memory bytes. At decode (batch 8 or 14)
// each weight byte feeds at most 16 multiply-adds; the 7B tail's three
// weights are 152 MB, 0.045 ms at 3.35 TB/s, and its 4.3 GFLOP take 0.004
// ms of the bf16 tensor cores.
//
// Its first form fetched the weight words with 8-byte loads, a few
// k-steps in flight a warp, drained the stream at each of three grid
// barriers, and reached 37-43% of the byte bound; its own clock put phase 2
// (59% of the bytes) at 52 us against a 27 us bound. This form:
//  - one cooperative launch (cudaLaunchCooperativeKernel) of one block an SM
//    (132 on an H100: the grid is what fits co-resident with the ring's
//    shared memory; a grid that cannot be co-resident fails the launch, it
//    never hangs), three phases of work units:
//      phase 1: x2 by units of 32 columns (one TMA box of words) and 16 batch
//               rows: D / 32 units a row group (128 at D 4096);
//      norm:    the grid writes h = bf16(x2 * factor * norm_scale), each
//               block summing the units' partial sums of x2^2 of the rows it
//               writes, in one fixed order, into their RMS factors;
//      phase 2: units of 32 gate columns with their 32 up columns, so a unit
//               ends with m = bf16(silu(gate) * up) and gu is never stored:
//               ceil(F / 32) units a row group (344 at F 11008);
//      phase 3: out by units of 32 columns, as phase 1 (128);
//    phases 1 and 3 give unit u to block G - 1 - u % G, phase 2 to block
//    u % G, so that the blocks with a third phase-2 unit are those with no
//    phase-1 or phase-3 unit where there are fewer of those than blocks;
//  - warp 0 keeps a ring of stages full by TMA, as many as fit (3 above 8
//    batch rows, 4 up to 8): a stage is two boxes of 128 word rows x 32
//    columns (phases 1 and 3 a unit's 256 consecutive word rows, phase 2
//    its gate and up columns at the same 128; 128-byte swizzle, loaded
//    under L2's evict-first policy: read once) and the x those rows meet:
//    64-k chunks of the row group's 8 or 16 rows from attn, h or m as they
//    lie (128-byte swizzle; one TMA request a stage where K % 64 == 0, a
//    chunk's otherwise). Each stage is released through hopper.cuh's
//    release_stage. The producer walks the block's units of all three
//    phases without waiting for the barriers (no weight depends on an
//    earlier phase), so the next phase's first stages' words are loading
//    before each barrier; their x is loaded once the barrier has passed
//    (the producer issues the x it owes as soon as its block's consumers
//    have passed the barrier; owing x, it checks for a free stage with
//    mbarrier.test_wait, since try_wait can hold it for microseconds);
//  - the barriers are the consumer warps' own (a named barrier in each
//    block, one thread's fenced add to a grid counter and spin, cooperative
//    groups' grid.sync() pattern without warp 0). The counter lives in
//    device memory from launch to launch, one an instantiation: it only
//    grows, by the grid size at each barrier, so a barrier's target is the
//    next multiple of the grid size; a spin past about ten seconds traps;
//  - h and m are written by the consumers with ordinary stores (the generic
//    proxy) and read by TMA (the async proxy) in other blocks: every
//    consumer thread runs fence.proxy.async.global at the start of grid
//    barriers 2 and 3, before the barrier's release; the barrier's thread
//    then tells its block's producer (a release store of the barrier's
//    number to shared memory), which runs the fence again after its acquire
//    load of that number, before the x load (grid_barrier; produce's poll).
//    The producers never read the grid counter: 132 of them polling it
//    slowed every barrier. x2 and the partial sums of x2^2 are read with
//    ordinary loads that bypass L1 (__ldcg);
//  - eight consumer warps take the product transposed, W^T x^T, on
//    mma.m16n8k16 bf16 with f32 sums: 16 weight columns are an m-tile and
//    8 batch rows an n-tile (one n-tile up to 8 rows, two up to 16; more
//    rows are more row groups, each streaming the weights again). A k-step
//    is 4 word rows; lane (g, t4) loads the 16-byte chunk chunk_of(g) (four
//    columns: m-tile 0's fragment rows g, g + 8 the first two, m-tile 1's
//    the last two) of word row t4, whose swizzled places are 8 distinct
//    chunks in each quarter warp. Slots 2t4, 2t4 + 1 hold a word's bytes 0
//    and 2, slots 2t4 + 8, 2t4 + 9 its bytes 1 and 3, so an A pair is two
//    LOP3s and a bf16 subtract on the word (or the word >> 8), exact and
//    without I2F (bf16_mma.cuh's s8_pair_bf16x2), and a B pair is x at k
//    4r, 4r + 2 (or 4r + 1, 4r + 3): one 8-byte shared-memory load of a
//    row's 4 k. h and m are stored with each 4 k in that order ([0, 2, 1,
//    3]); attn (an input) is paired by two byte permutes. n-tile column g is
//    batch row rho(g) = 2(g % 4) + g / 4 of its 8, so that a half warp's x
//    loads fall in 8 distinct swizzled chunks. Each warp takes every eighth
//    k-step of a stage;
//  - every sum is taken in a fixed order that does not depend on the grid:
//    a warp's k-steps in order, the eight warps' partial tiles in warp order
//    in shared memory, a unit's x2^2 row sums by one butterfly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"  // to_float / from_float
#include "bf16_mma.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 8;
constexpr int kThreads = 32 * (1 + kConsumers);  // warp 0 loads
constexpr int kBoxCols = 32;                     // weight columns a TMA box: 128-byte word rows
constexpr int kBoxRows = 128;                    // word rows a box
constexpr int kBoxBytes = kBoxRows * kBoxCols * 4;  // 16 KB
constexpr int kWordBytes = 2 * kBoxBytes;           // a stage's words
constexpr int kXChunks = 2 * kBoxRows * 4 / 64;     // 64-k x boxes of a stage, at most (16)
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024;

// a stage's bytes: its words and the x of up to 16 chunks of 8 NT rows
__host__ __device__ constexpr int stage_bytes(int nt) { return kWordBytes + kXChunks * 8 * nt * 128; }

// each instantiation's grid barrier counter (see the note above)
__device__ unsigned long long g_grid_barrier[4];

struct Args {
  const void* res;         // (B, D) bf16 or f32: x_res
  const float* ns;         // (D,) norm scale
  const float* wos;        // (D,)
  const float* wgus;       // (2F,)
  const float* wds;        // (D,)
  void* out;               // (B, D) in x_res's dtype
  float* x2;               // scratch (B, D) f32
  uint16_t* h;             // scratch (B, D) bf16, each 4 k as [0, 2, 1, 3]
  uint16_t* m;             // scratch (B, F) bf16, the same order
  float* ssq;              // scratch (D/32, B) f32: each column unit's sums of x2^2
  unsigned long long* ns_stamps;  // null, or 5 %globaltimer stamps (see mmor_fused_o_mlp)
  int b, dq, d, f, groups, stages;
  int x3d;  // bit p: phase p's x map is 3-D (K % 64 == 0), a stage's x one TMA box
  float eps;
};

// the six tensor maps: the weights' words and the activations each phase reads
struct Maps {
  CUtensorMap w[3];  // Wo, Wgu, Wd: (K/4, N) words in boxes of 32 columns x 128 word rows
  // attn, h, m: (B, K) bf16 in boxes of 64 k x 8 NT rows, or, where K % 64
  // == 0, viewed as (K / 64, B, 64) in boxes of a stage's 64-k chunks x 8 NT
  // rows x 64 (the same layout in shared memory, one request)
  CUtensorMap x[3];
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the index of k within its 4 as h and m hold it: [0, 2, 1, 3]
__device__ __forceinline__ size_t pair_order(size_t i) {
  return (i & ~(size_t)3) | ((i & 1) << 1) | ((i >> 1) & 1);
}

// n-tile column g's batch row within its 8 (see the note above)
__device__ __forceinline__ int rho(int g) { return ((g & 3) << 1) | (g >> 2); }

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// The consumer warps' grid barrier k (1, 2, 3): every consumer thread's
// earlier writes before any consumer thread's later reads, in every block;
// with kProxy (barriers 2 and 3: h and m) also before the TMA loads (async
// proxy) of them that the producers issue once it has passed. The block's
// producer learns that it has passed from `passed` in shared memory (k).
template <bool kProxy>
__device__ __forceinline__ void grid_barrier(unsigned long long* count, int* passed, int k) {
  if (kProxy) asm volatile("fence.proxy.async.global;\n" ::: "memory");
  consumer_sync();
  if (threadIdx.x == 32) {
    __threadfence();
    const unsigned long long n = gridDim.x;
    const unsigned long long target = (atomicAdd(count, 1ull) / n + 1) * n;
    const long long start = clock64();
    for (;;) {
      unsigned long long v;
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(count) : "memory");
      if (v >= target) break;
      if (clock64() - start > 20000000000LL) __trap();
    }
    __threadfence();  // with the relaxed read that saw the target: an acquire
    asm volatile("st.release.cta.shared.s32 [%0], %1;\n" ::"r"(smem_u32(passed)), "r"(k)
                 : "memory");
  }
  consumer_sync();
}

// block 0's stamp i of the launch's phases, when the caller asked for them
__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.ns_stamps && blockIdx.x == 0 && threadIdx.x == 32) a.ns_stamps[i] = globaltimer();
}

// the 16-byte chunk of a word row (four columns) lane group g loads: in each
// quarter warp (g = 2p, 2p + 1) the two chunks differ in bit 2, so their
// swizzled places over the lanes' four word rows are 8 distinct
__device__ __forceinline__ int chunk_of(int g) { return (g >> 1) | ((g & 1) << 2); }

// A phase's shape (p: 0 o, 1 gate_up, 2 down): its K, its column units
// (phase 2's a gate box with its up box), a unit's stages (256 word rows, or
// phase 2's 128 of both boxes) and the block's first unit (phase 2 u % G,
// phases 1 and 3 G - 1 - u % G).
__device__ __forceinline__ int k_of(const Args& a, int p) { return p == 0 ? a.dq : p == 1 ? a.d : a.f; }
__device__ __forceinline__ int col_units(const Args& a, int p) {
  return p == 1 ? (a.f + kBoxCols - 1) / kBoxCols : a.d / kBoxCols;
}
__device__ __forceinline__ int stages_of(const Args& a, int p) {
  const int rows = p == 1 ? kBoxRows : 2 * kBoxRows;
  return (k_of(a, p) / 4 + rows - 1) / rows;
}
__device__ __forceinline__ int first_unit(int p) {
  return p == 1 ? (int)blockIdx.x : (int)(gridDim.x - 1 - blockIdx.x);
}

// Phase P's k-steps: boxes a k-step (phase 2: gate and up), k-steps of a
// stage a warp takes, and stage-local k-step j's first word row (phase 2's
// 32 k-steps a box pair, the others' 64 over two boxes of consecutive rows).
template <int P> struct Phase {
  static constexpr int kNB = P == 1 ? 2 : 1;
  static constexpr int kSteps = 8 / kNB;
  static __device__ __forceinline__ int step_row(int j) {
    return kNB == 1 ? (j >> 5) * kBoxRows + (j & 31) * 4 : j * 4;
  }
};

// Phase P on the consumer warps: each unit of the block, its stages from the
// ring (i counts the block's stages over all phases), its partial tiles
// folded in shared memory (red), then the phase's epilogue, whose operands
// (scales, x_res or x2) are loaded at the unit's start: under a busy memory
// an L2 read takes microseconds.
template <int P, int NT, typename ResT>
__device__ __forceinline__ void consume(const Args& a, const uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, float* red, int& i) {
  using Ph = Phase<P>;
  constexpr int kNB = Ph::kNB, kW = kBoxCols * kNB;  // red's row: kW columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = warp - 1;
  const int g = lane / 4, t4 = lane % 4, cc = chunk_of(g);
  const int cunits = col_units(a, P), units = cunits * a.groups, nstage = stages_of(a, P);
  const uint32_t fill = 0x43004300u;  // the bf16 pair 128.0, in a register
  const int sbytes = stage_bytes(NT);
  for (int u = first_unit(P); u < units; u += gridDim.x) {
    const int cu = u % cunits, rb = (u / cunits) * 16, col = cu * kBoxCols + lane;
    float sc[kNB], rv[NT];  // the lane's scale(s), and x_res or x2 of its epilogue rows
#pragma unroll
    for (int bi = 0; bi < kNB; ++bi)  // phase 2: gate and up scales (0 past F)
      sc[bi] = P != 1 ? (P == 0 ? a.wos : a.wds)[col] : col < a.f ? a.wgus[bi * a.f + col] : 0.f;
#pragma unroll
    for (int e = 0; e < NT; ++e) {  // batch row rb + c + 8e of the epilogue
      const int gr = rb + c + kConsumers * e;
      rv[e] = 0.f;
      if (P == 0 && gr < a.b)
        rv[e] = to_float(static_cast<const ResT*>(a.res)[(size_t)gr * a.d + col]);
      if (P == 2 && gr < a.b) rv[e] = __ldcg(a.x2 + (size_t)gr * a.d + col);
    }
    float acc[2 * kNB][NT][4] = {};
    for (int st = 0; st < nstage; ++st, ++i) {
      const int s = i % a.stages;
      mbar_wait(&full[s], (i / a.stages) & 1);
      const uint8_t* stg = smem + s * sbytes;
      const uint8_t* xs = stg + kWordBytes;  // [64-k chunk][8 NT rows][128 bytes]
#pragma unroll
      for (int jj = 0; jj < Ph::kSteps; ++jj) {
        const int r = Ph::step_row(c + kConsumers * jj) + t4;  // box r / 128, its row r % 128
        const uint8_t* bx = stg + (r / kBoxRows) * kBoxBytes + (r % kBoxRows) * 128 +
                            ((cc ^ (r & 7)) << 4);
        // x at k 4r .. 4r + 3: chunk r / 16, bytes 8 (r % 16) of each row's 128
        uint32_t xb[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = 8 * nt + rho(g);  // 128-byte swizzle: chunk ^ row % 8
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + ((r >> 4) * 8 * NT + row) * 128 + ((((r & 15) >> 1) ^ (row & 7)) << 4) +
              ((r & 1) << 3));
          if constexpr (P == 0) {  // attn in its natural order: pair k (0, 2) and (1, 3)
            xb[nt][0] = __byte_perm(v.x, v.y, 0x5410);
            xb[nt][1] = __byte_perm(v.x, v.y, 0x7632);
          } else {
            xb[nt][0] = v.x;
            xb[nt][1] = v.y;
          }
        }
#pragma unroll
        for (int bi = 0; bi < kNB; ++bi) {
          const uint4 v = *reinterpret_cast<const uint4*>(bx + bi * kBoxBytes);
          // m-tile 0: fragment rows g, g + 8 = columns 4cc, 4cc + 1; m-tile 1: 4cc + 2, 4cc + 3
          const uint32_t am[2][4] = {
              {s8_pair_bf16x2(v.x, fill), s8_pair_bf16x2(v.y, fill),
               s8_pair_bf16x2(v.x >> 8, fill), s8_pair_bf16x2(v.y >> 8, fill)},
              {s8_pair_bf16x2(v.z, fill), s8_pair_bf16x2(v.w, fill),
               s8_pair_bf16x2(v.z >> 8, fill), s8_pair_bf16x2(v.w >> 8, fill)}};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[2 * bi + mt][nt], am[mt], xb[nt]);
        }
      }
      release_stage(&empty[s], lane);  // the stage's words and x are in registers
    }
    // element e of tile (2bi + mt, nt): column 4cc + 2mt + (e >> 1) of box
    // bi, batch row 8nt + rho(2t4 + (e & 1))
#pragma unroll
    for (int bi = 0; bi < kNB; ++bi)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(c * 8 * NT + 8 * nt + rho(2 * t4 + (e & 1))) * kW + kBoxCols * bi + 4 * cc +
                2 * mt + (e >> 1)] = acc[2 * bi + mt][nt][e];
    consumer_sync();
    // warp c: rows c (and c + 8) of the unit, lane l its column l (of each box)
#pragma unroll
    for (int e = 0; e < NT; ++e) {
      const int row = c + kConsumers * e, gr = rb + row;
      float sum[kNB];
#pragma unroll
      for (int bi = 0; bi < kNB; ++bi) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) t += red[(w * 8 * NT + row) * kW + kBoxCols * bi + lane];
        sum[bi] = t;
      }
      if constexpr (P == 0) {  // x2 = x_res + (attn @ Wo) * wos, and the unit's row sum of x2^2
        float v = 0.f;
        if (gr < a.b) {
          v = rv[e] + sum[0] * sc[0];
          a.x2[(size_t)gr * a.d + col] = v;
        }
        float sq = v * v;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        if (lane == 0 && gr < a.b) a.ssq[(size_t)cu * a.b + gr] = sq;
      } else if constexpr (P == 1) {  // m = bf16(silu(gate) * up)
        if (gr < a.b && col < a.f) {
          const float gate = sum[0] * sc[0], up = sum[1] * sc[1];
          const float sig = 1.f / (1.f + expf(-gate));
          const __nv_bfloat16 mb = __float2bfloat16_rn(gate * sig * up);
          a.m[pair_order((size_t)gr * a.f + col)] = *reinterpret_cast<const uint16_t*>(&mb);
        }
      } else {  // out = x2 + (m @ Wd) * wds
        if (gr < a.b)
          static_cast<ResT*>(a.out)[(size_t)gr * a.d + col] = from_float<ResT>(rv[e] + sum[0] * sc[0]);
      }
    }
    consumer_sync();  // red is free for the next unit
  }
}

// Where the producer is in the block's walk: phase p (3 past its end), unit
// u, stage st.
struct Cursor {
  int p, u, st;
};

// the cursor moved past phases where the block has no unit left
__device__ __forceinline__ void settle(const Args& a, Cursor& c) {
  while (c.p < 3 && c.u >= col_units(a, c.p) * a.groups) {
    ++c.p;
    c.u = c.p < 3 ? first_unit(c.p) : 0;
    c.st = 0;
  }
}
__device__ __forceinline__ void next(const Args& a, Cursor& c) {
  if (++c.st == stages_of(a, c.p)) {
    c.st = 0;
    c.u += gridDim.x;
    settle(a, c);
  }
}

// The producer: stage i of the block's walk (phases 1, 2 and 3 in turn) into
// slot i % stages once the consumers have released the stage it held: its
// words at once (phase 2 a unit's gate columns c0.. and their up columns F
// + c0.. at the same 128 word rows, the others 256 consecutive word rows of
// one box), and the x of its rows once its phase's activations are written
// (phase 1 at once, phase 2 after the second grid barrier, phase 3 after
// the third). The x it owes goes out as soon as the barrier has passed,
// also while it waits for a free slot.
template <int NT>
__device__ __forceinline__ void produce(const Args& a, const Maps& maps, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, const int* passed) {
  const uint64_t policy = l2_evict_first();  // the weights are read once
  const int sbytes = stage_bytes(NT);
  int ready = 1;  // phases whose x is written: 1, then 2 and 3 after barriers 2 and 3
  auto poll = [&]() {
    int k;
    asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n" : "=r"(k) : "r"(smem_u32(passed)) : "memory");
    if (k > ready) {  // h (barrier 2) or m (barrier 3) written: TMA may read them
      ready = k;
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
  };
  auto load_x = [&](const Cursor& c, int i) {
    const int s = i % a.stages, chunks = c.p == 1 ? kXChunks / 2 : kXChunks;
    const int k0 = c.st * chunks * 64, rb = (c.u / col_units(a, c.p)) * 16;
    uint8_t* xs = smem + s * sbytes + kWordBytes;
    if ((a.x3d >> c.p) & 1) {
      tma_load_3d(xs, &maps.x[c.p], &full[s], 0, rb, k0 / 64);
    } else {
      for (int j = 0; j < chunks; ++j)
        tma_load_2d(xs + j * 8 * NT * 128, &maps.x[c.p], &full[s], k0 + 64 * j, rb);
    }
  };
  Cursor c{0, first_unit(0), 0};
  settle(a, c);
  Cursor pend = c;  // the first stage whose x is not loaded yet, stage ipend
  int ipend = 0;
  auto flush = [&](int upto) {  // the x owed for stages ipend .. upto - 1 of ready phases
    while (ipend < upto && pend.p < ready) {
      load_x(pend, ipend);
      ++ipend;
      next(a, pend);
    }
  };
  int i = 0;
  for (; c.p < 3; ++i, next(a, c)) {
    const int s = i % a.stages;
    if (i >= a.stages) {
      const uint32_t addr = smem_u32(&empty[s]), parity = ((i / a.stages) - 1) & 1;
      const long long start = clock64();
      // owing x, it checks the slot without waiting and looks for the barrier
      // between checks
      while (ipend < i ? !mbar_test_wait(addr, parity) : !mbar_try_wait(addr, parity)) {
        if (ipend < i) {
          poll();
          flush(i);
        }
        if (clock64() - start > 20000000000LL) __trap();
      }
    }
    uint8_t* stg = smem + s * sbytes;
    const int chunks = c.p == 1 ? kXChunks / 2 : kXChunks;
    mbar_arrive_expect_tx(&full[s], kWordBytes + chunks * 8 * NT * 128);
    const int c0 = (c.u % col_units(a, c.p)) * kBoxCols;
    const CUtensorMap* map = &maps.w[c.p];
    if (c.p == 1) {
      tma_load_2d_hint(stg, map, &full[s], c0, c.st * kBoxRows, policy);
      tma_load_2d_hint(stg + kBoxBytes, map, &full[s], a.f + c0, c.st * kBoxRows, policy);
    } else {
      tma_load_2d_hint(stg, map, &full[s], c0, 2 * c.st * kBoxRows, policy);
      tma_load_2d_hint(stg + kBoxBytes, map, &full[s], c0, (2 * c.st + 1) * kBoxRows, policy);
    }
    if (ready <= c.p) poll();
    flush(i + 1);
  }
  // the x still owed once the last barrier has passed
  const long long start = clock64();
  while (ipend < i) {
    poll();
    flush(i);
    if (clock64() - start > 20000000000LL) __trap();
  }
}

template <typename ResT, int NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_o_mlp_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + a.stages * stage_bytes(NT));  // [warp][row][column]
  float* inv = red + kConsumers * 8 * NT * 2 * kBoxCols;                      // the norm's row factors
  uint64_t* full = reinterpret_cast<uint64_t*>(inv + 2 * kConsumers);
  uint64_t* empty = full + a.stages;
  int* passed = reinterpret_cast<int*>(inv + kConsumers);  // grid barriers passed
  unsigned long long* count = &g_grid_barrier[(sizeof(ResT) == 2 ? 0 : 2) + NT - 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
    *passed = 0;
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) produce<NT>(a, maps, smem, full, empty, passed);
    return;
  }
  stamp(a, 0);
  // the norm scale of the block's first entry of h, loaded long before the norm
  const size_t hn = (size_t)a.b * a.d, e0 = (size_t)blockIdx.x * 256 + threadIdx.x - 32;
  const float ns0 = e0 < hn ? a.ns[e0 % a.d] : 0.f;
  int i = 0;
  consume<0, NT, ResT>(a, smem, full, empty, red, i);
  grid_barrier<false>(count, passed, 1);
  stamp(a, 1);

  // norm: h = bf16(x2 * rsqrt(mean(x2^2) + eps) * norm_scale), a block a
  // chunk of 256 entries of h at a time. A chunk spans at most 8 rows (D %
  // 32 == 0), and warp c sums the units' partial sums of the chunk's row c,
  // lane l taking units l, l + 32, ..., then a butterfly, which leaves the
  // same sum, in the same order, in every lane and block; only the blocks
  // that write a row read its partial sums.
  {
    const int c = warp - 1, ct = threadIdx.x - 32, dunits = a.d / kBoxCols;
    for (size_t c0 = (size_t)blockIdx.x * 256; c0 < hn; c0 += (size_t)gridDim.x * 256) {
      const int first = (int)(c0 / a.d);
      const int last = (int)min((size_t)a.b - 1, (c0 + 255) / a.d);
      if (first + c <= last) {
        float s = 0.f;
        for (int cu = lane; cu < dunits; cu += 32)
          s += __ldcg(a.ssq + (size_t)cu * a.b + first + c);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) inv[c] = rsqrtf(s / (float)a.d + a.eps);
      }
      consumer_sync();
      const size_t e = c0 + ct;
      if (e < hn) {
        const float v = __ldcg(a.x2 + e) * inv[e / a.d - first] * (e == e0 ? ns0 : a.ns[e % a.d]);
        const __nv_bfloat16 hb = __float2bfloat16_rn(v);
        a.h[pair_order(e)] = *reinterpret_cast<const uint16_t*>(&hb);
      }
      consumer_sync();
    }
  }
  grid_barrier<true>(count, passed, 2);
  stamp(a, 2);
  consume<1, NT, ResT>(a, smem, full, empty, red, i);
  grid_barrier<true>(count, passed, 3);
  stamp(a, 3);
  consume<2, NT, ResT>(a, smem, full, empty, red, i);
  if (a.ns_stamps && threadIdx.x == 32) atomicMax(a.ns_stamps + 4, globaltimer());
}

// a (rows, cols) row-major map of elements of `size` bytes in boxes of
// box_cols x box_rows, 128-byte swizzle
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int size, const void* base, int rows,
            int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * size};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_map(map, type, 2, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// phase p's x map of the (rows, k) bf16 activations: 3-D where k % 64 == 0
// (bit p of x3d set), else 2-D
bool x_map(CUtensorMap* map, int p, const void* base, int rows, int k, int nt, int& x3d) {
  if (k % 64) return map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, k, 64, 8 * nt);
  const int chunks = p == 1 ? kXChunks / 2 : kXChunks;
  const cuuint64_t dims[3] = {64, (cuuint64_t)rows, (cuuint64_t)(k / 64)};
  const cuuint64_t strides[2] = {(cuuint64_t)k * 2, 128};
  const cuuint32_t box[3] = {64, (cuuint32_t)(8 * nt), (cuuint32_t)chunks};
  x3d |= 1 << p;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename ResT, int NT>
cudaError_t launch(const Maps& maps, Args& args, cudaStream_t stream) {
  auto kernel = fused_o_mlp_kernel<ResT, NT>;
  const int fixed = 1024 + (kConsumers * 8 * NT * 2 * kBoxCols + 2 * kConsumers) * 4 + 16 * kMaxStages;
  args.stages = min(kMaxStages, (kSmemMax - fixed) / stage_bytes(NT));
  const int smem = fixed + args.stages * stage_bytes(NT);
  // the grid: as many blocks a multiprocessor as fit, on every one
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* params[] = {const_cast<Maps*>(&maps), &args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(per_sm * sms),
                                  dim3(kThreads), params, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// K9: attn (B, Dq) bf16; res (B, D) bf16 (res_bf16 = 1) or f32; ns (D,) f32;
// wo (Dq/4, D), wgu (D/4, 2F), wd (F/4, D) int32 packed by pack_int8_rows
// with f32 scales wos (D,), wgus (2F,), wds (D,); out (B, D) in res's dtype;
// scratch x2 (B, D) f32, h (B, D) bf16, m (B, F) bf16, ssq (D/32, B) f32.
// stamps: null, or 5 u64 (the fifth zeroed) that receive %globaltimer ns:
// block 0 at its start and after each of the three grid barriers, and the
// last block's end. Dq and F must be multiples of 16, D of 32. Returns the
// launch's cudaError_t (cudaErrorCooperativeLaunchTooLarge if the grid
// cannot be co-resident, cudaErrorNotSupported on a card without
// cooperative launches, cudaErrorInvalidValue for a refused shape or map).
// Launches of one instantiation must not overlap (their grid barriers share
// a counter): one stream, as the wrapper launches them.
extern "C" int mmor_fused_o_mlp(const void* attn, const void* res, const void* ns, const void* wo,
                                const void* wos, const void* wgu, const void* wgus, const void* wd,
                                const void* wds, void* out, void* x2, void* h, void* m, void* ssq,
                                void* stamps, int b, int dq, int d, int f, int res_bf16,
                                float eps, void* stream) {
  if (b < 1 || dq < 16 || dq % 16 || d < kBoxCols || d % kBoxCols || f < 16 || f % 16)
    return (int)cudaErrorInvalidValue;
  const int nt = b <= 8 ? 1 : 2;  // 8-row n-tiles a row group of 16
  const CUtensorMapDataType i32 = CU_TENSOR_MAP_DATA_TYPE_INT32;
  Maps maps;
  int x3d = 0;
  if (!map_2d(&maps.w[0], i32, 4, wo, dq / 4, d, kBoxCols, kBoxRows) ||
      !map_2d(&maps.w[1], i32, 4, wgu, d / 4, 2 * f, kBoxCols, kBoxRows) ||
      !map_2d(&maps.w[2], i32, 4, wd, f / 4, d, kBoxCols, kBoxRows) ||
      !x_map(&maps.x[0], 0, attn, b, dq, nt, x3d) || !x_map(&maps.x[1], 1, h, b, d, nt, x3d) ||
      !x_map(&maps.x[2], 2, m, b, f, nt, x3d))
    return (int)cudaErrorInvalidValue;
  Args args{res, static_cast<const float*>(ns), static_cast<const float*>(wos),
            static_cast<const float*>(wgus), static_cast<const float*>(wds), out,
            static_cast<float*>(x2), static_cast<uint16_t*>(h), static_cast<uint16_t*>(m),
            static_cast<float*>(ssq), static_cast<unsigned long long*>(stamps), b, dq, d, f,
            (b + 15) / 16, 0, x3d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (res_bf16)
    e = nt == 1 ? launch<__nv_bfloat16, 1>(maps, args, s) : launch<__nv_bfloat16, 2>(maps, args, s);
  else
    e = nt == 1 ? launch<float, 1>(maps, args, s) : launch<float, 2>(maps, args, s);
  return (int)e;
}
