// K1: flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces mmor_tpu/ops/attention.py::flash_attention (_flash_kernel /
// _flash_forward, the pl.pallas_call at :188).
//
// What bounds it on the H100: at the main path's shapes (CLIP 577 keys,
// pooler 4032, LLaMA prefill 708, PTv3 patches) attention is bound by the
// bf16 tensor-core rate on the QK^T and PV products of the visible pairs;
// q, k and v are read once per 128-query tile.
//
// Design. The TPU kernel walks the key blocks as a sequential grid axis with
// the running max, sum and accumulator in VMEM scratch; a Hopper block
// cannot carry state across grid steps, so the key walk is a loop inside the
// block with that state in registers. The work items are 128 queries of one
// (batch, head); one block an SM (persistent) draws them in order from a
// counter the prologue zeroes, so that their costs (causal, skipped tiles)
// balance and the loads of an item's Q (two Q buffers) and first K/V tiles
// overlap the previous item's last products. A block is three warpgroups:
//  - a producer warpgroup, of which one warp loads each item's Q tile and
//    keeps a ring of K and V tiles (128 keys each; 2 stages at head dim
//    128, 3 below) in flight with TMA, one full and one empty mbarrier a
//    stage, in the swizzle wgmma reads (32, 64 or 128 bytes: the head dim's
//    row, at most 128, so head dim 128 is two 64-column spans); it also
//    stages the tile's key segment ids;
//  - two consumer warpgroups of 64 queries each. S = Q K^T is one
//    wgmma.m64n128k16 a 16-column step of the head dim, both operands
//    K-major in shared memory. The softmax runs in base 2 on S in
//    registers, log2(e) * sm_scale folded into one multiply, exp2 on the
//    special-function unit. P, rounded to bf16 where the reference casts
//    its weights to v.dtype, is the A operand of O += P V straight from the
//    S registers (the f32 accumulator's layout is the bf16 A fragment's),
//    and V, stored row by row along the head dim, is the MN-major B operand
//    that the descriptor's transpose bit reads: no shuffle of V. At head
//    dim 64 and up the two take turns to issue S (named barriers), so that
//    one's softmax overlaps the other's product; at 16 and 32, where S is
//    one or two steps, the turns cost more than they hide.
// The producer gives its registers to the consumers (setmaxnreg), but ptxas
// compiles every thread within the launch's 168 registers (12 warps, three
// on each SM sub-partition): head dim 128 spills 72 bytes. On the H100 this
// form still ran faster than 8 warps that load from within a consumer warp
// (up to 255 registers each, no spills): there the loading warp stalls its
// warpgroup's products while it waits for the other to release a stage.
// Skipping: a prologue kernel gives each 128-row query tile and each 128-key
// tile the [min, max] of its segment ids and their set modulo 32 as bits
// (ops/attention.py::flash_tiles is the rule); a key tile whose range is
// disjoint from the query tile's, whose ids share no bit with its ids
// (PTv3's tile that holds a patch's end and the -1 tail meets only those
// two), or that lies wholly above the causal diagonal (key j is visible to
// query i iff j <= i + Sk - Sq) holds no visible pair and is neither loaded
// nor multiplied. A visited tile whose keys all share the query tile's single
// segment and lie below the diagonal needs no per-element mask; one whose
// keys share a segment compares each row's segment once; otherwise a thread
// loads its 32 keys' ids 8 at a time (8-byte loads) before it compares
// them. Masked logits carry no weight, and a query row with no visible key
// stores 0, as the TPU kernel's finish step intends.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 128;  // queries an item, 64 a consumer warpgroup
constexpr int kBlockK = 128;  // keys a tile
constexpr int kThreads = 384;  // consumers 0-255, producer 256-383

template <int D>
struct Geo {
  static constexpr int kSpanCols = D < 64 ? D : 64;  // head-dim columns a swizzle span
  static constexpr int kSpan = kSpanCols * 2;        // its bytes: 32, 64 or 128
  static constexpr int kSpans = D / kSpanCols;
  static constexpr uint32_t kLayout = gmma_layout(kSpan);
  static constexpr int kQBytes = kBlockQ * D * 2;  // one of two Q buffers
  static constexpr int kKVBytes = kBlockK * D * 2;  // K or V, one tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kRingOffset = 2 * kQBytes;
  static constexpr int kSegOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kBarOffset = kSegOffset + kStages * kBlockK * 4;
  static constexpr int kSmem = kBarOffset + (2 * kStages + 4) * 8 + 2 * 4 + 1024;
};

// two f32 values rounded to bf16 in one register, the first in the low half
// (one cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (exp2(-inf) = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t db) {
  if constexpr (D == 16) wgmma_rs_bf16_n16(o, p, db, 1);
  else if constexpr (D == 32) wgmma_rs_bf16_n32(o, p, db, 1);
  else if constexpr (D == 64) wgmma_rs_bf16_n64(o, p, db, 1);
  else wgmma_rs_bf16_n128(o, p, db, 1);
}

// The key tiles a block visits (both roles walk the same list): those that
// start before kv_end, whose id range meets the query tile's, and whose ids
// share a value modulo 32 with the query tile's (ops/attention.py::
// flash_tiles). A tile is (min, max, bits) in `kt`.
struct Walk {
  const int* kt;  // (tiles, 3) of this batch row's key tiles
  int qmin, qmax, qbits, kv_end;
  __device__ __forceinline__ bool visit(int j) const {
    return j * kBlockK < kv_end && kt[3 * j] <= qmax && kt[3 * j + 1] >= qmin &&
           (kt[3 * j + 2] & qbits) != 0;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, const int* __restrict__ q_tiles,
                 const int* __restrict__ k_tiles, __nv_bfloat16* __restrict__ o, int heads,
                 int sq, int sk, int causal, float scale_log2, int nqt, int n_items,
                 int* __restrict__ next_item) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned for the 128-byte swizzle; offset from the __shared__ array
  // so that accesses compile to shared-memory loads, not generic ones
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* seg_s = reinterpret_cast<int*>(smem + G::kSegOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBarOffset);
  uint64_t* empty = full + G::kStages;
  uint64_t* q_full = empty + G::kStages;  // two each: one a Q buffer
  uint64_t* q_empty = q_full + 2;
  int* item_s = reinterpret_cast<int*>(q_empty + 2);  // the item in each Q buffer
  const int nkt = (sk + kBlockK - 1) / kBlockK;
  const int offset = sk - sq;  // causal: key j visible to query i iff j <= i + offset
  // Work item i is query tile i % nqt of (batch*head) i / nqt. The producer
  // takes the next item from a counter shared by the blocks (the items'
  // costs differ: causal, skipped tiles), in order, so that the items in
  // flight share their heads' K and V in L2.
  auto item = [&](int i, int& q0, int& bh, int& b, Walk& walk) {
    const int qt = i % nqt;
    bh = i / nqt;
    b = bh / heads;
    q0 = qt * kBlockQ;
    walk.kt = k_tiles + (size_t)b * nkt * 3;
    const int* q_tile = q_tiles + ((size_t)b * nqt + qt) * 3;
    walk.qmin = q_tile[0];
    walk.qmax = q_tile[1];
    walk.qbits = q_tile[2];
    walk.kv_end = causal ? min(sk, min(sq, q0 + kBlockQ) + offset) : sk;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, one with the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&q_full[q], 1);
      mbar_init(&q_empty[q], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // ---------------------------------- producer
    regs_dec<40>();
    if (threadIdx.x >= 288) return;  // one warp loads
    const int lane = threadIdx.x % 32;
    int t = 0;  // tiles loaded, over all of this block's items
    for (int it = 0;; ++it) {
      const int qb = it & 1;  // Q buffer, free once the consumers have left it
      if (it >= 2) mbar_wait(&q_empty[qb], ((it >> 1) - 1) & 1);
      int i = 0;
      if (lane == 0) item_s[qb] = i = atomicAdd(next_item, 1);
      i = __shfl_sync(0xffffffffu, i, 0);
      if (i >= n_items) {  // no items left: the consumers read that and stop
        if (lane == 0) mbar_arrive(&q_full[qb]);
        break;
      }
      int q0, bh, b;
      Walk walk;
      item(i, q0, bh, b, walk);
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[qb], G::kQBytes);
#pragma unroll
        for (int a = 0; a < G::kSpans; ++a)
          tma_load_3d(smem + qb * G::kQBytes + a * kBlockQ * G::kSpan, &q_map, &q_full[qb],
                      a * G::kSpanCols, q0, bh);
      }
      for (int j = 0; j < nkt; ++j) {
        if (!walk.visit(j)) continue;
        const int s = t % G::kStages;
        if (t >= G::kStages) mbar_wait(&empty[s], ((t / G::kStages) - 1) & 1);
        const int k0 = j * kBlockK;
#pragma unroll
        for (int e = 0; e < kBlockK / 32; ++e) {
          const int key = k0 + e * 32 + lane;
          seg_s[s * kBlockK + e * 32 + lane] = key < sk ? kv_seg[(size_t)b * sk + key] : 0;
        }
        if (lane == 0) {
          uint8_t* kt = smem + G::kRingOffset + s * G::kStageBytes;
          mbar_arrive_expect_tx(&full[s], G::kStageBytes);
#pragma unroll
          for (int a = 0; a < G::kSpans; ++a) {
            tma_load_3d(kt + a * kBlockK * G::kSpan, &k_map, &full[s], a * G::kSpanCols, k0, bh);
            tma_load_3d(kt + G::kKVBytes + a * kBlockK * G::kSpan, &v_map, &full[s],
                        a * G::kSpanCols, k0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        ++t;
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  regs_inc<232>();
  const int cw = threadIdx.x / 128;  // rows 64cw.. of the block
  // At head dim 64 and up the warpgroups take turns to issue S = Q K^T
  // (named barriers 1 and 2), so that one's softmax runs while the other's
  // product does; warpgroup 0 goes first.
  constexpr bool kTurns = D >= 64;
  if (kTurns && cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int t = 0;  // tiles consumed, over all of this block's items
  for (int it = 0;; ++it) {
    const int qb = it & 1;
    mbar_wait(&q_full[qb], (it >> 1) & 1);
    const int i = item_s[qb];
    if (i >= n_items) break;
    int q0, bh, b;
    Walk walk;
    item(i, q0, bh, b, walk);
    int rows[2], seg_q[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = q0 + cw * 64 + warp * 16 + g + 8 * r;
      seg_q[r] = rows[r] < sq ? q_seg[(size_t)b * sq + rows[r]] : 0;
    }
    const bool one_seg = walk.qmin == walk.qmax;

    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

    const uint32_t q_addr = smem_u32(smem + qb * G::kQBytes) + cw * 64 * G::kSpan;
    for (int j = 0; j < nkt; ++j) {
      if (!walk.visit(j)) continue;
      const int s = t % G::kStages;
      mbar_wait(&full[s], (t / G::kStages) & 1);
      const uint32_t k_addr = smem_u32(smem + G::kRingOffset + s * G::kStageBytes);
      const uint32_t v_addr = k_addr + G::kKVBytes;
      const int k0 = j * kBlockK;

      // S = Q K^T: 64 x 128 a warpgroup, D / 16 steps along the head dim
      float sc[64];
      if (kTurns) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / G::kSpanCols) * (kBlockK * G::kSpan) +
                             (kk * 16 % G::kSpanCols) * 2;
        const uint32_t qoff = (kk * 16 / G::kSpanCols) * (kBlockQ * G::kSpan) +
                              (kk * 16 % G::kSpanCols) * 2;
        wgmma_ss_bf16_n128(sc, gmma_desc(q_addr + qoff, 16, 8 * G::kSpan, G::kLayout),
                           gmma_desc(k_addr + off, 16, 8 * G::kSpan, G::kLayout), kk > 0);
      }
      wgmma_commit();
      if (kTurns) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
      wgmma_wait<0>();
      fence_regs(sc);

      // mask where some pair of the tile may be invisible
      const int kr_min = walk.kt[3 * j], kr_max = walk.kt[3 * j + 1];
      const bool whole = k0 + kBlockK <= sk && one_seg && kr_min == kr_max &&
                         kr_min == walk.qmin &&
                         (!causal || k0 + kBlockK - 1 <= q0 + offset);
      if (!whole && kr_min == kr_max) {
        // one segment among the tile's keys: a row sees the tile's keys iff
        // its segment is that one
        const bool row_ok[2] = {seg_q[0] == kr_min, seg_q[1] == kr_min};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const int key = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
          bool ok = row_ok[r] && key < sk;
          if (causal) ok = ok && key <= rows[r] + offset;
          if (!ok) sc[i] = -INFINITY;
        }
      } else if (!whole) {
        // per key: a thread's 32 keys, 8 at a time, two ids an 8-byte load
        const int* ks = seg_s + s * kBlockK;
#pragma unroll
        for (int c0 = 0; c0 < 16; c0 += 4) {
          int2 kv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            kv[c] = *reinterpret_cast<const int2*>(ks + (c0 + c) * 8 + t4 * 2);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int i = c0 * 4 + e;
            const int r = (i >> 1) & 1;
            const int key = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
            const int kseg = (i & 1) ? kv[e >> 2].y : kv[e >> 2].x;
            bool ok = key < sk && kseg == seg_q[r];
            if (causal) ok = ok && key <= rows[r] + offset;
            if (!ok) sc[i] = -INFINITY;
          }
        }
      }
      // online softmax in base 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
        alpha[r] = fast_exp2(m_i[r] - m_use[r]);
        m_i[r] = m_new;
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m_use[r]));  // masked: exp2(-inf) = 0
        l_i[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P's bf16 A fragments are the S accumulator's registers in order
      uint32_t p[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, p[kk], gmma_desc(v_addr + kk * 16 * G::kSpan, kBlockK * G::kSpan,
                                          8 * G::kSpan, G::kLayout));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++t;
    }

    __syncwarp();  // every S product of the item is done: its Q buffer is free
    if (lane == 0) mbar_arrive(&q_empty[qb]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
    __nv_bfloat16* ob = o + (size_t)bh * sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= sq) continue;
      const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int col = c * 8 + t4 * 2;
        *reinterpret_cast<uint32_t*>(ob + (size_t)rows[r] * D + col) =
            pack_bf16(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
      }
    }
  }
}

// The prologue: each 128-row tile's (min, max, bits of ids modulo 32) of
// the query (blockIdx.z 0) and key (1) segment ids, as
// ops/attention.py::segment_tiles computes them (positions past the end
// take the last id), one block a tile, one thread a position; and the main
// kernel's item counter set to 0.
static_assert(kBlockQ == kBlockK, "one prologue block a tile of either kind");
__global__ void __launch_bounds__(kBlockK)
seg_tiles_kernel(const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 int* __restrict__ q_tiles, int* __restrict__ k_tiles, int sq, int sk,
                 int* __restrict__ next_item) {
  __shared__ int red[3][kBlockK / 32];
  if (blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0) *next_item = 0;
  const bool key = blockIdx.z == 1;
  const int s = key ? sk : sq, tiles = (s + kBlockK - 1) / kBlockK;
  if ((int)blockIdx.x >= tiles) return;
  const int b = blockIdx.y, warp = threadIdx.x / 32;
  const int id = (key ? kv_seg : q_seg)[(size_t)b * s + min((int)(blockIdx.x * kBlockK + threadIdx.x), s - 1)];
  const int lo = __reduce_min_sync(0xffffffffu, id), hi = __reduce_max_sync(0xffffffffu, id);
  const unsigned bits = __reduce_or_sync(0xffffffffu, 1u << (id & 31));
  if (threadIdx.x % 32 == 0) red[0][warp] = lo, red[1][warp] = hi, red[2][warp] = (int)bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t[3] = {red[0][0], red[1][0], red[2][0]};
    for (int w = 1; w < kBlockK / 32; ++w)
      t[0] = min(t[0], red[0][w]), t[1] = max(t[1], red[1][w]), t[2] |= red[2][w];
    int* out = (key ? k_tiles : q_tiles) + ((size_t)b * tiles + blockIdx.x) * 3;
    out[0] = t[0], out[1] = t[1], out[2] = t[2];
  }
}

// (B*H, S, D) bf16 as a 3-D map {D, S, B*H}, boxes of `rows` x one swizzle span
template <int D>
bool seq_map(CUtensorMap* map, const void* base, int s, int bh, int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)s * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::kSpanCols, (cuuint32_t)rows, 1};
  const CUtensorMapSwizzle sw = G::kSpan == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, sw);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_seg,
                   const void* kv_seg, void* q_tiles, void* k_tiles, int* next_item, void* o,
                   int bh, int heads, int sq, int sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!seq_map<D>(&q_map, q, sq, bh, kBlockQ) || !seq_map<D>(&k_map, k, sk, bh, kBlockK) ||
      !seq_map<D>(&v_map, v, sk, bh, kBlockK))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int nqt = (sq + kBlockQ - 1) / kBlockQ, nkt = (sk + kBlockK - 1) / kBlockK;
  seg_tiles_kernel<<<dim3(max(nqt, nkt), bh / heads, 2), kBlockK, 0, stream>>>(
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<int*>(q_tiles), static_cast<int*>(k_tiles), sq, sk, next_item);
  static int sms = 0;  // one block an SM, each walking its share of the items
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int n_items = nqt * bh;
  flash_fwd_kernel<D><<<min(n_items, sms), kThreads, Geo<D>::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<const int*>(q_tiles), static_cast<const int*>(k_tiles),
      static_cast<__nv_bfloat16*>(o), heads, sq, sk, causal, sm_scale * 1.4426950408889634f,
      nqt, n_items, next_item);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o: (batch*heads, S, D) bf16 contiguous; q_seg (batch, Sq) and
// kv_seg (batch, Sk) int32; scratch: q_tiles (batch, ceil(Sq / block_q), 3)
// and k_tiles (batch, ceil(Sk / block_k), 3) int32, which the prologue fills
// with each tile's smallest and largest segment id and the bits of its ids
// modulo 32 (ops/attention.py::segment_tiles), and one int32 for the item
// counter. block_q and block_k must be the kernel's tiles (128, 128).
// Returns the launches' cudaError_t.
extern "C" int mmor_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_seg, const void* kv_seg, void* q_tiles,
                                    void* k_tiles, void* next_item, void* o, int bh, int heads,
                                    int sq, int sk, int head_dim, int causal, float sm_scale,
                                    int block_q, int block_k, void* stream) {
  if (block_q != kBlockQ || block_k != kBlockK || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ni = static_cast<int*>(next_item);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, q_seg, kv_seg, q_tiles, k_tiles, ni, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 32: return launch<32>(q, k, v, q_seg, kv_seg, q_tiles, k_tiles, ni, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 64: return launch<64>(q, k, v, q_seg, kv_seg, q_tiles, k_tiles, ni, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 128: return launch<128>(q, k, v, q_seg, kv_seg, q_tiles, k_tiles, ni, o, bh, heads, sq, sk, causal, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
