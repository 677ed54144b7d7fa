// K4: one-position decode attention against an int8 KV cache stack, and
// K7: the same against one layer's int8 cache.
//
// Replaces mmor_tpu/ops/attention.py::decode_attention_packed_stack
// (_packed_decode_stack_kernel, the pl.pallas_call at :534) and
// mmor_tpu/ops/attention.py::decode_attention_packed (_packed_decode_kernel,
// the pl.pallas_call at :433).
//
// What bounds it on the H100: device-memory bytes. Each (batch, head) reads
// its layer's valid keys and values once (2 x 128 bytes a position at the
// 7B serving shape, 54 MB a layer at batch 8 and 1008 positions) plus two
// scales a position; the arithmetic is a matvec, a few operations a byte.
//
// Numerics (the TPU kernels', attention.py:376-393 and :512-519): q in
// bf16, each logit q . k in f32 times sm_scale times the key scale, masked
// positions DEFAULT_MASK_VALUE, the softmax in f32, its weights times the
// value scales, out = sum_t w v in f32, stored in the output's dtype. A
// row with no valid position takes equal weights over all T, as the TPU's
// softmax of a constant row does.
//
// Design: the port keeps the cache as (L, B, H, T, D) int8 with (L, B, H, T)
// per-position scales instead of the TPU's (L, B, H, D/4, T) int32 words,
// which exist for the TPU's element-rate DMA: a key row is D contiguous
// bytes. The kernel reads layer `layer` of the full stack in place.
//  - One cluster of `ranks` blocks a (batch, head), rank r taking `span`
//    positions from r * span (2 ranks of 512 at T = 1008: 512 blocks of 128
//    threads for the 7B step at batch 8, four resident on each of the 132
//    SMs, where one block a (batch, head) left half of them idle; more
//    ranks, up to 8, where B * H is small).
//  - Each block first scans its row's mask for the first and last valid
//    position, and stages its span's mask and scales in shared memory.
//    Positions outside [first, last] are never loaded (left padding and the
//    cache's unwritten tail); inside, a masked position is zero-filled, not
//    read. (A row with no valid position loads all of T.)
//  - The warps of a block work apart, with no barrier between them: warp w
//    takes the rank's tiles of 16 positions w, w + 4, ..., streaming each
//    tile's key and value rows through a ring of 3 tiles of its own by
//    cp.async, 16 bytes a lane a copy, so that the warp's copies are
//    consecutive bytes, two tiles in flight while one is used (a first
//    form, four warps sharing 64-position tiles with two block barriers a
//    tile, ran at 4.8x the byte bound on the card).
//  - Logits: D/16 lanes a key row, 16 bytes each against 16 channels of q
//    held in registers (int8 converted exactly by a byte permute under an
//    f32 exponent, no I2F), summed by shuffles. D is a template parameter
//    (16 to 256), so a tile's loops unroll and their loads and sums
//    interleave (with D at run time the same kernel took 1.25x as long).
//  - An online softmax a tile and warp: the tile's max and exps' sum by
//    shuffles, the running sums rescaled, and the value rows summed by
//    their weights (a lane 4 channels at D = 128), each weight shuffled
//    from the lane that computed it.
//  - The warps and ranks meet once, through distributed shared memory:
//    rank 0 takes the cluster's max and every warp's rescaled sums and
//    exps' totals, and stores out = sums / total.
// The sums run in another order than the plain version's, so the two differ
// by f32 rounding (and by the plain K4's bf16 weights).
//
// K7 is the same kernel on a one-layer cache (layer 0 of a stack of one),
// templated on the scale type, since its callers pass f32 scales (a bf16
// copy would move them, 0.01 among them) as well as bf16 ones, and on the
// output type (f32 for an f32 query, as the TPU kernel's f32 result cast to
// q's dtype).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLogTile = 4;
constexpr int kTile = 1 << kLogTile;  // positions a warp's staged tile
constexpr int kRing = 3;       // tiles in a warp's ring
constexpr int kSpan = 512;     // positions a rank, at least, where blocks are plenty
constexpr int kMaxRanks = 8;   // the largest portable cluster
constexpr int kFill = 2 * 132; // blocks that fill the card twice over
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the four int8 values of w as f32, exactly: w ^ 0x80808080 holds each q as
// u = q + 128, a byte under the f32 exponent of 2^23 is 2^23 + u, and
// 2^23 + 128 less is q
__device__ __forceinline__ void s8x4_f32(uint32_t w, float* f) {
  const uint32_t wx = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650u + j)) - 8388736.f;
}

// grid B * H * ranks, clusters of `ranks` blocks along x, kThreads threads;
// dynamic shared memory: the warps' rings, then the span's mask and scales.
// The head dim d is a template parameter, so that a tile's loops unroll and
// their independent loads and sums interleave.
template <typename ScaleT, typename OutT, int d>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_stack,
              const int8_t* __restrict__ v_stack, const ScaleT* __restrict__ ks_stack,
              const ScaleT* __restrict__ vs_stack, const int* __restrict__ kv_mask,
              OutT* __restrict__ out, int layer, int batch, int heads, int t_cap, int span,
              float sm_scale) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ float lgw[kWarps][kTile];  // each warp's logits of its tile
  __shared__ int red[2][kWarps];
  __shared__ float x_m[kWarps], x_l[kWarps];  // each warp's max and exps' sum
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / ranks, b = bh / heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t slab = (size_t)layer * batch * heads + bh;  // (l, b, h) index
  const int8_t* kb = k_stack + slab * t_cap * d;
  const int8_t* vb = v_stack + slab * t_cap * d;
  const ScaleT* ksb = ks_stack + slab * t_cap;
  const ScaleT* vsb = vs_stack + slab * t_cap;
  const int* mb = kv_mask + (size_t)b * t_cap;
  const int t0 = min(rank * span, t_cap), t1 = min(t0 + span, t_cap);
  constexpr int slot = 2 * kTile * d;  // a ring slot: a tile's key rows, then its value rows
  uint8_t* ring = dyn + warp * kRing * slot;  // this warp's
  int* m_s = reinterpret_cast<int*>(dyn + kWarps * kRing * slot);
  float* ks_s = reinterpret_cast<float*>(m_s + span);
  float* vs_s = ks_s + span;

  // the row's valid positions [lo, hi); this rank's mask and scales
  int lo = t_cap, hi = 0;
  for (int t = tid; t < t_cap; t += kThreads) {
    const int v = mb[t];
    if (v != 0) {
      lo = min(lo, t);
      hi = t + 1;
    }
    if (t >= t0 && t < t1) {
      m_s[t - t0] = v;
      ks_s[t - t0] = as_float(ksb[t]);
      vs_s[t - t0] = as_float(vsb[t]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kAll, lo, o));
    hi = max(hi, __shfl_xor_sync(kAll, hi, o));
  }
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
  }
  const bool empty = hi == 0;  // no valid position: all of T, equal weights
  if (empty) lo = 0, hi = t_cap;
  const int p0 = max(t0, lo), p1 = min(t1, hi);
  const int ntiles = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;
  // this warp's tiles: warp, warp + kWarps, ...
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;

  // ring load j: the key and value rows of this warp's j-th tile into its
  // slot j % kRing, 16 bytes a lane a copy; one commit group a load (empty
  // past the last tile)
  constexpr int ch = d / 16;  // 16-byte chunks a row, a power of two
  constexpr int lch = ch == 1 ? 0 : ch == 2 ? 1 : ch == 4 ? 2 : ch == 8 ? 3 : 4;
  auto issue = [&](int j) {
    if (j < mine) {
      const int ts = p0 + (warp + kWarps * j) * kTile, tn = min(kTile, p1 - ts);
      uint8_t* dst = ring + (j % kRing) * slot;
      for (int c = lane; c < 2 * kTile * ch; c += 32) {
        const int kv = c >> (lch + kLogTile), r = (c >> lch) & (kTile - 1), cc = c & (ch - 1);
        if (r < tn) {
          const bool on = empty || m_s[ts + r - t0] != 0;
          const int8_t* src = (kv ? vb : kb) + (size_t)(ts + r) * d + cc * 16;
          cp_async16(dst + c * 16, on ? src : kb, on ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) issue(j);

  // logits: lpr lanes a key row, lane l of a row holding q's channels
  // 16l .. 16l + 15; values: lpv lanes a row, cpl channels a lane
  constexpr int lpr = d / 16, rpp = 32 / lpr;
  constexpr int cpl = d <= 128 ? 4 : 8, lpv = d / cpl, rpw = 32 / lpv;
  const int l = lane % lpr, grp = lane / lpr;
  const int vrow = lane / lpv, vc = (lane % lpv) * cpl;
  float qr[16];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + (size_t)bh * d + 16 * l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = qp[h];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        qr[8 * h + 2 * j] = f.x;
        qr[8 * h + 2 * j + 1] = f.y;
      }
    }
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float m_run = -INFINITY, l_run = 0.f;  // this warp's running max and exps' sum

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<kRing - 2>();  // load j has landed (this lane's copies)
    __syncwarp();                // every lane's; and every lane is done with tile j - 1
    issue(j + kRing - 1);        // into tile j - 1's slot
    const uint8_t* kt = ring + (j % kRing) * slot;
    const uint8_t* vt = kt + kTile * d;
    const int ts = p0 + (warp + kWarps * j) * kTile, tn = min(kTile, p1 - ts);

#pragma unroll
    for (int r0 = 0; r0 < kTile; r0 += rpp) {
      const int tt = r0 + grp;
      float dot[2] = {0.f, 0.f};  // two chains of 8 products
      if (tt < tn) {
        const uint4 kw = *reinterpret_cast<const uint4*>(kt + tt * d + 16 * l);
        const uint32_t w[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float f[4];
          s8x4_f32(w[i], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[i / 2] = fmaf(qr[4 * i + e], f[e], dot[i / 2]);
        }
      }
      float sum = dot[0] + dot[1];
#pragma unroll
      for (int o = lpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kAll, sum, o);
      if (l == 0 && tt < kTile) {
        float logit = -INFINITY;  // past the tile's end: no position
        if (tt < tn) {
          const int t = ts + tt - t0;
          logit = m_s[t] != 0 ? sum * sm_scale * ks_s[t] : kMaskValue;
        }
        lgw[warp][tt] = logit;
      }
    }
    __syncwarp();

    // the online softmax: lane i (and i + 16) holds position i of the tile
    const int i = lane % kTile;
    const float x = lgw[warp][i];
    float tmax = x;
    for (int o = kTile / 2; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kAll, tmax, o));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = __expf(m_run - m_new);
    const float e = __expf(x - m_new);
    float esum = e;
    for (int o = kTile / 2; o > 0; o >>= 1) esum += __shfl_xor_sync(kAll, esum, o);
    l_run = l_run * corr + esum;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] *= corr;
    const float wv = i < tn ? e * vs_s[ts + i - t0] : 0.f;  // the exp times the value scale

    // the value rows, rpw a step (past the tile's end the weight is 0)
#pragma unroll
    for (int tb = 0; tb < kTile; tb += rpw) {
      const int tt = tb + vrow;
      const float wt = __shfl_sync(kAll, wv, tt);
      if (wt != 0.f) {
        const uint8_t* vr = vt + tt * d + vc;
        float f[8];
        if constexpr (cpl == 4) {
          s8x4_f32(*reinterpret_cast<const uint32_t*>(vr), f);
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(vr);
          s8x4_f32(u.x, f);
          s8x4_f32(u.y, f + 4);
        }
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < cpl) acc[c] = fmaf(wt, f[c], acc[c]);
      }
    }
  }
  cp_async_wait<0>();

  // lanes holding the same channels; then each warp's sums into its own
  // ring, and the cluster meets
#pragma unroll
  for (int o = lpv; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] += __shfl_xor_sync(kAll, acc[c], o);
  __syncwarp();  // every lane is done with the ring
  float* x_acc = reinterpret_cast<float*>(ring);
  if (vrow == 0)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < cpl) x_acc[vc + c] = acc[c];
  if (lane == 0) {
    x_m[warp] = m_run;
    x_l[warp] = l_run;
  }
  cluster.sync();
  if (rank == 0) {
    float mx = -INFINITY;
    for (int r = 0; r < ranks; ++r)
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cluster.map_shared_rank(x_m, r)[w]);
    for (int c = tid; c < d; c += kThreads) {
      float num = 0.f, den = 0.f;
      for (int r = 0; r < ranks; ++r) {
        const float* rm = cluster.map_shared_rank(x_m, r);
        const float* rl = cluster.map_shared_rank(x_l, r);
        const float* rd = cluster.map_shared_rank(reinterpret_cast<float*>(dyn), r);
        for (int w = 0; w < kWarps; ++w) {
          const float f = __expf(rm[w] - mx);
          num += f * rd[w * kRing * slot / 4 + c];
          den += f * rl[w];
        }
      }
      store(out + (size_t)bh * d + c, num / den);
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// ranks a (batch, head): at least kSpan positions a rank where the card is
// full, more (up to kMaxRanks, at least a tile a warp each) where B * H
// blocks would leave SMs idle
inline int attn_ranks(int pairs, int t_cap) {
  int r = max((t_cap + kSpan - 1) / kSpan, (kFill + pairs - 1) / pairs);
  r = min(r, (t_cap + kWarps * kTile - 1) / (kWarps * kTile));
  return max(1, min(r, kMaxRanks));
}

template <typename ScaleT, typename OutT, int kD>
cudaError_t launch_kernel(const void* q, const void* k_stack, const void* v_stack,
                          const void* ks_stack, const void* vs_stack, const void* kv_mask,
                          void* out, int layer, int batch, int heads, int t_cap,
                          float sm_scale, cudaStream_t s) {
  const int ranks = attn_ranks(batch * heads, t_cap);
  constexpr int kStep = kWarps * kTile;  // a span is whole tiles of every warp
  const int span = ((t_cap + ranks - 1) / ranks + kStep - 1) / kStep * kStep;
  const size_t smem = (size_t)kWarps * kRing * 2 * kTile * kD + (size_t)span * 12;
  static size_t smem_set = 0;  // the largest set so far, per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(decode_kernel<ScaleT, OutT, kD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * heads * ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, decode_kernel<ScaleT, OutT, kD>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k_stack), static_cast<const int8_t*>(v_stack),
      static_cast<const ScaleT*>(ks_stack), static_cast<const ScaleT*>(vs_stack),
      static_cast<const int*>(kv_mask), static_cast<OutT*>(out), layer, batch, heads, t_cap,
      span, sm_scale);
}

template <typename ScaleT, typename OutT>
cudaError_t launch_decode(const void* q, const void* k_stack, const void* v_stack,
                          const void* ks_stack, const void* vs_stack,
                          const void* kv_mask, void* out, int layer, int batch,
                          int heads, int t_cap, int head_dim, float sm_scale,
                          cudaStream_t s) {
  if (t_cap < 1) return cudaErrorInvalidValue;
  const auto run = [&](auto kernel_launch) {
    return kernel_launch(q, k_stack, v_stack, ks_stack, vs_stack, kv_mask, out, layer, batch,
                         heads, t_cap, sm_scale, s);
  };
  switch (head_dim) {
    case 16: return run(launch_kernel<ScaleT, OutT, 16>);
    case 32: return run(launch_kernel<ScaleT, OutT, 32>);
    case 64: return run(launch_kernel<ScaleT, OutT, 64>);
    case 128: return run(launch_kernel<ScaleT, OutT, 128>);
    case 256: return run(launch_kernel<ScaleT, OutT, 256>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4. q/out: (B*H, D) bf16; k/v stacks: (L, B, H, T, D) int8; scale stacks:
// (L, B, H, T) bf16; kv_mask: (B, T) int32; D a power of two in [16, 256].
// Returns the launch's cudaError_t.
extern "C" int mmor_decode_attention(const void* q, const void* k_stack,
                                     const void* v_stack, const void* ks_stack,
                                     const void* vs_stack, const void* kv_mask,
                                     void* out, int layer, int batch, int heads,
                                     int t_cap, int head_dim, float sm_scale,
                                     void* stream) {
  return (int)launch_decode<__nv_bfloat16, __nv_bfloat16>(
      q, k_stack, v_stack, ks_stack, vs_stack, kv_mask, out, layer, batch, heads,
      t_cap, head_dim, sm_scale, static_cast<cudaStream_t>(stream));
}

// K7. q: (B*H, D) bf16; k/v: (B, H, T, D) int8; scales: (B, H, T) f32
// (scale_f32 = 1) or bf16; kv_mask: (B, T) int32; out: (B*H, D) f32
// (out_f32 = 1) or bf16.
extern "C" int mmor_decode_attention_layer(const void* q, const void* k, const void* v,
                                           const void* k_scale, const void* v_scale,
                                           const void* kv_mask, void* out, int batch,
                                           int heads, int t_cap, int head_dim,
                                           float sm_scale, int scale_f32, int out_f32,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const auto args = [&](auto launch) {
    return (int)launch(q, k, v, k_scale, v_scale, kv_mask, out, 0, batch, heads, t_cap,
                       head_dim, sm_scale, s);
  };
  if (scale_f32)
    return out_f32 ? args(launch_decode<float, float>) : args(launch_decode<float, bf16>);
  return out_f32 ? args(launch_decode<bf16, float>) : args(launch_decode<bf16, bf16>);
}
