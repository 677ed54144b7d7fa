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
// Design: the TPU kernel exists to run the tail as one launch; its H100 form
// is one cooperative launch (cudaLaunchCooperativeKernel) of as many blocks
// as fit on the card at once, which walk three phases of work units and meet
// at grid-wide barriers (cooperative_groups' grid.sync(), which also orders
// their memory):
//   phase 1: x2 by 32-column units (and each unit's sums of x2^2 by row);
//   barrier;
//   norm:    the grid writes h = bf16(x2 * factor * norm_scale), each block
//            summing the units' partial sums of the rows it writes, in one
//            fixed order, into their RMS factors;
//   barrier;
//   phase 2: units of 16 gate columns with their 16 up columns, so a unit
//            ends with m = bf16(silu(gate) * up) and gu is never stored;
//   barrier;
//   phase 3: out by 32-column units.
// x2 (f32), h and m (bf16) and the partial sums live in a global scratch the
// wrapper allocates; reads of them bypass L1 (__ldcg), since another SM wrote
// them during the launch. A unit is a 16-row m-tile of the batch times its
// columns; the block's eight warps split K, loads for several k-steps in
// flight before their products (as in stream_matmul.cu), and meet in shared
// memory. Products are bf16 mma.sync.m16n8k16 with f32 accumulation: a
// thread's B registers are the four int8 values of one weight word (rows
// 4r..4r+3 of one column, converted exactly to bf16) and its A registers the
// activations of the same four k, one 8-byte load a row. Lane group g owns
// columns c + 2g and c + 2g + 1 of each 16-column group of its unit (one
// 8-byte load of a word row a group; a phase-1 or phase-3 unit is two
// adjacent groups, so a warp's loads of a word row cover 128 contiguous
// bytes, and a unit reads the activations once for 32 columns). Every sum is
// taken in a fixed order, so the output does not depend on the grid size. A
// grid too large to be co-resident makes the launch fail (it never hangs);
// the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"  // to_float / from_float
#include "bf16_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;     // columns of a column group: two 8-column mma tiles
constexpr int kNG13 = 2;       // column groups of a phase-1 or phase-3 unit (adjacent)
constexpr int kCols13 = kGroup * kNG13;

struct Args {
  const uint16_t* attn;    // (B, Dq) bf16
  const void* res;         // (B, D) bf16 or f32: x_res
  const float* ns;         // (D,) norm scale
  const uint32_t* wo;      // (Dq/4, D) packed words
  const float* wos;        // (D,)
  const uint32_t* wgu;     // (D/4, 2F)
  const float* wgus;       // (2F,)
  const uint32_t* wd;      // (F/4, D)
  const float* wds;        // (D,)
  void* out;               // (B, D) in x_res's dtype
  float* x2;               // scratch (B, D) f32
  uint16_t* h;             // scratch (B, D) bf16
  uint16_t* m;             // scratch (B, F) bf16
  float* ssq;              // scratch (D/32, B) f32: each column unit's sums of x2^2
  unsigned long long* ns_stamps;  // null, or 5 %globaltimer stamps (see mmor_fused_o_mlp)
  int b, dq, d, f;
  float eps;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// block 0's stamp i of the launch's phases, when the caller asked for them
__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.ns_stamps && blockIdx.x == 0 && threadIdx.x == 0) a.ns_stamps[i] = globaltimer();
}

// Warp w's partial products of one unit into red[w][row][col]: rows m0..m0+15
// of the bf16 activations a (rows x k) against NG column groups of the word
// weight w (k/4, n), group i starting at column c[i]; group i's columns are
// local columns 16i..16i+15 of red.
template <int NG>
__device__ __forceinline__ void unit_product(const uint16_t* a, int rows, int m0, int k,
                                             const uint32_t* __restrict__ w, int n,
                                             const int (&c)[NG], float (*red)[16][2 * kGroup]) {
  constexpr int kUnroll = 8 / NG;  // k-steps a warp loads before its products
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int steps = k / 16;  // four word rows (16 k) a step, one per t4
  const bool lo = m0 + g < rows, hi = m0 + g + 8 < rows;
  const uint16_t* a_lo = a + (size_t)(m0 + g) * k;
  const uint16_t* a_hi = a + (size_t)(m0 + g + 8) * k;
  const uint2 z = make_uint2(0u, 0u);

  float acc[2 * NG][4] = {};
  for (int s0 = warp * kUnroll; s0 < steps; s0 += kWarps * kUnroll) {
    uint2 wv[kUnroll][NG];
    uint32_t av[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = s0 + u < steps;
      const int r = (s0 + u) * 4 + t4;  // the word row; its k are 4r..4r+3
#pragma unroll
      for (int i = 0; i < NG; ++i)
        wv[u][i] = live ? *reinterpret_cast<const uint2*>(w + (size_t)r * n + c[i] + 2 * g) : z;
      const uint2 l = live && lo ? __ldcg(reinterpret_cast<const uint2*>(a_lo + 4 * r)) : z;
      const uint2 hv = live && hi ? __ldcg(reinterpret_cast<const uint2*>(a_hi + 4 * r)) : z;
      av[u][0] = l.x, av[u][1] = hv.x, av[u][2] = l.y, av[u][3] = hv.y;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t word = j ? wv[u][i].y : wv[u][i].x;
          const uint32_t b[2] = {
              pair(bf16_bits((int8_t)(word & 0xffu)), bf16_bits((int8_t)((word >> 8) & 0xffu))),
              pair(bf16_bits((int8_t)((word >> 16) & 0xffu)), bf16_bits((int8_t)(word >> 24)))};
          mma_bf16(acc[2 * i + j], av[u], b);
        }
      }
    }
  }
  // element e of tile 2i + j: row g + 8(e >> 1), mma column cm = 2 t4 + (e & 1),
  // which is lane group cm's column j of group i
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][g + (e >> 1) * 8][kGroup * i + 2 * (2 * t4 + (e & 1)) + j] = acc[2 * i + j][e];
}

// the block's sum over its warps of red's (row, col), in warp order
__device__ __forceinline__ float warp_sum(float (*red)[16][2 * kGroup], int row, int col) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w][row][col];
  return s;
}

template <typename ResT>
__global__ void __launch_bounds__(kThreads) fused_o_mlp_kernel(Args a) {
  __shared__ float red[kWarps][16][2 * kGroup];
  __shared__ float sq[16][kCols13];
  __shared__ float inv[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stamp(a, 0);
  const int mtiles = (a.b + 15) / 16;
  const ResT* res = static_cast<const ResT*>(a.res);
  ResT* out = static_cast<ResT*>(a.out);
  const int dunits = a.d / kCols13;  // phase-1 and phase-3 units of D
  int c13[kNG13];

  // phase 1: x2 = x_res + (attn @ Wo) * wos, and each unit's row sums of x2^2
  for (int u = blockIdx.x; u < dunits * mtiles; u += gridDim.x) {
    const int cu = u % dunits, m0 = (u / dunits) * 16, c0 = cu * kCols13;
#pragma unroll
    for (int i = 0; i < kNG13; ++i) c13[i] = c0 + kGroup * i;
    unit_product<kNG13>(a.attn, a.b, m0, a.dq, a.wo, a.d, c13, red);
    __syncthreads();
    for (int i = tid; i < 16 * kCols13; i += kThreads) {
      const int row = i / kCols13, col = i % kCols13, gr = m0 + row, gc = c0 + col;
      float v = 0.f;
      if (gr < a.b) {
        v = to_float(res[(size_t)gr * a.d + gc]) + warp_sum(red, row, col) * a.wos[gc];
        a.x2[(size_t)gr * a.d + gc] = v;
      }
      sq[row][col] = v * v;
    }
    __syncthreads();
    if (tid < 16 && m0 + tid < a.b) {
      float s = 0.f;
#pragma unroll
      for (int col = 0; col < kCols13; ++col) s += sq[tid][col];
      a.ssq[(size_t)cu * a.b + m0 + tid] = s;
    }
    __syncthreads();
  }
  grid.sync();
  stamp(a, 1);

  // norm: h = bf16(x2 * rsqrt(mean(x2^2) + eps) * norm_scale), a block a
  // chunk of kThreads entries of h at a time. A chunk spans at most 8 rows
  // (D % 32 == 0), and warp w sums the units' partial sums of the chunk's
  // row w, lane l taking units l, l + 32, ..., then a butterfly, which leaves
  // the same sum, in the same order, in every lane and block; only the
  // blocks that write a row read its partial sums.
  const size_t hn = (size_t)a.b * a.d;
  for (size_t c0 = (size_t)blockIdx.x * kThreads; c0 < hn; c0 += (size_t)gridDim.x * kThreads) {
    const int first = (int)(c0 / a.d);
    const int last = (int)min((size_t)a.b - 1, (c0 + kThreads - 1) / a.d);
    if (first + warp <= last) {
      float s = 0.f;
      for (int cu = lane; cu < dunits; cu += 32)
        s += __ldcg(a.ssq + (size_t)cu * a.b + first + warp);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) inv[warp] = rsqrtf(s / (float)a.d + a.eps);
    }
    __syncthreads();
    const size_t i = c0 + tid;
    if (i < hn) {
      const float v = __ldcg(a.x2 + i) * inv[i / a.d - first] * a.ns[i % a.d];
      const __nv_bfloat16 hb = __float2bfloat16_rn(v);
      a.h[i] = *reinterpret_cast<const uint16_t*>(&hb);
    }
    __syncthreads();
  }
  grid.sync();
  stamp(a, 2);

  // phase 2: gate and up columns j0..j0+15, m = bf16(silu(gate) * up)
  const int funits = a.f / kGroup;
  for (int u = blockIdx.x; u < funits * mtiles; u += gridDim.x) {
    const int m0 = (u / funits) * 16, j0 = (u % funits) * kGroup;
    const int c[2] = {j0, a.f + j0};
    unit_product<2>(a.h, a.b, m0, a.d, a.wgu, 2 * a.f, c, red);
    __syncthreads();
    const int row = tid / kGroup, j = tid % kGroup, gr = m0 + row;
    if (gr < a.b) {
      const float gate = warp_sum(red, row, j) * a.wgus[j0 + j];
      const float up = warp_sum(red, row, kGroup + j) * a.wgus[a.f + j0 + j];
      const float sig = 1.f / (1.f + expf(-gate));
      const __nv_bfloat16 mb = __float2bfloat16_rn(gate * sig * up);
      a.m[(size_t)gr * a.f + j0 + j] = *reinterpret_cast<const uint16_t*>(&mb);
    }
    __syncthreads();
  }
  grid.sync();
  stamp(a, 3);

  // phase 3: out = x2 + (m @ Wd) * wds
  for (int u = blockIdx.x; u < dunits * mtiles; u += gridDim.x) {
    const int m0 = (u / dunits) * 16, c0 = (u % dunits) * kCols13;
#pragma unroll
    for (int i = 0; i < kNG13; ++i) c13[i] = c0 + kGroup * i;
    unit_product<kNG13>(a.m, a.b, m0, a.f, a.wd, a.d, c13, red);
    __syncthreads();
    for (int i = tid; i < 16 * kCols13; i += kThreads) {
      const int row = i / kCols13, col = i % kCols13, gr = m0 + row, gc = c0 + col;
      if (gr < a.b) {
        const size_t o = (size_t)gr * a.d + gc;
        out[o] = from_float<ResT>(__ldcg(a.x2 + o) + warp_sum(red, row, col) * a.wds[gc]);
      }
    }
    __syncthreads();
  }
  if (a.ns_stamps && tid == 0) atomicMax(a.ns_stamps + 4, globaltimer());
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
// cooperative launches).
extern "C" int mmor_fused_o_mlp(const void* attn, const void* res, const void* ns, const void* wo,
                                const void* wos, const void* wgu, const void* wgus, const void* wd,
                                const void* wds, void* out, void* x2, void* h, void* m, void* ssq,
                                void* stamps, int b, int dq, int d, int f, int res_bf16,
                                float eps, void* stream) {
  if (b < 1 || dq % kGroup || d % kCols13 || f % kGroup) return (int)cudaErrorInvalidValue;
  Args args{static_cast<const uint16_t*>(attn), res, static_cast<const float*>(ns),
            static_cast<const uint32_t*>(wo), static_cast<const float*>(wos),
            static_cast<const uint32_t*>(wgu), static_cast<const float*>(wgus),
            static_cast<const uint32_t*>(wd), static_cast<const float*>(wds), out,
            static_cast<float*>(x2), static_cast<uint16_t*>(h), static_cast<uint16_t*>(m),
            static_cast<float*>(ssq), static_cast<unsigned long long*>(stamps), b, dq, d, f,
            eps};
  const void* kernel = res_bf16
                           ? reinterpret_cast<const void*>(fused_o_mlp_kernel<__nv_bfloat16>)
                           : reinterpret_cast<const void*>(fused_o_mlp_kernel<float>);
  // the grid: as many blocks a multiprocessor as fit, on every one
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(kernel, dim3(per_sm * sms), dim3(kThreads), params, 0,
                                  static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
