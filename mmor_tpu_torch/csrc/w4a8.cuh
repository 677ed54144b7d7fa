// W4A8 skinny product of K3 (int4_matmul.cu, decode rows of the per-op
// int4 path); its mma_s8 also serves K10e (megakernel_probe.cu) and K5's
// weight core (mega_core.cuh).
//
// Weights are pack_int4_rows words: within each K-group of `group` rows,
// byte b of word r holds row 4r+b in its low nibble and row group/2+4r+b in
// its high nibble, both biased by +8. `w & 0x0F0F0F0F` and
// `(w >> 4) & 0x0F0F0F0F` are therefore two pack_int8_rows words, exactly
// the B operand of mma.sync.m16n8k32.s8 for the group's first and second
// half; __vsub4(., 0x08080808) removes the bias byte by byte (no borrow
// between bytes), so the tensor cores give the exact signed int32 dot.
//
// A block of eight warps owns 32 output columns and one 16-row tile; its
// warps split K in units of 32 words (256 rows: 128 of each half of a
// group), load all of a unit's operands before its products, and add each
// unit's int32 partials into a per-(activation chunk, row, column) table in
// shared memory with integer atomics, which are exact in any order. The
// epilogue then folds the chunks in order:
//   acc += float(dot_c) * w_scale[group of c, col] (* act_scale[row, c])
// with __fmul_rn/__fadd_rn, so the result does not depend on how K was
// split and matches the plain PyTorch versions' order of operations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w4a8 {

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// biased nibbles of a group's first / second half -> signed int8 bytes
__device__ __forceinline__ uint32_t low_s8(uint32_t w) {
  return __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
}
__device__ __forceinline__ uint32_t high_s8(uint32_t w) {
  return __vsub4((w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
}

constexpr int kWarps = 8;
constexpr int kCols = 32;     // output columns a block owns
constexpr int kUnitWords = 32;  // weight word rows of one warp unit (256 K rows)

enum Epilogue {
  kStoreF32 = 0,  // out f32 (M, N) = acc
  kResidF32 = 1,  // out f32 (M, N) = resid + acc
  kSwiGLU = 2,    // N = 2F columns [gate | up]: out f32 (M, F) = silu(g) * u
  kRowScale = 3,  // out OutT (M, N) = acc * act_scale[row] (K3's per-row scale)
};

struct SkinnyArgs {
  const uint32_t* xq;  // (M, K/4) int8 activations, 4 to a word
  const float* rs;     // kRowScale: (M,); else (M, K/chunk) chunk scales
  const uint32_t* w;   // (K/8, N) pack_int4_rows(block=group)
  const float* sc;     // (K/group, N) weight scales
  const float* resid;  // kResidF32: (M, N)
  void* out;
  int m, k, n, group, chunk;
};

template <typename T> __device__ __forceinline__ T store_as(float x);
template <> __device__ __forceinline__ float store_as<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// column of n-tile `nt`, lane column `j` (0..7): plain blocks own 32
// consecutive columns; SwiGLU blocks own 16 gate columns and the 16 up
// columns that pair with them
template <int EPI>
__device__ __forceinline__ int column(int nt, int j, int n) {
  if (EPI == kSwiGLU) {
    const int j0 = blockIdx.x * (kCols / 2) + (nt & 1) * 8 + j;
    return nt < 2 ? j0 : n / 2 + j0;
  }
  return blockIdx.x * kCols + nt * 8 + j;
}

// the folded f32 sum of one (row, col) over all activation chunks
template <int EPI>
__device__ __forceinline__ float fold(const int* red, const SkinnyArgs& p,
                                      int nch, int r, int cl, int row, int col) {
  float acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int dot = red[(c * 16 + r) * kCols + cl];
    float t = __fmul_rn((float)dot, p.sc[(size_t)(c * p.chunk / p.group) * p.n + col]);
    if (EPI != kRowScale) t = __fmul_rn(t, p.rs[(size_t)row * nch + c]);
    acc = __fadd_rn(acc, t);
  }
  return acc;
}

// grid: (ceil(N / 32) or ceil(F / 16) for kSwiGLU, ceil(M / 16)); block 256;
// dynamic shared memory (K / chunk) * 16 * 32 ints. Requires K % 256 == 0,
// group % 256 == 0, chunk % 128 == 0, and chunk equal to group or dividing
// group/2 (an activation chunk never straddles a weight group).
template <int EPI, typename OutT>
__global__ void __launch_bounds__(kWarps * 32) skinny_kernel(SkinnyArgs p) {
  extern __shared__ int red[];  // [K / chunk][16][kCols]
  const int nch = p.k / p.chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * 16;
  const int kw = p.k / 4;          // activation words a row
  const int gw = p.group / 8;      // weight word rows a group
  for (int i = threadIdx.x; i < nch * 16 * kCols; i += blockDim.x) red[i] = 0;
  __syncthreads();

  int cols[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) cols[nt] = column<EPI>(nt, g, p.n);
  const bool row_a = m0 + g < p.m, row_b = m0 + g + 8 < p.m;
  const uint32_t* xa = p.xq + (size_t)(m0 + g) * kw;
  const uint32_t* xb = p.xq + (size_t)(m0 + g + 8) * kw;
  const int units = p.k / 256;
  for (int unit = warp; unit < units; unit += kWarps) {
    const int w0 = unit * kUnitWords;            // first weight word row
    const int grp = w0 / gw, pos = w0 % gw;      // its group, word in group
    const int lo0 = grp * (p.group / 4) + pos;   // activation word, low half
    const int hi0 = lo0 + p.group / 8;           // activation word, high half
    uint32_t b[4][4][2], al[4][4], ah[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kl = lo0 + u * 8 + t4, kh = hi0 + u * 8 + t4;
      al[u][0] = row_a ? xa[kl] : 0u;
      al[u][1] = row_b ? xb[kl] : 0u;
      al[u][2] = row_a ? xa[kl + 4] : 0u;
      al[u][3] = row_b ? xb[kl + 4] : 0u;
      ah[u][0] = row_a ? xa[kh] : 0u;
      ah[u][1] = row_b ? xb[kh] : 0u;
      ah[u][2] = row_a ? xa[kh + 4] : 0u;
      ah[u][3] = row_b ? xb[kh + 4] : 0u;
      const size_t wr = (size_t)(w0 + u * 8 + t4);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bool live = cols[nt] < p.n;
        b[u][nt][0] = live ? p.w[wr * p.n + cols[nt]] : 0u;
        b[u][nt][1] = live ? p.w[(wr + 4) * p.n + cols[nt]] : 0u;
      }
    }
    int cl_[4][4] = {}, ch_[4][4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t bl[2] = {low_s8(b[u][nt][0]), low_s8(b[u][nt][1])};
        const uint32_t bh[2] = {high_s8(b[u][nt][0]), high_s8(b[u][nt][1])};
        mma_s8(cl_[nt], al[u], bl);
        mma_s8(ch_[nt], ah[u], bh);
      }
    }
    const int krow = grp * p.group + 4 * pos;  // first K row of the low half
    const int c_lo = krow / p.chunk, c_hi = (krow + p.group / 2) / p.chunk;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8, cl = nt * 8 + t4 * 2 + (e & 1);
        atomicAdd(&red[(c_lo * 16 + r) * kCols + cl], cl_[nt][e]);
        atomicAdd(&red[(c_hi * 16 + r) * kCols + cl], ch_[nt][e]);
      }
    }
  }
  __syncthreads();

  if (EPI == kSwiGLU) {
    const int f = p.n / 2;
    float* out = static_cast<float*>(p.out);
    for (int i = threadIdx.x; i < 16 * (kCols / 2); i += blockDim.x) {
      const int r = i / (kCols / 2), jj = i % (kCols / 2);
      const int row = m0 + r, j = blockIdx.x * (kCols / 2) + jj;
      if (row >= p.m || j >= f) continue;
      const float gate = fold<EPI>(red, p, nch, r, jj, row, j);
      const float up = fold<EPI>(red, p, nch, r, kCols / 2 + jj, row, f + j);
      out[(size_t)row * f + j] = gate * (1.f / (1.f + expf(-gate))) * up;
    }
    return;
  }
  for (int i = threadIdx.x; i < 16 * kCols; i += blockDim.x) {
    const int r = i / kCols, cl = i % kCols;
    const int row = m0 + r, col = column<EPI>(cl / 8, cl % 8, p.n);
    if (row >= p.m || col >= p.n) continue;
    const float acc = fold<EPI>(red, p, nch, r, cl, row, col);
    const size_t o = (size_t)row * p.n + col;
    if (EPI == kStoreF32) {
      static_cast<float*>(p.out)[o] = acc;
    } else if (EPI == kResidF32) {
      static_cast<float*>(p.out)[o] = __fadd_rn(p.resid[o], acc);
    } else {
      static_cast<OutT*>(p.out)[o] = store_as<OutT>(__fmul_rn(acc, p.rs[row]));
    }
  }
}

// Launches skinny_kernel<EPI, OutT> on `s`; returns the launch's error.
template <int EPI, typename OutT>
cudaError_t launch_skinny(const SkinnyArgs& p, cudaStream_t s) {
  if (p.k % 256 || p.group % 256 || p.chunk % 128 || p.k % p.group)
    return cudaErrorInvalidValue;
  if (!(p.chunk == p.group || (p.group / 2) % p.chunk == 0))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(p.k / p.chunk) * 16 * kCols * sizeof(int);
  static size_t smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        skinny_kernel<EPI, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int nx = EPI == kSwiGLU ? (p.n / 2 + kCols / 2 - 1) / (kCols / 2)
                                : (p.n + kCols - 1) / kCols;
  dim3 grid(nx, (p.m + 15) / 16);
  skinny_kernel<EPI, OutT><<<grid, kWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace w4a8
