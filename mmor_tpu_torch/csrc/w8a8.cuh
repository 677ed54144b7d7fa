// W8A8 skinny product of K5's int8-weight instantiations (mega_decode.cu,
// every matmul phase at wbits = 8): the weight phases of
// mmor_tpu/ops/mega_decode.py::mega_decode_layers with int8 weights
// (:663-760, :941-978), whose arithmetic is mega_decode_layers_reference's
// mm_quant (:1477-1485).
//
// Weights are pack_int8_rows words (K/4, N): byte b of word r holds K row
// 4r+b of its column, so words r and r+4 of a column are exactly the B
// operand of mma.sync.m16n8k32.s8 for K rows [4r, 4r+32); the activations
// are int8 per (row, K-chunk), four to a word, as for w4a8.cuh. The numerics
// are the TPU kernel's W8A8 fold: each chunk's exact int32 dot times its
// row-chunk scale, summed in f32 in chunk order, and only then the f32
// per-channel weight scale:
//   acc += float(dot_c) * act_scale[row, c];  out = acc * w_scale[col]
// with __fmul_rn/__fadd_rn, the plain version's order (_w8a8_chunks). K2
// (int8_matmul.cu) quantizes each whole row once, the per-op numerics, so it
// is not this fold.
//
// The block structure is w4a8.cuh's (its Epilogue, SkinnyArgs and column
// map are reused, so the SwiGLU blocks pair gate column j with up column j):
// eight warps own 32 output columns and one 16-row tile and split K in
// units of 32 word rows (128 K rows, one activation chunk each, since
// chunks are multiples of 128); each unit's int32 partials go into a
// per-(chunk, row, column) table in shared memory with integer atomics,
// exact in any order; the epilogue folds the chunks in order. What bounds
// it: the weight bytes, twice int4's; sharing one weight read among row
// tiles is later work, as for w4a8.cuh.
#pragma once

#include "w4a8.cuh"

namespace w8a8 {

using w4a8::kCols;
using w4a8::kWarps;
using w4a8::SkinnyArgs;

constexpr int kUnitWords = 32;  // weight word rows of one warp unit (128 K rows)

// the folded f32 sum of one (row, col) over all activation chunks, times
// the column's weight scale
__device__ __forceinline__ float fold(const int* red, const SkinnyArgs& p, int nch, int r,
                                      int cl, int row, int col) {
  float acc = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int dot = red[(c * 16 + r) * kCols + cl];
    acc = __fadd_rn(acc, __fmul_rn((float)dot, p.rs[(size_t)row * nch + c]));
  }
  return __fmul_rn(acc, p.sc[col]);
}

// grid: (ceil(N / 32) or ceil(F / 16) for kSwiGLU, ceil(M / 16)); block 256;
// dynamic shared memory (K / chunk) * 16 * 32 ints. Requires K % 128 == 0,
// chunk % 128 == 0 and K % chunk == 0. `sc` is (N,) per-channel; `group`
// is not read.
template <int EPI>
__global__ void __launch_bounds__(kWarps * 32) skinny_kernel(SkinnyArgs p) {
  extern __shared__ int red[];  // [K / chunk][16][kCols]
  const int nch = p.k / p.chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * 16;
  const int kw = p.k / 4;  // activation words a row, and weight word rows
  for (int i = threadIdx.x; i < nch * 16 * kCols; i += blockDim.x) red[i] = 0;
  __syncthreads();

  int cols[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) cols[nt] = w4a8::column<EPI>(nt, g, p.n);
  const bool row_a = m0 + g < p.m, row_b = m0 + g + 8 < p.m;
  const uint32_t* xa = p.xq + (size_t)(m0 + g) * kw;
  const uint32_t* xb = p.xq + (size_t)(m0 + g + 8) * kw;
  const int units = p.k / 128;
  for (int unit = warp; unit < units; unit += kWarps) {
    const int w0 = unit * kUnitWords;  // first word row, and first activation word
    uint32_t b[4][4][2], a[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kr = w0 + u * 8 + t4;
      a[u][0] = row_a ? xa[kr] : 0u;
      a[u][1] = row_b ? xb[kr] : 0u;
      a[u][2] = row_a ? xa[kr + 4] : 0u;
      a[u][3] = row_b ? xb[kr + 4] : 0u;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bool live = cols[nt] < p.n;
        b[u][nt][0] = live ? p.w[(size_t)kr * p.n + cols[nt]] : 0u;
        b[u][nt][1] = live ? p.w[(size_t)(kr + 4) * p.n + cols[nt]] : 0u;
      }
    }
    int acc[4][4] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) w4a8::mma_s8(acc[nt], a[u], b[u][nt]);
    const int c = 4 * w0 / p.chunk;  // the unit's activation chunk
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8, cl = nt * 8 + t4 * 2 + (e & 1);
        atomicAdd(&red[(c * 16 + r) * kCols + cl], acc[nt][e]);
      }
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
  if (EPI == w4a8::kSwiGLU) {
    const int f = p.n / 2;
    for (int i = threadIdx.x; i < 16 * (kCols / 2); i += blockDim.x) {
      const int r = i / (kCols / 2), jj = i % (kCols / 2);
      const int row = m0 + r, j = blockIdx.x * (kCols / 2) + jj;
      if (row >= p.m || j >= f) continue;
      const float gate = fold(red, p, nch, r, jj, row, j);
      const float up = fold(red, p, nch, r, kCols / 2 + jj, row, f + j);
      out[(size_t)row * f + j] = gate * (1.f / (1.f + expf(-gate))) * up;
    }
    return;
  }
  for (int i = threadIdx.x; i < 16 * kCols; i += blockDim.x) {
    const int r = i / kCols, cl = i % kCols;
    const int row = m0 + r, col = w4a8::column<EPI>(cl / 8, cl % 8, p.n);
    if (row >= p.m || col >= p.n) continue;
    const float acc = fold(red, p, nch, r, cl, row, col);
    const size_t o = (size_t)row * p.n + col;
    out[o] = EPI == w4a8::kResidF32 ? __fadd_rn(p.resid[o], acc) : acc;
  }
}

// Launches skinny_kernel<EPI> (kStoreF32, kResidF32 or kSwiGLU, f32 out) on
// `s`; returns the launch's error.
template <int EPI>
cudaError_t launch_skinny(const SkinnyArgs& p, cudaStream_t s) {
  static_assert(EPI == w4a8::kStoreF32 || EPI == w4a8::kResidF32 || EPI == w4a8::kSwiGLU,
                "W8A8 epilogues: f32 store, f32 residual, SwiGLU");
  if (p.k % 128 || p.chunk % 128 || p.k % p.chunk) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(p.k / p.chunk) * 16 * kCols * sizeof(int);
  static size_t smem_set = 48 * 1024;  // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        skinny_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int nx = EPI == w4a8::kSwiGLU ? (p.n / 2 + kCols / 2 - 1) / (kCols / 2)
                                      : (p.n + kCols - 1) / kCols;
  dim3 grid(nx, (p.m + 15) / 16);
  skinny_kernel<EPI><<<grid, kWarps * 32, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace w8a8
