// K10f: the kernels of the layout probe (tools/perf/probe_mosaic_reshape.py):
// a copy (probes a and b, a reshape written into a new buffer) and the
// (TQ, D) = S^T-contracted f32 product of probes c, d and e.
//
// Replaces tools/perf/probe_mosaic_reshape.py::probe (the pl.pallas_call at
// :32), which compiled each of five kernels alone to find which Mosaic
// reshape or contraction the TPU's deformable sampler could use. On the
// H100 each is a plain function: a reshape of a contiguous array is a copy
// of its bytes, and the three contractions are one product whose A operand
// comes from memory transposed (c: S^T (K, TQ)), in its natural order (d:
// (TQ, WH, WW) read as (TQ, K)), or from the one-hot factors of e, built in
// the kernel from iotas: S^T[k, q] = (k / WW == iy) * ((k % WW == ix) ? wx
// : 0), as probe e's (WH, 1, TQ) and (1, WW, TQ) factors give it.
//
// What bounds them on the H100: at the probes' shapes (TQ 256, K 1280, D 32)
// a copy moves 2.6 MB and a product reads 1.5 MB for 21 MFLOP, a few
// microseconds at most: a launch's fixed cost.
//
// Design: the copy moves 16-byte chunks, grid-stride. The product is f32
// FFMA (not TF32): a block of 256 threads owns a 16 x 16 output tile, one
// output a thread, and walks K in steps of 256 staged through shared memory
// (each thread's 32 loads of a step issued together, coalesced along the
// operand's contiguous axis: the steps' load latencies, not the FMAs, set
// the time); each output's sum runs over k in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum ASrc { kTransposed = 0, kNatural = 1, kOneHot = 2 };

constexpr int kTile = 16;
constexpr int kStepK = 256;
constexpr int kThreads = kTile * kTile;

__global__ void copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n16;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

struct ProductArgs {
  const float* a;  // kTransposed: (K, TQ); kNatural: (TQ, K); kOneHot: unused
  const float* b;  // (K, D)
  float* out;      // (TQ, D)
  int tq, k, d;
  int ww, iy, ix;  // kOneHot: S^T's factors
  float wx;
};

template <int A>
__device__ __forceinline__ float a_at(const ProductArgs& p, int q, int kk) {
  if (q >= p.tq || kk >= p.k) return 0.f;
  if constexpr (A == kTransposed) return p.a[(size_t)kk * p.tq + q];
  if constexpr (A == kNatural) return p.a[(size_t)q * p.k + kk];
  const float wy = kk / p.ww == p.iy ? 1.f : 0.f;
  const float wx = kk % p.ww == p.ix ? p.wx : 0.f;
  return wy * wx;
}

template <int A>
__global__ void __launch_bounds__(kThreads) product_kernel(ProductArgs p) {
  __shared__ float as[kTile][kStepK + 1];
  __shared__ float bs[kStepK][kTile + 1];
  const int q0 = blockIdx.x * kTile, d0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  float acc = 0.f;
  for (int k0 = 0; k0 < p.k; k0 += kStepK) {
#pragma unroll
    for (int j = 0; j < kTile * kStepK / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      // along q for the transposed operand, along k otherwise
      const int qq = A == kTransposed ? i % kTile : i / kStepK;
      const int kk = A == kTransposed ? i / kTile : i % kStepK;
      as[qq][kk] = a_at<A>(p, q0 + qq, k0 + kk);
      const int dd = i % kTile, kb = i / kTile;
      bs[kb][dd] = k0 + kb < p.k && d0 + dd < p.d ? p.b[(size_t)(k0 + kb) * p.d + d0 + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < kStepK; ++kk) acc = fmaf(as[ty][kk], bs[kk][tx], acc);
    __syncthreads();
  }
  if (q0 + ty < p.tq && d0 + tx < p.d) p.out[(size_t)(q0 + ty) * p.d + d0 + tx] = acc;
}

}  // namespace

// probes a and b: copy n_bytes (a multiple of 16) from src to dst.
extern "C" int mmor_probe_copy(const void* src, void* dst, long long n_bytes, void* stream) {
  if (n_bytes < 0 || n_bytes % 16) return (int)cudaErrorInvalidValue;
  const long long n16 = n_bytes / 16;
  if (n16 == 0) return 0;
  const long long want = (n16 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16);
  return (int)cudaGetLastError();
}

// probes c, d, e: out (TQ, D) f32 = sum over k of A(q, k) * b (K, D) f32,
// A by a_src (0: a is S^T (K, TQ); 1: a is (TQ, K); 2: the one-hot S^T of
// (ww, iy, ix, wx), a unused).
extern "C" int mmor_probe_product(const void* a, const void* b, void* out, int tq, int k, int d,
                                  int a_src, int ww, int iy, int ix, float wx, void* stream) {
  if (tq < 1 || k < 1 || d < 1 || (a_src == kOneHot && ww < 1)) return (int)cudaErrorInvalidValue;
  ProductArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
                static_cast<float*>(out), tq, k, d, ww, iy, ix, wx};
  const dim3 grid((tq + kTile - 1) / kTile, (d + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_src) {
    case kTransposed: product_kernel<kTransposed><<<grid, kThreads, 0, s>>>(p); break;
    case kNatural: product_kernel<kNatural><<<grid, kThreads, 0, s>>>(p); break;
    case kOneHot: product_kernel<kOneHot><<<grid, kThreads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
