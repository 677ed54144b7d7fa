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
// a copy moves 2.6 MB and a product reads 1.5 MB for 21 MFLOP, well under a
// microsecond of bytes or of f32 FFMA (67 TFLOP/s): latency sets the time,
// the launch's and that of the first loads.
//
// Design: the copy moves 16-byte chunks, grid-stride. The product is f32
// FFMA (not TF32: rel_l2 1e-6 against the plain version rules it out).
// Its first form gave a 16 x 16 output tile to 256 threads, one output a
// thread: 32 blocks on 132 SMs, each output one chain of 1,280 dependent
// FMAs with two shared loads an FMA, loads never overlapping FMAs (18-27 us,
// about 1 TFLOP/s). Now:
//  - a thread-block cluster of 16 blocks (a non-portable size, which the
//    H100 takes) owns a 16-query x 32-channel output tile and splits K 16
//    ways (80 k each at the probes' shapes), so the probes' 256 x 32 output
//    fills 256 blocks;
//  - each of a block's 128 threads owns one query's four neighbouring
//    channels: per k one broadcast load of A and one 16-byte load of B feed
//    four FMAs;
//  - a rank's k range streams through a ring of 4 stages of 32 k by
//    cp.async commit groups (16-byte copies where the rows allow it, else
//    4-byte ones), three stages in flight while a stage's FMAs run;
//  - case e loads only B: each stage's 32 values of S^T's column are built
//    from the iotas (window row k / WW == iy times column k % WW == ix at
//    wx; one column serves every query, since S^T's rows do not depend on
//    the query);
//  - the ranks' partial tiles meet through distributed shared memory: each
//    thread stores its four sums into the shared memory of the rank that
//    owns those outputs (rank r outputs 32r..32r+31 of the tile), one
//    cluster barrier, and each rank adds its outputs' 16 sums in rank
//    order, so the result is deterministic (each rank's sum runs over its k
//    in order).
// While this form was chosen on the card, the fold was the largest cost (a
// form that read the other ranks' sums after a barrier, and held them with
// a second, was slower than this one), and 16 ranks beat 8, and 8 beat 4.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

enum ASrc { kTransposed = 0, kNatural = 1, kOneHot = 2 };

constexpr int kThreads = 256;  // the copy's blocks

__global__ void copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n16;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

// ------------------------------------------------------------------ product
constexpr int kRanks = 16;                  // a cluster's blocks: K split 16 ways (non-portable)
constexpr int kTQ = 16, kTD = 32;           // a cluster's output tile
constexpr int kPThreads = kTQ * kTD / 4;    // 128: four neighbouring channels a thread
constexpr int kStepK = 32;                  // k a stage
constexpr int kStages = 4;
constexpr int kANat = kStepK + 4;           // natural A's row: 16-byte aligned, a warp's 4 rows in distinct banks
constexpr int kShare = kTQ * kTD / kRanks;  // outputs a rank folds

struct ProductArgs {
  const float* a;  // kTransposed: (K, TQ); kNatural: (TQ, K); kOneHot: unused
  const float* b;  // (K, D)
  float* out;      // (TQ, D)
  int tq, k, d;
  int ww, iy, ix;  // kOneHot: S^T's factors
  float wx;
  int vec;         // every 16-byte chunk of a and b lies wholly in or out of range, aligned
};

template <int A>
__global__ void __launch_bounds__(kPThreads) product_kernel(ProductArgs p) {
  __shared__ __align__(16) float as[kStages][kTQ * kANat];  // A: [k][q], [q][k] or [k]
  __shared__ __align__(16) float bs[kStages][kStepK * kTD];
  __shared__ __align__(16) float part[kRanks][kShare];  // the ranks' sums of this rank's outputs
  const int rank = blockIdx.x;  // the cluster spans x: its rank
  const int q0 = blockIdx.y * kTQ, d0 = blockIdx.z * kTD;
  const int span = ((p.k + kRanks - 1) / kRanks + 3) & ~3;  // 16-byte aligned k ranges
  const int kb = min(p.k, rank * span), ke = min(p.k, kb + span);
  const int steps = (ke - kb + kStepK - 1) / kStepK;
  const int tid = threadIdx.x, qi = tid / (kTD / 4), dg = (tid % (kTD / 4)) * 4;
  // every block of the cluster must have started before another writes to
  // its shared memory: arrive now, wait before the fold
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 4 floats at dst from src[0..3], those of index < `valid` (0-4; the rest zero)
  auto copy4 = [&](float* dst, const float* src, int valid) {
    if (p.vec) {
      cp_async16(dst, valid > 0 ? src : p.b, valid > 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < valid ? src + e : p.b, e < valid ? 4 : 0);
    }
  };
  // stage st of this rank's k range into ring slot st % kStages, as one commit group
  auto load = [&](int st) {
    float* a = as[st % kStages];
    float* b = bs[st % kStages];
    const int k0 = kb + st * kStepK;
    for (int c = tid; c < kStepK * kTD / 4; c += kPThreads) {  // B: 32 k x 32 channels
      const int r = c / (kTD / 4), cc = (c % (kTD / 4)) * 4;
      const int kk = k0 + r, dd = d0 + cc;
      copy4(b + r * kTD + cc, p.b + (size_t)kk * p.d + dd, kk < ke ? min(4, p.d - dd) : 0);
    }
    if constexpr (A == kTransposed) {  // 32 k x 16 queries, a row of S^T a k
      for (int c = tid; c < kStepK * kTQ / 4; c += kPThreads) {
        const int r = c / (kTQ / 4), cq = (c % (kTQ / 4)) * 4;
        const int kk = k0 + r, qq = q0 + cq;
        copy4(a + r * kTQ + cq, p.a + (size_t)kk * p.tq + qq, kk < ke ? min(4, p.tq - qq) : 0);
      }
    } else if constexpr (A == kNatural) {  // 16 queries x 32 k
      for (int c = tid; c < kStepK * kTQ / 4; c += kPThreads) {
        const int q = c / (kStepK / 4), ck = (c % (kStepK / 4)) * 4;
        const int qq = q0 + q, kk = k0 + ck;
        copy4(a + q * kANat + ck, p.a + (size_t)qq * p.k + kk, qq < p.tq ? min(4, ke - kk) : 0);
      }
    } else {  // S^T's column over these 32 k, from the iotas
      for (int c = tid; c < kStepK; c += kPThreads) {
        const int kk = k0 + c;
        const float wy = kk / p.ww == p.iy ? 1.f : 0.f;
        const float wx = kk % p.ww == p.ix ? p.wx : 0.f;
        a[c] = kk < ke ? wy * wx : 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    else cp_async_commit();  // an empty group keeps the count of groups in step
  }
  for (int st = 0; st < steps; ++st) {
    if (st + kStages - 1 < steps) load(st + kStages - 1);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();  // stage st has landed
    __syncthreads();
    const float* a = as[st % kStages];
    const float* b = bs[st % kStages];
#pragma unroll 8
    for (int kk = 0; kk < kStepK; ++kk) {
      const float av = A == kTransposed ? a[kk * kTQ + qi]
                       : A == kNatural  ? a[qi * kANat + kk]
                                        : a[kk];
      const float4 bv = *reinterpret_cast<const float4*>(b + kk * kTD + dg);
      acc[0] = fmaf(av, bv.x, acc[0]);
      acc[1] = fmaf(av, bv.y, acc[1]);
      acc[2] = fmaf(av, bv.z, acc[2]);
      acc[3] = fmaf(av, bv.w, acc[3]);
    }
    __syncthreads();  // the slot is free for the load of stage st + kStages
  }
  cp_async_wait<0>();

  // fold: each thread's four outputs go to the rank that owns them (rank r
  // outputs kShare * r.. of the tile), which sums the ranks' in rank order
  const int o = qi * kTD + dg;
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  *cluster.map_shared_rank(reinterpret_cast<float4*>(&part[rank][o % kShare]), o / kShare) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  cluster.sync();
  if (tid < kShare) {
    const int oo = rank * kShare + tid;
    float sum = part[0][tid];
#pragma unroll
    for (int r = 1; r < kRanks; ++r) sum += part[r][tid];
    const int q = q0 + oo / kTD, d = d0 + oo % kTD;
    if (q < p.tq && d < p.d) p.out[(size_t)q * p.d + d] = sum;
  }
}

template <int A>
cudaError_t launch_product(const ProductArgs& p, cudaStream_t s) {
  static bool wide_set = false;  // clusters above 8 blocks need the kernel's consent
  if (!wide_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        product_kernel<A>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks, (p.tq + kTQ - 1) / kTQ, (p.d + kTD - 1) / kTD);
  cfg.blockDim = dim3(kPThreads);
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kRanks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, product_kernel<A>, p);
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
  // 16-byte copies where every row of a and b starts 16-byte aligned and
  // every chunk lies wholly in or out of range (k ranges are multiples of 4)
  const int vec = d % 4 == 0 && (a_src == kTransposed ? tq % 4 == 0
                                 : a_src == kNatural  ? k % 4 == 0
                                                      : 1);
  ProductArgs p{static_cast<const float*>(a), static_cast<const float*>(b),
                static_cast<float*>(out), tq, k, d, ww, iy, ix, wx, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a_src) {
    case kTransposed: return (int)launch_product<kTransposed>(p, s);
    case kNatural: return (int)launch_product<kNatural>(p, s);
    case kOneHot: return (int)launch_product<kOneHot>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
