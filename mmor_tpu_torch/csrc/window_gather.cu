// K10d: the window gather of the DMA-gather microbenchmark. For each index
// pair (y, x), out[i] = f[y:y+2, x8:x8+16, :] with x8 = (x // 8) * 8, an
// exact copy of two rows of 16 map positions.
//
// Replaces tools/perf/bench_dma_gather.py::dma_gather (kernel, the
// pl.pallas_call at :67), which issues one DMA a window from the scalar core.
//
// What bounds it on the H100: the bytes written. The (92, 160, 32) bf16 map
// of the benchmark (942 KB) sits in L2, so the reads barely reach device
// memory; 2^18 windows of 2 KB are 537 MB of output, 0.160 ms at 3.35 TB/s.
//
// Design: a direct gather, one warp a window. A window's two rows are each
// 16 * C contiguous map entries (the map is (H, W, C) row-major and x8 is a
// multiple of 8, so with C % 8 == 0 every row starts 16-byte aligned), and
// its output is 32 * C contiguous entries: the warp copies 16-byte chunks,
// lane l taking chunks l, l + 32, ..., so each load and each store of the
// warp covers 512 contiguous bytes. x8 is kept as the TPU kernel aligns it:
// it is part of the function. A window that would reach outside the map
// (y < 0, y + 2 > H, x8 < 0 or x8 + 16 > W) is written as zeros and nothing
// outside the map is read (the plain version does the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
window_gather_kernel(const int* __restrict__ idx, const uint4* __restrict__ f,
                     uint4* __restrict__ out, int n, int h, int w, int c) {
  const int lane = threadIdx.x % 32;
  const int chunks_row = 16 * c / 8;  // 16-byte chunks in one window row (8 bf16 a chunk)
  const int chunks = 2 * chunks_row;
  for (int i = blockIdx.x * kWarps + threadIdx.x / 32; i < n; i += gridDim.x * kWarps) {
    const int y = idx[2 * i], x = idx[2 * i + 1];
    const int x8 = (x >= 0 ? x / 8 : (x - 7) / 8) * 8;  // floor, as Python's //
    const bool inside = y >= 0 && y + 2 <= h && x8 >= 0 && x8 + 16 <= w;
    const uint4* src = inside ? f + ((size_t)y * w + x8) * c / 8 : f;
    uint4* dst = out + (size_t)i * chunks;
    for (int j = lane; j < chunks; j += 32) {
      const int dy = j / chunks_row, off = j % chunks_row;
      dst[j] = inside ? src[(size_t)dy * w * c / 8 + off] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

}  // namespace

// K10d: idx (N, 2) int32 pairs (y, x); f (H, W, C) bf16 with C % 8 == 0;
// out (N, 2, 16, C) bf16.
extern "C" int mmor_window_gather(const void* idx, const void* f, void* out, int n, int h, int w,
                                  int c, void* stream) {
  if (n < 0 || c % 8 != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (int)(((long long)n + kWarps - 1) / kWarps);
  window_gather_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const uint4*>(f), static_cast<uint4*>(out), n, h,
      w, c);
  return (int)cudaGetLastError();
}
