// Weight-word loaders shared by K8's tiled kernel (int8_matmul.cu), the
// row-word stream (stream_matmul.cu's stream_kernel: K10c's bf16 mode, K2's
// W8A16 at decode rows) and the megakernel probe's x-read product
// (megakernel_probe.cu). A word is
// the 32 bits of one column that feed one thread's mma B register:
//  - kWords: the weight is already (R, N) int32 words (pack_int8_rows'
//    rows 4r..4r+3), one load;
//  - kBytes: the unpacked row-major (K, N) int8 weight; word r of a column
//    is the bytes of rows 4r..4r+3, lowest row in the lowest byte.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum class WLayout { kWords, kBytes };

// word r of column col (N = n columns)
template <WLayout L>
__device__ __forceinline__ uint32_t w_word(const void* w, int r, int col, int n) {
  if constexpr (L == WLayout::kWords) {
    return static_cast<const uint32_t*>(w)[(size_t)r * n + col];
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(w) + (size_t)4 * r * n + col;
    return (uint32_t)p[0] | ((uint32_t)p[n] << 8) | ((uint32_t)p[(size_t)2 * n] << 16) |
           ((uint32_t)p[(size_t)3 * n] << 24);
  }
}

// word r of the four neighbouring columns col..col+3 (col % 4 == 0,
// N % 4 == 0): one 16-byte load of a word row, or four 4-byte loads of the
// byte rows, their 4 x 4 bytes transposed
template <WLayout L>
__device__ __forceinline__ uint4 w_words4(const void* w, int r, int col, int n) {
  if constexpr (L == WLayout::kWords) {
    return *reinterpret_cast<const uint4*>(static_cast<const uint32_t*>(w) +
                                           (size_t)r * n + col);
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(w) + (size_t)4 * r * n + col;
    uint32_t row[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[i] = *reinterpret_cast<const uint32_t*>(p + (size_t)i * n);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = ((row[0] >> (8 * j)) & 0xffu) | (((row[1] >> (8 * j)) & 0xffu) << 8) |
             (((row[2] >> (8 * j)) & 0xffu) << 16) | (((row[3] >> (8 * j)) & 0xffu) << 24);
    return make_uint4(c[0], c[1], c[2], c[3]);
  }
}

}  // namespace
