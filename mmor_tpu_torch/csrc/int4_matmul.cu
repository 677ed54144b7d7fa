// K3: packed int4 weight matmul (W4A8), x @ (unpack4(w_p) * scale).
//
// Replaces mmor_tpu/ops/quantized_matmul.py::int4_matmul_packed
// (_packed4_kernel, the pl.pallas_call at :441).
//
// What bounds it on the H100: at decode rows (M = batch) every weight byte
// is read once for 32 multiply-adds, so the product is bound by device-memory
// bandwidth on the half-size int4 weights; at prefill (M = 8 x 708) it is
// bound by the int8 tensor-core rate.
//
// Design: the JAX weight layout stays as it is (pack_int4_rows with
// block = group: byte b of word r holds rows 4r+b and group/2+4r+b of a
// group as biased nibbles). Masking a word with 0x0F0F0F0F, or shifting it
// by 4 first, gives a pack_int8_rows word of the group's first or second
// half, which is a B register of mma.sync.m16n8k32.s8; __vsub4 with
// 0x08080808 removes the +8 bias byte by byte, so each group's dot is the
// exact signed int32 sum and the TPU kernel's 8 * rowsum correction is not
// needed. The activations are quantized per row first (K2's kernel, the
// plain version's arithmetic).
//  - skinny kernel (M <= 16): w4a8.cuh.
//  - tiled kernel (prefill): 64 x 64 block tiles, a 2 x 2 warp grid of
//    32 x 32 warp tiles; per K-group the block stages 16 weight word rows
//    (64 rows of each half) and the two matching 64-row activation slices
//    through shared memory, sums the group's int32 dot, and folds it in
//    group order: acc += float(dot) * scale[group, col] in f32
//    (__fmul_rn/__fadd_rn, never contracted); the row scale applies last.
// Both kernels therefore agree bit for bit with int4_matmul_packed_plain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "w4a8.cuh"

namespace {

constexpr int kTileM = 64, kTileN = 64, kTileKW = 16;  // KW: word rows a stage
constexpr int kXStride = kTileKW + 4;  // conflict-free A fragment reads
constexpr int kWStride = kTileN + 8;   // conflict-free B fragment reads

template <typename OutT>
__global__ void __launch_bounds__(128)
w4a8_tiled_kernel(const uint32_t* __restrict__ xq, const uint32_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ rs,
                  OutT* __restrict__ out, int m, int k, int n, int group) {
  __shared__ __align__(16) uint32_t xs[2][kTileM * kXStride];  // low, high half
  __shared__ __align__(16) uint32_t ws[kTileKW * kWStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int kw = k / 4, gw = group / 8;
  const bool vec_w = (n % 4) == 0;

  float accf[2][4][4] = {};
  for (int grp = 0; grp < k / group; ++grp) {
    int acc[2][4][4] = {};
    for (int pos = 0; pos < gw; pos += kTileKW) {
      // activation words of both halves: 64 rows x 16 words each
      for (int c = threadIdx.x; c < 2 * kTileM * kTileKW / 4; c += 128) {
        const int half = c / (kTileM * kTileKW / 4), cc = c % (kTileM * kTileKW / 4);
        const int r = cc / (kTileKW / 4), cw = (cc % (kTileKW / 4)) * 4;
        const int word = grp * (group / 4) + half * (group / 8) + pos + cw;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (m0 + r < m)
          val = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * kw + word);
        *reinterpret_cast<uint4*>(&xs[half][r * kXStride + cw]) = val;
      }
      // weight words: 16 word rows x 64 columns
      for (int c = threadIdx.x; c < kTileKW * kTileN / 4; c += 128) {
        const int r = c / (kTileN / 4), cc = (c % (kTileN / 4)) * 4;
        const int col = n0 + cc;
        const uint32_t* src = w + (size_t)(grp * gw + pos + r) * n + col;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (vec_w && col + 3 < n) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          val.x = col < n ? src[0] : 0u;
          val.y = col + 1 < n ? src[1] : 0u;
          val.z = col + 2 < n ? src[2] : 0u;
          val.w = col + 3 < n ? src[3] : 0u;
        }
        *reinterpret_cast<uint4*>(ws + r * kWStride + cc) = val;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kTileKW / 8; ++ks) {
        uint32_t bw[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* wr = ws + (ks * 8 + t4) * kWStride + wn * 32 + nt * 8 + g;
          bw[nt][0] = wr[0];
          bw[nt][1] = wr[4 * kWStride];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t* xr =
                &xs[half][(wm * 32 + mt * 16 + g) * kXStride + ks * 8 + t4];
            a[mt][0] = xr[0];
            a[mt][1] = xr[8 * kXStride];
            a[mt][2] = xr[4];
            a[mt][3] = xr[8 * kXStride + 4];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t b[2] = {
                half ? w4a8::high_s8(bw[nt][0]) : w4a8::low_s8(bw[nt][0]),
                half ? w4a8::high_s8(bw[nt][1]) : w4a8::low_s8(bw[nt][1])};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) w4a8::mma_s8(acc[mt][nt], a[mt], b);
          }
        }
      }
      __syncthreads();
    }
    // fold this group's exact dot with its scale, in group order
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + wn * 32 + nt * 8 + t4 * 2 + (e & 1);
          const float sc = col < n ? scale[(size_t)grp * n + col] : 0.f;
          accf[mt][nt][e] =
              __fadd_rn(accf[mt][nt][e], __fmul_rn((float)acc[mt][nt][e], sc));
        }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + t4 * 2 + (e & 1);
        if (row < m && col < n)
          out[(size_t)row * n + col] = from_float<OutT>(__fmul_rn(accf[mt][nt][e], rs[row]));
      }
}

template <typename T>
cudaError_t launch_w4a8(const void* x, void* xq, void* row_scale, const void* w,
                        const float* scale, void* out, int m, int k, int n,
                        int group, cudaStream_t s) {
  float* rs = static_cast<float*>(row_scale);
  quantize_rows_kernel<T><<<m, kQuantThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), rs, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const uint32_t* x32 = static_cast<const uint32_t*>(xq);
  const uint32_t* w32 = static_cast<const uint32_t*>(w);
  if (m <= 16) {
    w4a8::SkinnyArgs p{x32, rs, w32, scale, nullptr, out, m, k, n, group, group};
    return w4a8::launch_skinny<w4a8::kRowScale, T>(p, s);
  }
  dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  w4a8_tiled_kernel<T><<<grid, 128, 0, s>>>(x32, w32, scale, rs, static_cast<T*>(out),
                                           m, k, n, group);
  return cudaGetLastError();
}

}  // namespace

// W4A8: x (M, K) bf16 (x_bf16 = 1) or f32; xq (M, K) int8 and row_scale
// (M,) f32 are scratch the activation quantization fills; w (K/8, N) int32
// packed by pack_int4_rows(block=group), scale (K/group, N) f32; out (M, N)
// in x's dtype. K and group must be multiples of 256, K of group.
extern "C" int mmor_int4_matmul_w4a8(const void* x, void* xq, void* row_scale,
                                     const void* w, const void* scale, void* out,
                                     int m, int k, int n, int group, int x_bf16,
                                     void* stream) {
  if (group % 256 != 0 || k % group != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return x_bf16 ? (int)launch_w4a8<__nv_bfloat16>(x, xq, row_scale, w, sc, out, m, k,
                                                  n, group, s)
                : (int)launch_w4a8<float>(x, xq, row_scale, w, sc, out, m, k, n,
                                          group, s);
}
