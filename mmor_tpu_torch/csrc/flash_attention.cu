// K1: flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces mmor_tpu/ops/attention.py::flash_attention (_flash_kernel /
// _flash_forward, the pl.pallas_call at :188).
//
// What bounds it on the H100: at the main path's shapes (CLIP 577 keys,
// pooler 4032, LLaMA prefill 708, PTv3 patches) attention is compute-bound
// on the QK^T and PV products; q/k/v are read once per query tile.
//
// Design: one block per (batch*head, 64-query tile), four warps of 16 query
// rows each. The TPU kernel walks the kv blocks as a sequential grid axis
// with the running max / sum / accumulator in VMEM scratch; a Hopper block
// cannot carry state across grid steps, so the kv walk is a loop inside the
// block with that state in registers. K and V tiles of 64 keys are staged in
// shared memory; QK^T and PV run on the tensor cores through mma.sync
// m16n8k16 (bf16 inputs, f32 accumulation), the probabilities round to bf16
// for PV exactly where the XLA reference casts its weights to v.dtype.
// Causal tiles above the diagonal are skipped. Masked logits (kv position
// >= Sk, unequal segment ids, causal) carry no weight; a query row with no
// unmasked key at all stores 0, as the TPU kernel's finish step intends.
// wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values into one register, the first in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 __nv_bfloat16* __restrict__ o, int heads, int sq, int sk,
                 int causal, float sm_scale) {
  constexpr int kStride = D + 8;  // padded smem row (bf16), 16-byte aligned
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK * kStride];
  __shared__ int seg_s[kBlockK];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * sk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * sk * D;

  // Q fragments (A operand, row-major 16 x 16 per k-step)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int col = ks * 16 + t4 * 2 + (r >> 1) * 8;
      qf[ks][r] = row < sq
          ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * D + col)
          : 0u;
    }
  }
  int seg_q[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    seg_q[r] = rows[r] < sq ? q_seg[(size_t)b * sq + rows[r]] : -1;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m_i[2] = {kMaskValue, kMaskValue};
  float l_i[2] = {0.f, 0.f};

  const int offset = sk - sq;  // causal: key j visible to query i iff j <= i + offset
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBlockQ + offset);

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    constexpr int kChunks = kBlockK * D / 8;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const int key = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)key * D + cc);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)key * D + cc);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + cc) = kv4;
      *reinterpret_cast<uint4*>(v_s + r * kStride + cc) = vv4;
    }
    for (int r = threadIdx.x; r < kBlockK; r += kThreads)
      seg_s[r] = k0 + r < sk ? kv_seg[(size_t)b * sk + k0 + r] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* krow = k_s + (nt * 8 + g) * kStride + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(krow + ks * 16);
        bf[1] = *reinterpret_cast<const uint32_t*>(krow + ks * 16 + 8);
        mma_bf16(s[nt], qf[ks], bf);
      }
    }

    // mask, scale, and the running max per row
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kl = nt * 8 + t4 * 2 + (e & 1);
        const int key = k0 + kl;
        bool ok = key < sk && rows[r] < sq && seg_s[kl] == seg_q[r];
        if (causal) ok = ok && key <= rows[r] + offset;
        const float val = ok ? s[nt][e] * sm_scale : kMaskValue;
        s[nt][e] = val;
        if (ok) mx[r] = fmaxf(mx[r], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = __expf(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // probabilities; a masked logit (== kMaskValue) carries no weight
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[nt][e] == kMaskValue ? 0.f : __expf(s[nt][e] - m_i[r]);
        s[nt][e] = p;
        l_i[r] += p;
      }
    }

    // O += P V: the S accumulator layout of two adjacent n-tiles is the A
    // operand layout of one 16-key k-step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack2f(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack2f(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack2f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack2f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = v_s + (kk * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bf[2];
        bf[0] = pack2(v0[nt * 8], v0[kStride + nt * 8]);
        bf[1] = pack2(v0[8 * kStride + nt * 8], v0[9 * kStride + nt * 8]);
        mma_bf16(acc[nt], pf, bf);
      }
    }
  }

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
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(ob + (size_t)rows[r] * D + col) =
          pack2f(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_seg, const void* kv_seg, void* o, int bh,
                   int heads, int sq, int sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<__nv_bfloat16*>(o), heads,
      sq, sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o: (batch*heads, S, D) bf16 contiguous; q_seg (batch, Sq) and
// kv_seg (batch, Sk) int32. Returns the launch's cudaError_t.
extern "C" int mmor_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_seg, const void* kv_seg,
                                    void* o, int bh, int heads, int sq, int sk,
                                    int head_dim, int causal, float sm_scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(q, k, v, q_seg, kv_seg, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 32: return launch<32>(q, k, v, q_seg, kv_seg, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 64: return launch<64>(q, k, v, q_seg, kv_seg, o, bh, heads, sq, sk, causal, sm_scale, s);
    case 128: return launch<128>(q, k, v, q_seg, kv_seg, o, bh, heads, sq, sk, causal, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
