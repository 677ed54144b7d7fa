"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases of the kernels' contracts that the serving shapes in
``chip_smoke.py`` do not reach: ragged rows and columns, Sq != Sk, separate
key segment ids, fully masked query rows, f32 activations, the last layer of
a cache stack. Every test needs a CUDA device and skips without one (the
kernels have no CPU mode); run them on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -q``.

Tolerances: bf16 attention rel_l2 <= 2e-2 (the kernels round the softmax
weights to bf16 before P.V, unnormalized, where the plain version rounds
them normalized); W8A8 bit-exact (same integer products, same epilogue
order); W8A16 rel_l2 <= 1e-3 (f32 sums in another order, one bf16 rounding).
"""

import numpy as np
import pytest
import torch

from mmor_tpu_torch.ops import attention as A
from mmor_tpu_torch.ops import quantized_matmul as Q

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def randn(gen, *shape, dev, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("sq,sk,d,causal,kv_seg", [
    (100, 100, 16, True, False),
    (77, 130, 32, False, True),   # Sq != Sk, separate key segments
    (40, 129, 64, True, False),   # causal offset Sk - Sq
    (65, 65, 128, False, False),
])
def test_flash_attention_kernel(dev, sq, sk, d, causal, kv_seg):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (randn(g, 2, 3, s, d, dev=dev) for s in (sq, sk, sk))
    seg = torch.ones(2, sq, dtype=torch.int32, device=dev)
    seg[0, : sq // 3] = 0
    kw = dict(causal=causal, segment_ids=seg)
    if kv_seg:
        kseg = torch.ones(2, sk, dtype=torch.int32, device=dev)
        kseg[0, : sk // 3] = 0
        kseg[1, -5:] = 7  # keys no query can see
        kw["kv_segment_ids"] = kseg
    elif sq != sk:
        kw["segment_ids"] = None
    before = A.flash_attention.launches
    out = A.flash_attention(q, k, v, **kw)
    ref = A.mha_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert rel_l2(out, ref) <= 2e-2


def test_flash_attention_fully_masked_rows_are_zero(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (randn(g, 1, 2, 48, 64, dev=dev) for _ in range(3))
    qseg = torch.zeros(1, 48, dtype=torch.int32, device=dev)
    qseg[0, 40:] = 5  # no key carries segment 5
    kseg = torch.zeros(1, 48, dtype=torch.int32, device=dev)
    out = A.flash_attention(q, k, v, segment_ids=qseg, kv_segment_ids=kseg)
    ref = A.mha_reference(q, k, v, segment_ids=qseg, kv_segment_ids=kseg)
    assert not out[:, :, 40:].any()
    assert rel_l2(out[:, :, :40], ref[:, :, :40]) <= 2e-2


def test_flash_attention_refuses_gradients_and_cpu_segments(dev):
    q = torch.zeros(1, 1, 8, 16, dtype=torch.bfloat16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        A.flash_attention(q, q.detach(), q.detach())
    x = q.detach()
    with pytest.raises(ValueError):
        A.flash_attention(x, x, x, segment_ids=torch.zeros(1, 8, dtype=torch.int32))


@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 128, 40, torch.bfloat16),
    (13, 192, 72, torch.bfloat16),   # decode kernel, ragged N
    (100, 256, 90, torch.bfloat16),  # tiled kernel, ragged M and N, N % 4 != 0
    (70, 128, 64, torch.float32),
])
def test_int8_matmul_kernel(dev, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(2)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    x[0] = 0  # a zero row takes row scale 1
    w_q, scale = Q.quantize_weights(torch.randn(k, n, generator=g, device=dev) * 0.05)
    w_p = Q.pack_int8_rows(w_q)
    before = Q.int8_matmul_packed.launches
    out = Q.int8_matmul_packed(x, w_p, scale)
    ref = Q.int8_matmul_packed_plain(x, w_p, scale)
    torch.cuda.synchronize()
    assert Q.int8_matmul_packed.launches == before + 1
    np.testing.assert_array_equal(out.float().cpu().numpy(), ref.float().cpu().numpy())
    out16 = Q.int8_matmul_packed(x, w_p, scale, int8_mxu=False)
    ref16 = Q.int8_matmul_packed_plain(x, w_p, scale, int8_mxu=False)
    assert out16.dtype == dtype
    assert rel_l2(out16, ref16) <= 1e-3


@pytest.mark.parametrize("d,t", [(64, 200), (128, 1)])
def test_decode_attention_kernel_last_layer(dev, d, t):
    g = torch.Generator(device=dev).manual_seed(3)
    L, B, H = 3, 3, 4
    k8, v8 = (torch.randint(-127, 128, (L, B, H, t, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(L, B, H, t, generator=g, device=dev) * 0.02 + 0.005)
              .to(torch.bfloat16) for _ in range(2))
    mask = torch.ones(B, t, dtype=torch.int32, device=dev)
    mask[1, : t // 2] = 0
    q = randn(g, B, H, 1, d, dev=dev)
    args = (q, k8, v8, ks, vs, mask, L - 1)
    before = A.decode_attention_packed_stack.launches
    out = A.decode_attention_packed_stack(*args)
    ref = A.decode_attention_packed_stack_plain(*args)
    torch.cuda.synchronize()
    assert A.decode_attention_packed_stack.launches == before + 1
    assert out.shape == (B, H, 1, d)
    assert rel_l2(out, ref) <= 1e-2
    with pytest.raises(IndexError):
        A.decode_attention_packed_stack(q, k8, v8, ks, vs, mask, L)
