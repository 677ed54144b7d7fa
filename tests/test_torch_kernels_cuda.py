"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases of the kernels' contracts that the serving shapes in
``chip_smoke.py`` do not reach: ragged rows and columns, Sq != Sk, separate
key segment ids, fully masked query rows, f32 activations, the last layer of
a cache stack, a decode batch row with no valid cache position, the batch
bucket after EOS compaction. Every test needs a CUDA device and skips
without one (the kernels have no CPU mode); run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.

Tolerances: bf16 attention rel_l2 <= 2e-2 (the kernels round the softmax
weights to bf16 before P.V, unnormalized, where the plain version rounds
them normalized); W8A8 and W4A8 bit-exact (same integer products, same
epilogue order); W8A16 rel_l2 <= 1e-3 (f32 sums in another order, one bf16
rounding); K5 x_out rel_l2 <= 2e-3 and its new K/V columns identical in
>= 99.9% of entries, never more than 1 apart (f32 sums in another order in
RMSNorm and softmax can move an int8 activation bin by one); K6 rel_l2
<= 1e-3 in bf16 (both versions round the same f32 sum once; the sums' order
differs) and max abs <= 1e-5 in f32, exact where a sample sits on a pixel
centre with weight 1 or wholly off the map.
"""

import numpy as np
import pytest
import torch

from mmor_tpu_torch.ops import attention as A
from mmor_tpu_torch.ops import deformable_sampler as D
from mmor_tpu_torch.ops import mega_decode as M
from mmor_tpu_torch.ops import quantized_matmul as Q
from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn

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


@pytest.mark.parametrize("m,k,n,group,dtype", [
    (1, 256, 40, 256, torch.bfloat16),
    (13, 1024, 72, 256, torch.bfloat16),     # decode kernel, ragged N
    (100, 2048, 90, 1024, torch.bfloat16),   # tiled kernel, ragged M and N, N % 4 != 0
    (70, 512, 64, 256, torch.float32),       # f32 activations
])
def test_int4_matmul_kernel(dev, m, k, n, group, dtype):
    g = torch.Generator(device=dev).manual_seed(4)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    x[0] = 0  # a zero row takes row scale 1
    w_q, scale = Q.quantize_weights_int4(torch.randn(k, n, generator=g, device=dev) * 0.05,
                                         group)
    w_p = Q.pack_int4_rows(w_q, group)
    before = Q.int4_matmul_packed.launches
    out = Q.int4_matmul_packed(x, w_p, scale, group=group)
    ref = Q.int4_matmul_packed_plain(x, w_p, scale, group=group)
    torch.cuda.synchronize()
    assert Q.int4_matmul_packed.launches == before + 1
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.float().cpu().numpy(), ref.float().cpu().numpy())
    with pytest.raises(NotImplementedError):
        Q.int4_matmul_packed(x, w_p, scale, group=group, int8_mxu=False)


def _mega_inputs(dev, batch: int, t_cap: int = 64, n_layers: int = 2):
    """Random int4 weights (dim 512, 4 heads of 128, ffn 1024, group 256)
    and an int4 cache whose rows hold different numbers of positions."""
    g = torch.Generator(device=dev).manual_seed(5)
    d, f, h, grp = 512, 1024, 4, 256
    shapes = ((d, 3 * d), (d, d), (d, 2 * f), (f, d))
    layers = [[] for _ in range(8)]
    for _ in range(n_layers):
        for i, (k, n) in enumerate(shapes):
            w_q, sc = Q.quantize_weights_int4(
                torch.randn(k, n, generator=g, device=dev) * 0.02, grp)
            layers[2 * i].append(Q.pack_int4_rows(w_q, grp))
            layers[2 * i + 1].append(sc)
    weights = M.MegaWeights(layers, 1 + 0.1 * torch.randn(n_layers, 2, d, generator=g,
                                                          device=dev), grp, f, h)
    shape = (n_layers, batch, h, t_cap, 64)
    cache = {name: torch.randint(0, 256, shape, generator=g, device=dev,
                                 dtype=torch.int32).to(torch.uint8) for name in ("k", "v")}
    for name in ("k_s", "v_s"):
        cache[name] = (torch.rand(shape[:-1], generator=g, device=dev) * 0.05 + 0.01
                       ).to(torch.bfloat16)
    mask = torch.zeros(batch, t_cap, dtype=torch.int32, device=dev)
    for r in range(batch):
        mask[r, r % 8: t_cap - 8 - 4 * (r % 4)] = 1
    tok_pos = torch.arange(batch, dtype=torch.int32, device=dev) + 40
    cache.update(kv_mask=mask, write_pos=t_cap - 8, tok_pos=tok_pos)
    x = randn(g, batch, d, dev=dev)
    cos, sin = M.rope_tables(tok_pos, 128, 10000.0)
    return x, weights, cache, cos, sin


def _assert_mega_close(got, ref):
    assert rel_l2(got[0], ref[0]) <= 2e-3
    for i in (1, 3):
        diff = (got[i].int() - ref[i].int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    for i in (2, 4):
        assert rel_l2(got[i], ref[i]) <= 2e-3


@pytest.mark.parametrize("case", ["two_layers", "fully_masked_row", "bucket_after_compaction"])
def test_mega_decode_kernel(dev, case):
    x, weights, cache, cos, sin = _mega_inputs(dev, 16 if case.startswith("bucket") else 8)
    if case == "fully_masked_row":
        cache["kv_mask"][3] = 0  # row 3 attends to its current token alone
    if case == "bucket_after_compaction":
        lanes = torch.tensor([0, 2, 5, 9, 12, 15, 15, 15], device=dev)
        cache = M.compact_cache(cache, lanes)
        x, cos, sin = x[lanes].contiguous(), cos[lanes], sin[lanes]
    before = M.mega_decode_layers.launches
    got = M.mega_decode_layers(x, weights, cache, cos, sin)
    ref = M.mega_decode_layers_plain(x, weights, cache, cos, sin)
    torch.cuda.synchronize()
    assert M.mega_decode_layers.launches == before + 1
    assert got[0].shape == x.shape and got[1].shape == (2, x.shape[0], 4, 128)
    _assert_mega_close(got, ref)  # both layers, the last one included


def _k6_args(g, dev, shapes, n, lq, m, d, dtype, spread=0.2):
    """Locations uniform in [-spread, 1 + spread] (some off the map), weights
    softmaxed over L x P in ``dtype``."""
    levels, points = len(shapes), 4
    s = sum(h * w for h, w in shapes)
    value = randn(g, n, s, m, d, dev=dev, dtype=dtype)
    loc = torch.rand(n, lq, m, levels, points, 2, generator=g, device=dev)
    loc = loc * (1 + 2 * spread) - spread
    attn = torch.softmax(torch.randn(n, lq, m, levels * points, generator=g, device=dev), -1)
    return value, loc, attn.to(dtype).view(n, lq, m, levels, points)


@pytest.mark.parametrize("shapes,n,lq,d,dtype", [
    (((1, 1), (1, 7), (5, 1), (6, 9)), 1, 37, 4, torch.float32),  # 1-pixel levels
    (((23, 40), (46, 80)), 3, 1001, 32, torch.bfloat16),
    (((8, 8), (16, 16), (32, 32)), 3, 333, 8, torch.float32),
    (((8, 8), (16, 16), (32, 32)), 1, 333, 32, torch.float32),
    (((4, 5), (8, 10)), 3, 77, 4, torch.bfloat16),
])
def test_ms_deform_attn_kernel(dev, shapes, n, lq, d, dtype):
    """Lq is no multiple of the 8 warps of a block; D 4 and 8 share a warp
    between heads."""
    g = torch.Generator(device=dev).manual_seed(6)
    value, loc, attn = _k6_args(g, dev, shapes, n, lq, 8, d, dtype)
    before = D.ms_deform_attn_sampler.launches
    got = D.ms_deform_attn_sampler(value, shapes, loc, attn)
    ref = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert D.ms_deform_attn_sampler.launches == before + 1
    assert got.shape == (n, lq, 8 * d) and got.dtype == dtype
    if dtype == torch.bfloat16:
        assert rel_l2(got, ref) <= 1e-3
    else:
        assert float((got - ref).abs().max()) <= 1e-5


def test_ms_deform_attn_kernel_exact_samples(dev):
    """Weight 1 on a sample at a pixel centre gives that pixel's value; a
    query whose samples all lie far off the map (weights 0 and 1) gives 0."""
    g = torch.Generator(device=dev).manual_seed(7)
    shapes = ((4, 8), (2, 4))  # power-of-2 sizes: pixel centres exact in f32
    value, loc, attn = _k6_args(g, dev, shapes, 2, 5, 2, 8, torch.float32)
    loc[:] = torch.tensor([-3.0, 4.5], device=dev)  # every sample off the map
    attn.zero_()
    attn[:, :, :, 0, 0] = 1.0
    row, col = 2, 5  # level 0's pixel (2, 5), centre ((5 + .5) / 8, (2 + .5) / 4)
    loc[:, 1, :, 0, 0] = torch.tensor([(col + 0.5) / 8, (row + 0.5) / 4], device=dev)
    got = D.ms_deform_attn_sampler(value, shapes, loc, attn).view(2, 5, 2, 8)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1], value[:, row * 8 + col])
    assert torch.equal(got[:, [0, 2, 3, 4]], torch.zeros_like(got[:, [0, 2, 3, 4]]))


def test_ms_deform_attn_kernel_copies_non_contiguous_inputs(dev):
    """The wrapper makes non-contiguous operands contiguous (a copy) and
    gives the same result; it refuses gradients, a ``loc`` that is not f32
    and weights in another dtype than the value's."""
    g = torch.Generator(device=dev).manual_seed(8)
    shapes = ((8, 10), (4, 5))
    value, loc, attn = _k6_args(g, dev, shapes, 3, 120, 8, 32, torch.bfloat16)
    strided = (value.transpose(1, 2).contiguous().transpose(1, 2),
               loc.permute(1, 0, 2, 3, 4, 5).contiguous().permute(1, 0, 2, 3, 4, 5),
               attn.transpose(0, 1).contiguous().transpose(0, 1))
    assert not any(x.is_contiguous() for x in strided)
    want = D.ms_deform_attn_sampler(value, shapes, loc, attn)
    got = D.ms_deform_attn_sampler(strided[0], shapes, strided[1], strided[2])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        D.ms_deform_attn_sampler(value, shapes, loc.bfloat16(), attn)
    with pytest.raises(TypeError):
        D.ms_deform_attn_sampler(value, shapes, loc, attn.float())
    with pytest.raises(NotImplementedError):
        D.ms_deform_attn_sampler(value.float().requires_grad_(), shapes, loc, attn.float())
