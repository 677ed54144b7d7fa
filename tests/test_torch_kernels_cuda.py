"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases of the kernels' contracts that the serving shapes in
``chip_smoke.py`` do not reach: ragged rows and columns, Sq != Sk, separate
key segment ids, fully masked query rows, f32 activations, the last layer of
a cache stack, a decode batch row with no valid cache position, the batch
bucket after EOS compaction, K5's piggyback-prefill rows (empty, mid and
last chunks of the working cache, a chunk with one real column, the decode
rows bit-identical with and without them), each K5 case at the four
(weight, KV cache) width pairs, and a cache whose dtype does not match its
width; K3's two branches (W4A8 and W4A16) at M 1, 13, 16, 17, 64, 70, 100
and 300, N % 128 != 0 and N % 4 != 0 (cp.async words), one group and
several of 256 and 1024 rows, bf16 and f32 x, with a zero row; K5's weight
core alone (``mega_project``) bit for bit at the four 7B
projections, both widths and R 1, 8, 14, 16, 17 and 136, and at ragged
edges (N not a multiple of the strip, N % 4 != 0 by cp.async, odd chunk
and group counts, chunks that split an int4 group, two slabs), with K
split across a cluster of 2-5 blocks (uneven runs of units), and the plans
it refuses; K7's f32 and bf16 scales and a fully masked row, K4 and K7
at the edges of their clusters' ranks (8 ranks, T off a rank's span, rows
with one valid position or none, masks with holes, T = 1, head dims 16
to 256, a head dim they refuse); K2's W8A16 branch at 1, 13, 16, 17, 257,
300 and 5667 rows, the lm_head's 32000 columns, N % 4 != 0, K % 128 != 0,
f32 x, and K % 64 != 0 refused; K8's stream
kernel at one row and at 16, its weight by TMA, by cp.async (N % 16 != 0)
and byte by byte (N % 4 != 0), one k tile and a ragged last one, and its
tiled kernel above 16 rows, K10a and K10b's ragged N and M above
one 16-row tile; K9 at one row, at the 7B tail, above one 16-row tile and
above 64 rows, with an f32 residual, and its refusals; K10c's two modes at
ragged shapes; K10d's windows that reach outside the map; K10e's x-read at
both x layouts and widths (two row groups, half a row group, a bf16 tile
past shared memory refused), tiny, nibble and row kernels (both modes, one
head, one 128-column block), K10f's copies and products at ragged shapes
(K that the cluster's 16 ranks do not divide, ranks with no k).
Every test needs a CUDA device and skips without one (the kernels have no CPU mode); run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.

Tolerances: bf16 attention rel_l2 <= 2e-2 (the kernels round the softmax
weights to bf16 before P.V, unnormalized, where the plain version rounds
them normalized); W8A8 and W4A8 bit-exact (same integer products, same
epilogue order), K8 too, W4A16 rel_l2 <= 1e-3 for bf16 x and 5e-3 for f32
x (x rounded to bf16, as on the TPU), and K5's weight core (the same exact int32 dots
folded in the same order with the same f32 roundings as
``_w4a8_chunks``/``_w8a8_chunks``, and the same epilogue expressions);
W8A16 (K2's, K10a, K10b) rel_l2 <= 1e-3 (f32 sums
in another order, one bf16 rounding; 1e-5 in f32; K2's kernels round f32 x
to bf16 first, as the TPU branch does, so f32 cases are held to the plain
version on the rounded x, and within 5e-3 of it on the f32 x); K7 rel_l2 <= 3e-4 (f32
sums in another order, one rounding to the output's dtype; the kernel on
bf16 copies of f32 scales must miss it); K5 x_out rel_l2 <= 2e-3 and its new K/V columns identical in
>= 99.9% of entries, never more than 1 apart (f32 sums in another order in
RMSNorm and softmax can move an int8 activation bin by one); K6 rel_l2
<= 1e-3 in bf16 (both versions round the same f32 sum once; the sums' order
differs) and max abs <= 1e-5 in f32, exact where a sample sits on a pixel
centre with weight 1 or wholly off the map; K9 rel_l2 <= 1e-3 (the same
bf16 operands and f32 products summed in another order; h and m round one
bf16 step apart at near-ties) and bit-identical from call to call; K10c
mxu8 bit-exact (K2's kernels, K8's rule), bf16 as K10b; K10d bit-exact;
K10e x-read int8 and tiny bit-exact, x-read bf16 and nibble within one bf16
step at the largest output, the row probe rel_l2 <= 1e-6; K10f copies
bit-exact, products rel_l2 <= 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from mmor_tpu_torch.ops import _build
from mmor_tpu_torch.ops import attention as A
from mmor_tpu_torch.ops import deformable_sampler as D
from mmor_tpu_torch.ops import fused_mlp as FM
from mmor_tpu_torch.ops import mega_decode as M
from mmor_tpu_torch.ops import quantized_matmul as Q
from mmor_tpu_torch.ops.deformable_attention import ms_deform_attn
from mmor_tpu_torch.tools.perf import bench_bitcast as BC
from mmor_tpu_torch.tools.perf import bench_dma_gather as DG
from mmor_tpu_torch.tools.perf import bench_megakernel_probe as MP
from mmor_tpu_torch.tools.perf import bench_packed as P
from mmor_tpu_torch.tools.perf import bench_w8a16 as W
from mmor_tpu_torch.tools.perf import probe_mosaic_reshape as RP
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

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


K7_BOUND = 3e-4  # chip_smoke.py's, which gives its measurements


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


def _segments(kind, b, sq, sk, g, dev):
    """(causal, query ids, key ids) of the masks K1's tile skipping meets."""
    if kind == "patches_tail":  # sorted patches, the invalid tail -1 (PTv3)
        seg = (torch.arange(sq, device=dev, dtype=torch.int32) // 100)[None].repeat(b, 1)
        seg[:, sq - 90:] = -1
        return False, seg, None
    if kind == "absent_views":  # the pooler's absent views as segment 0
        seg = torch.ones(b, sq, dtype=torch.int32, device=dev)
        seg[:, sq * 5 // 7:] = 0
        return False, seg, None
    if kind == "unsorted":  # random ids on separate keys
        return (False, torch.randint(0, 3, (b, sq), generator=g, device=dev, dtype=torch.int32),
                torch.randint(0, 3, (b, sk), generator=g, device=dev, dtype=torch.int32))
    if kind == "causal_leftpad":  # LLaMA's prefill mask
        seg = torch.ones(b, sq, dtype=torch.int32, device=dev)
        for r in range(b):
            seg[r, : 37 * r] = 0
        return True, seg, None
    return True, None, None  # causal, Sq <= Sk


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("kind,sq,sk", [
    ("patches_tail", 700, 700),
    ("absent_views", 448, 448),
    ("unsorted", 191, 333),        # ragged against the 64- and 128-row tiles, Sq != Sk
    ("causal_leftpad", 257, 257),
    ("causal_short_q", 65, 300),   # causal with Sq < Sk
])
def test_flash_attention_kernel_tile_skipping(dev, d, kind, sq, sk):
    """K1 against mha_reference on the masks whose key tiles it skips, at
    each head dim (rel_l2 2e-2: P rounds to bf16 before PV, unnormalised)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (randn(g, 2, 2, s, d, dev=dev) for s in (sq, sk, sk))
    causal, seg, kv_seg = _segments(kind, 2, sq, sk, g, dev)
    kw = dict(causal=causal, segment_ids=seg, kv_segment_ids=kv_seg)
    out = A.flash_attention(q, k, v, **kw)
    ref = A.mha_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
    assert rel_l2(out, ref) <= 2e-2


@pytest.mark.parametrize("kind,sq,sk", [("patches_tail", 700, 700), ("unsorted", 191, 333)])
def test_flash_attention_prologue_fills_segment_tiles(dev, kind, sq, sk):
    """K1's prologue kernel leaves in its scratch what ``segment_tiles``
    computes: the tiles' id ranges and bits that the skip rule reads."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (randn(g, 2, 2, s, 64, dev=dev) for s in (sq, sk, sk))
    causal, seg, kv_seg = _segments(kind, 2, sq, sk, g, dev)
    q_seg, kv_seg = A.flash_segments(2, sq, sk, seg, kv_seg, dev)
    q_tiles = torch.full((2, -(-sq // 128), 3), 7, dtype=torch.int32, device=dev)
    k_tiles = torch.full((2, -(-sk // 128), 3), 7, dtype=torch.int32, device=dev)
    out, counter = torch.empty_like(q), torch.empty(4, dtype=torch.int32, device=dev)
    err = _build.library().mmor_flash_attention(
        *(_build.ptr(t) for t in (q, k, v, q_seg, kv_seg, q_tiles, k_tiles, counter, out)),
        4, 2, sq, sk, 64, int(causal), 0.125, A.FLASH_BLOCK_Q, A.FLASH_BLOCK_K, _build.stream())
    torch.cuda.synchronize()
    assert err == 0
    assert rel_l2(out, A.mha_reference(q, k, v, causal=causal, segment_ids=q_seg,
                                       kv_segment_ids=kv_seg)) <= 2e-2
    assert torch.equal(q_tiles, A.segment_tiles(q_seg, A.FLASH_BLOCK_Q))
    assert torch.equal(k_tiles, A.segment_tiles(kv_seg, A.FLASH_BLOCK_K))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_rows_without_keys_are_zero_at_each_head_dim(dev, d):
    """Rows whose segment no key carries store 0, whether their query tile
    visits key tiles (rows 150-255 share a tile with seen rows) or none
    (rows 256-299)."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (randn(g, 1, 2, 300, d, dev=dev) for _ in range(3))
    qseg = torch.zeros(1, 300, dtype=torch.int32, device=dev)
    qseg[0, 150:] = 5
    kseg = torch.zeros(1, 300, dtype=torch.int32, device=dev)
    out = A.flash_attention(q, k, v, segment_ids=qseg, kv_segment_ids=kseg)
    ref = A.mha_reference(q, k, v, segment_ids=qseg, kv_segment_ids=kseg)
    torch.cuda.synchronize()
    assert not out[:, :, 150:].any()
    assert rel_l2(out[:, :, :150], ref[:, :, :150]) <= 2e-2


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
    (5, 128, 70, torch.bfloat16),    # decode kernel, N % 4 != 0
    (14, 11008, 4096, torch.bfloat16),  # decode kernel at bench_decode_parts' batch
    (100, 256, 90, torch.bfloat16),  # wgmma kernel, ragged M and N, N % 4 != 0
    (70, 128, 64, torch.float32),
    (17, 4160, 4100, torch.bfloat16),   # wgmma kernel: K % 128 != 0, N off its tiles
    (100, 4160, 4100, torch.float32),
    (5667, 4160, 4100, torch.bfloat16),  # more than one 256-row tile, ragged
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
    before16 = Q.int8_matmul_packed.a16_launches
    out16 = Q.int8_matmul_packed(x, w_p, scale, int8_mxu=False)
    # the W8A16 kernels round f32 x to bf16, as the TPU branch does: the
    # plain version on the same rounded x
    xr = x.to(torch.bfloat16).to(dtype)
    ref16 = Q.int8_matmul_packed_plain(xr, w_p, scale, int8_mxu=False)
    torch.cuda.synchronize()
    assert Q.int8_matmul_packed.a16_launches == before16 + 1
    assert Q.int8_matmul_packed.launches == before + 1
    assert out16.dtype == dtype
    assert rel_l2(out16, ref16) <= 1e-3


@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 4096, 4096, torch.bfloat16),     # the row-word kernel at one row
    (16, 4096, 4100, torch.bfloat16),    # its last row count, N off its 32-column blocks
    (8, 4096, 32000, torch.bfloat16),    # the lm_head at decode
    (13, 192, 70, torch.float32),        # N % 4 != 0, f32 x rounded by the pre-pass
    (17, 4160, 4100, torch.bfloat16),    # the wgmma kernel's first row count, K % 128 != 0
    (300, 256, 90, torch.bfloat16),      # N % 4 != 0: cp.async words, a ragged tile
    (257, 128, 136, torch.float32),      # two 256-row tiles, the second of one row
    (5667, 4160, 4100, torch.bfloat16),  # phase 14's prefill rows, ragged
])
def test_int8_matmul_w8a16_kernel(dev, m, k, n, dtype):
    """K2's W8A16 branch: the plain version (the JAX CPU path) within 1e-3
    on bf16 x; on f32 x, which the kernels round to bf16 first (the TPU
    branch's rule), within 1e-5 of the plain version on the rounded x (f32
    sums in another order) and 5e-3 of it on the f32 x (the rounding)."""
    g = torch.Generator(device=dev).manual_seed(15)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    x[0] = 0
    w_q, scale = Q.quantize_weights(torch.randn(k, n, generator=g, device=dev) * 0.02)
    w_p = Q.pack_int8_rows(w_q)
    before, before8 = Q.int8_matmul_packed.a16_launches, Q.int8_matmul_packed.launches
    out = Q.int8_matmul_packed(x, w_p, scale, int8_mxu=False)
    torch.cuda.synchronize()
    assert Q.int8_matmul_packed.a16_launches == before + 1
    assert Q.int8_matmul_packed.launches == before8
    assert out.dtype == dtype and out.shape == (m, n)
    assert not out[0].any()
    ref = Q.int8_matmul_packed_plain(x, w_p, scale, int8_mxu=False)
    if dtype == torch.bfloat16:
        assert rel_l2(out, ref) <= 1e-3
    else:
        rounded = Q.int8_matmul_packed_plain(x.to(torch.bfloat16).float(), w_p, scale,
                                             int8_mxu=False)
        assert rel_l2(out, rounded) <= 1e-5
        assert rel_l2(out, ref) <= 5e-3


def test_int8_matmul_w8a16_refuses_k_off_64(dev):
    x = torch.ones(20, 4100, device=dev, dtype=torch.bfloat16)
    w_p = torch.zeros(1025, 64, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError):
        Q.int8_matmul_packed(x, w_p, torch.ones(64, device=dev), int8_mxu=False)


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


# (B, H, T, D, each row's valid [lo, hi), scale and q dtypes)
DECODE_EDGES = {
    "eight_ranks_one_valid": (1, 32, 1024, 128, [(500, 501)], torch.float32, torch.bfloat16),
    "span_edges_d64": (3, 4, 1000, 64, [(37, 1000), (999, 1000), (0, 0)], torch.bfloat16,
                       torch.float32),
    "d256": (2, 2, 300, 256, [(0, 300), (10, 150)], torch.bfloat16, torch.bfloat16),
    "d32": (2, 3, 130, 32, [(0, 1), (64, 130)], torch.float32, torch.bfloat16),
    "d16": (2, 3, 130, 16, [(5, 6), (0, 0)], torch.bfloat16, torch.float32),
    "t1": (2, 2, 1, 128, [(0, 1), (0, 0)], torch.float32, torch.bfloat16),
    "holes": (2, 4, 700, 128, [(0, 700), (100, 600)], torch.bfloat16, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(DECODE_EDGES))
def test_decode_attention_cluster_edges(dev, case):
    """K7 and K4 where the cluster's ranks and the skipped positions have
    edges: 8 ranks of 128 positions, T off a rank's span, one valid position
    (first, last, alone in T = 1), rows with no valid position (equal
    weights over all of T, as the plain version's softmax of a constant
    row), masks with holes inside the valid range (every other position in
    row 0 of "holes", a 200-position gap in row 1), head dims 16 to 256.
    K7 within K7_BOUND, K4 (the same cache as layer 1 of a stack of two)
    within 1e-2 (its plain version rounds the weights to bf16)."""
    b, h, t, d, rows, sdt, qdt = DECODE_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(16)
    k8, v8 = (torch.randint(-127, 128, (2, b, h, t, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(2, b, h, t, generator=g, device=dev) * 0.02 + 0.005).to(sdt)
              for _ in range(2))
    mask = torch.zeros(b, t, dtype=torch.int32, device=dev)
    for r, (lo, hi) in enumerate(rows):
        mask[r, lo:hi] = 1
    if case == "holes":
        mask[0, 1::2] = 0
        mask[1, 200:400] = 0
    q = randn(g, b, h, 1, d, dev=dev, dtype=qdt)
    layer = (q, k8[1], v8[1], ks[1], vs[1], mask)
    out = A.decode_attention_packed(*layer)
    ref = A.decode_attention_packed_plain(*layer)
    torch.cuda.synchronize()
    assert out.shape == (b, h, 1, d) and out.dtype == qdt
    assert rel_l2(out, ref) <= K7_BOUND
    qb = q.to(torch.bfloat16)
    stack = (qb, k8, v8, ks.to(torch.bfloat16), vs.to(torch.bfloat16), mask, 1)
    out4 = A.decode_attention_packed_stack(*stack)
    ref4 = A.decode_attention_packed_stack_plain(*stack)
    torch.cuda.synchronize()
    assert rel_l2(out4, ref4) <= 1e-2


def test_decode_attention_refuses_head_dim_off_the_kernel(dev):
    q = torch.zeros(1, 2, 1, 48, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 8, 48, device=dev, dtype=torch.int8)
    sc = torch.ones(1, 2, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        A.decode_attention_packed(q, kv, kv, sc, sc, torch.ones(1, 8, device=dev))


@pytest.mark.parametrize("m,k,n,dtype", [
    (16, 4096, 11264, torch.bfloat16),  # one layer of bench_stream
    (1, 4096, 11008, torch.bfloat16),   # skinny kernel at one row, bench_w8a16's width
    (3, 192, 70, torch.bfloat16),       # skinny kernel, ragged N, N % 4 != 0: bytes by warp 0
    (16, 640, 130, torch.float32),      # N % 4 != 0 with K split 5 ways
    (16, 1024, 4100, torch.float32),    # N % 16 != 0: the weight by cp.async, a ragged strip
    (5, 64, 300, torch.bfloat16),       # K 64: one k tile, half of it past K; cp.async
    (7, 2048, 4112, torch.bfloat16),    # the weight by TMA, the last strip ragged
    (16, 4160, 8192, torch.bfloat16),   # 33 k tiles (the last half past K) split 4 ways
    (100, 256, 90, torch.bfloat16),     # tiled kernel, ragged M and N, N % 4 != 0
    (70, 128, 64, torch.float32),
])
def test_int8_matmul_unpacked_kernel(dev, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(12)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    x[0] = 0  # a zero row takes row scale 1
    w_q, scale = Q.quantize_weights(torch.randn(k, n, generator=g, device=dev) * 0.05)
    before = Q.int8_matmul.launches
    out = Q.int8_matmul(x, w_q, scale)
    ref = Q.int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert Q.int8_matmul.launches == before + 1
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.float().cpu().numpy(), ref.float().cpu().numpy())
    with pytest.raises(ValueError):  # K % 64 != 0
        Q.int8_matmul(torch.zeros(m, 100, dtype=dtype, device=dev),
                      torch.zeros(100, n, dtype=torch.int8, device=dev), scale)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype,t", [(torch.bfloat16, 1024), (torch.float32, 200)])
def test_decode_attention_layer_kernel(dev, scale_dtype, q_dtype, t):
    g = torch.Generator(device=dev).manual_seed(13)
    B, H, D = 3, 4, 128
    k8, v8 = (torch.randint(-127, 128, (B, H, t, D), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(B, H, t, generator=g, device=dev) * 0.02 + 0.005).to(scale_dtype)
              for _ in range(2))
    mask = torch.ones(B, t, dtype=torch.int32, device=dev)
    mask[1, : t // 2] = 0
    mask[2] = 0  # no valid slot: uniform weights, as in the plain version
    q = randn(g, B, H, 1, D, dev=dev, dtype=q_dtype)
    before = A.decode_attention_packed.launches
    out = A.decode_attention_packed(q, k8, v8, ks, vs, mask)
    ref = A.decode_attention_packed_plain(q, k8, v8, ks, vs, mask)
    torch.cuda.synchronize()
    assert A.decode_attention_packed.launches == before + 1
    assert out.shape == (B, H, 1, D) and out.dtype == q_dtype
    assert rel_l2(out, ref) <= K7_BOUND
    if scale_dtype == torch.float32:  # bf16 copies of the scales miss the bound
        cast = A.decode_attention_packed(q, k8, v8, ks.to(torch.bfloat16),
                                         vs.to(torch.bfloat16), mask)
        assert rel_l2(cast, ref) > K7_BOUND
    with pytest.raises(TypeError):
        A.decode_attention_packed(q, k8, v8, ks, vs.float() if scale_dtype != torch.float32
                                  else vs.to(torch.bfloat16), mask)


@pytest.mark.parametrize("kernel", ["w8a16", "w8p", "w4p"])
@pytest.mark.parametrize("m,k,n,dtype", [
    (16, 4096, 11008, torch.bfloat16),  # the benches' shapes
    (5, 256, 70, torch.bfloat16),       # ragged N, N % 4 != 0
    (40, 512, 64, torch.float32),       # three 16-row m-tiles, f32 x
])
def test_stream_matmul_kernels(dev, kernel, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(14)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    if kernel == "w8a16":
        w_q, scale = Q.quantize_weights(w)
        fn, plain, counted = W.w8a16_matmul, W.w8a16_matmul_plain, W.w8a16_matmul
        args = (x, w_q, scale)
    else:
        parts, bits = (4, 8) if kernel == "w8p" else (8, 4)
        if bits == 8:
            w_q, scale = Q.quantize_weights(w)
            w_p = P.pack4_int8(w_q)
        else:
            w_q4, s4 = P.quantize_int4_channels(w[None])
            w_p, scale = P.pack8_int4(w_q4[0]), s4[0]
        fn = functools.partial(P.wp_matmul, parts=parts, bits=bits)
        plain = functools.partial(P.wp_matmul_plain, parts=parts, bits=bits)
        counted, args = P.wp_matmul, (x, w_p, scale)
    before = counted.launches
    out = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    assert rel_l2(out, ref) <= (1e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("m,k,n,group,dtype", [
    (1, 256, 40, 256, torch.bfloat16),       # decode kernels, one group
    (13, 1024, 72, 256, torch.bfloat16),     # decode kernels, ragged N, 4 groups
    (16, 1024, 70, 256, torch.float32),      # decode kernels' last row count, N % 4 != 0
    (17, 512, 130, 256, torch.bfloat16),     # wgmma kernel: one row past the decode kernels,
                                             # N % 128 != 0 and N % 4 != 0 (cp.async words)
    (64, 2048, 384, 1024, torch.bfloat16),   # wgmma kernel, 2 groups of 1024
    (100, 2048, 90, 1024, torch.bfloat16),   # ragged M and N, N % 4 != 0
    (300, 1024, 256, 1024, torch.float32),   # ragged M over 3 row tiles, one group, f32 x
    (300, 2048, 4100, 256, torch.bfloat16),  # 8 groups, N off the 128-column tiles
    (70, 512, 64, 256, torch.float32),       # f32 activations
])
def test_int4_matmul_kernel(dev, m, k, n, group, dtype):
    """Both branches: W4A8 bit for bit; W4A16 within rel_l2 1e-3 of the
    plain version (the JAX CPU path: f32 sums in another order, one bf16
    rounding) for bf16 x, 5e-3 for f32 x (the kernel rounds x to bf16, as
    the TPU kernel does; measured 1.7e-3 on the H100)."""
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
    before16 = Q.int4_matmul_packed.a16_launches
    out16 = Q.int4_matmul_packed(x, w_p, scale, group=group, int8_mxu=False)
    ref16 = Q.int4_matmul_packed_plain(x, w_p, scale, group=group, int8_mxu=False)
    torch.cuda.synchronize()
    assert Q.int4_matmul_packed.a16_launches == before16 + 1
    assert Q.int4_matmul_packed.launches == before + 1
    assert out16.dtype == dtype and out16.shape == (m, n)
    assert not out16[0].any()
    assert rel_l2(out16, ref16) <= (1e-3 if dtype == torch.bfloat16 else 5e-3)


WIDTHS = [(4, 4), (8, 8), (4, 8), (8, 4)]


def _kv_stacks(g, dev, kvbits: int, *lead):
    """Random K/V stacks (*lead, 128) int8 or (*lead, 64) uint8 nibble pairs,
    with bf16 scales (*lead)."""
    if kvbits == 8:
        stacks = {name: torch.randint(-127, 128, (*lead, 128), generator=g, device=dev,
                                      dtype=torch.int32).to(torch.int8) for name in ("k", "v")}
    else:
        stacks = {name: torch.randint(0, 256, (*lead, 64), generator=g, device=dev,
                                      dtype=torch.int32).to(torch.uint8) for name in ("k", "v")}
    for name in ("k_s", "v_s"):
        stacks[name] = (torch.rand(lead, generator=g, device=dev) * 0.05 + 0.01
                        ).to(torch.bfloat16)
    return stacks


def _mega_inputs(dev, batch: int, t_cap: int = 64, n_layers: int = 2, wbits: int = 4,
                 kvbits: int = 4):
    """Random int4 (group 256) or int8 weights (dim 512, 4 heads of 128, ffn
    1024, K-chunk 256) and an int4 or int8 cache whose rows hold different
    numbers of positions."""
    g = torch.Generator(device=dev).manual_seed(5)
    d, f, h, grp = 512, 1024, 4, 256
    shapes = ((d, 3 * d), (d, d), (d, 2 * f), (f, d))
    layers = [[] for _ in range(8)]
    for _ in range(n_layers):
        for i, (k, n) in enumerate(shapes):
            w = torch.randn(k, n, generator=g, device=dev) * 0.02
            if wbits == 4:
                w_q, sc = Q.quantize_weights_int4(w, grp)
                layers[2 * i].append(Q.pack_int4_rows(w_q, grp))
            else:
                w_q, sc = Q.quantize_weights(w)
                layers[2 * i].append(Q.pack_int8_rows(w_q))
            layers[2 * i + 1].append(sc)
    weights = M.MegaWeights(layers, 1 + 0.1 * torch.randn(n_layers, 2, d, generator=g,
                                                          device=dev), grp, f, h, wbits)
    cache = _kv_stacks(g, dev, kvbits, n_layers, batch, h, t_cap)
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


def _counter(widths, pf: bool) -> str:
    """The launch counter of K5's variant at these widths."""
    name = "pf_launches" if pf else "launches"
    return name if widths == (4, 4) else "int8_" + name


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: f"w{w[0]}kv{w[1]}")
@pytest.mark.parametrize("case", ["two_layers", "fully_masked_row", "bucket_after_compaction"])
def test_mega_decode_kernel(dev, case, widths):
    x, weights, cache, cos, sin = _mega_inputs(dev, 16 if case.startswith("bucket") else 8,
                                               wbits=widths[0], kvbits=widths[1])
    if case == "fully_masked_row":
        cache["kv_mask"][3] = 0  # row 3 attends to its current token alone
    if case == "bucket_after_compaction":
        lanes = torch.tensor([0, 2, 5, 9, 12, 15, 15, 15], device=dev)
        cache = M.compact_cache(cache, lanes)
        x, cos, sin = x[lanes].contiguous(), cos[lanes], sin[lanes]
    counter = _counter(widths, pf=False)
    before = getattr(M.mega_decode_layers, counter)
    got = M.mega_decode_layers(x, weights, cache, cos, sin)
    ref = M.mega_decode_layers_plain(x, weights, cache, cos, sin)
    torch.cuda.synchronize()
    assert getattr(M.mega_decode_layers, counter) == before + 1
    assert got[0].shape == x.shape and got[1].shape == (2, x.shape[0], 4, 128)
    _assert_mega_close(got, ref)  # both layers, the last one included


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: f"w{w[0]}kv{w[1]}")
@pytest.mark.parametrize("batch,c,wp,amask", [
    (8, 32, 0, "first_3_masked"),       # an empty working cache
    (8, 128, 128, "first_3_masked"),    # a mid-cache chunk
    (16, 32, 224, "first_3_masked"),    # the last chunk (wp = T2 - c)
    (16, 128, 0, "one_column"),         # rows before it see no key at all
    (8, 32, 128, "one_column"),
])
def test_mega_decode_kernel_pf_rows(dev, batch, c, wp, amask, widths):
    """K5-pf against its plain version, the decode rows bit-identical to the
    same call without the chunk."""
    x, weights, cache, cos, sin = _mega_inputs(dev, batch, wbits=widths[0], kvbits=widths[1])
    g = torch.Generator(device=dev).manual_seed(6)
    t2 = 256
    work = _kv_stacks(g, dev, widths[1], 2, 4, t2)
    am = torch.ones(c, dtype=torch.int32, device=dev)
    if amask == "one_column":
        am.zero_()
        am[c // 2] = 1
    else:
        am[:3] = 0
    pcos, psin = M.rope_tables(torch.arange(wp, wp + c, device=dev), 128, 10000.0)
    pf = dict(x=randn(g, c, 512, dev=dev), cos=pcos, sin=psin, amask=am,
              mask=(torch.arange(t2, device=dev) < wp).to(torch.int32), **work)
    base = M.mega_decode_layers(x, weights, cache, cos, sin)
    counter = _counter(widths, pf=True)
    before = getattr(M.mega_decode_layers, counter)
    got = M.mega_decode_layers(x, weights, cache, cos, sin, pf=pf)
    ref = M.mega_decode_layers_plain(x, weights, cache, cos, sin, pf=pf)
    torch.cuda.synchronize()
    assert getattr(M.mega_decode_layers, counter) == before + 1
    for name, a, b in zip(("x", "knew", "knew_s", "vnew", "vnew_s"), got[:5], base):
        assert torch.equal(a, b), name
    _assert_mega_close(got, ref)
    keys = ("x", "knew", "knew_s", "vnew", "vnew_s")
    assert got[5]["x"].shape == (c, 512) and got[5]["knew"].shape == (2, c, 4, 128)
    _assert_mega_close([got[5][k] for k in keys], [ref[5][k] for k in keys])


def test_mega_decode_kernel_pf_refuses_bad_operands(dev):
    x, weights, cache, cos, sin = _mega_inputs(dev, 8)
    pf = dict(x=randn(torch.Generator(device=dev), 32, 512, dev=dev),
              cos=cos[:1].expand(32, -1).contiguous(), sin=sin[:1].expand(32, -1).contiguous(),
              amask=torch.ones(32, dtype=torch.int32, device=dev),
              mask=torch.zeros(256, dtype=torch.int32, device=dev),
              k=torch.zeros(2, 4, 256, 64, dtype=torch.uint8, device=dev),
              k_s=torch.ones(2, 4, 256, dtype=torch.bfloat16, device=dev),
              v=torch.zeros(2, 4, 256, 64, dtype=torch.uint8, device=dev),
              v_s=torch.ones(2, 4, 256, dtype=torch.float32, device=dev))
    with pytest.raises(ValueError, match="v_s"):
        M.mega_decode_layers(x, weights, cache, cos, sin, pf=pf)


def test_mega_decode_kernel_refuses_cache_of_another_width(dev):
    """A cache's dtype must match the width its last axis gives: int8 for
    Dh values, uint8 nibble pairs for Dh/2; the working cache's must match
    the decode cache's."""
    x, weights, cache, cos, sin = _mega_inputs(dev, 8, wbits=8, kvbits=8)
    as_uint8 = dict(cache, k=cache["k"].view(torch.uint8), v=cache["v"].view(torch.uint8))
    with pytest.raises(ValueError, match="int8 cache"):
        M.mega_decode_layers(x, weights, as_uint8, cos, sin)
    _, _, cache4, _, _ = _mega_inputs(dev, 8, kvbits=4)
    as_int8 = dict(cache4, k=cache4["k"].view(torch.int8), v=cache4["v"].view(torch.int8))
    with pytest.raises(ValueError, match="int4 cache"):
        M.mega_decode_layers(x, weights, as_int8, cos, sin)
    pf = dict(x=randn(torch.Generator(device=dev), 32, 512, dev=dev),
              cos=cos[:1].expand(32, -1).contiguous(), sin=sin[:1].expand(32, -1).contiguous(),
              amask=torch.ones(32, dtype=torch.int32, device=dev),
              mask=torch.zeros(128, dtype=torch.int32, device=dev),
              **_kv_stacks(torch.Generator(device=dev), dev, 4, 2, 4, 128))
    with pytest.raises(ValueError, match="pf"):
        M.mega_decode_layers(x, weights, cache, cos, sin, pf=pf)


# K5's weight core alone at the four 7B projections: (K, N, epilogue, chunk)
CORE_7B = {"qkv": (4096, 12288, "store", 1024), "o": (4096, 4096, "resid", 128),
           "gate_up": (4096, 22528, "swiglu", 1024), "down": (11264, 4096, "resid", 1024)}


def _core_operands(g, dev, wbits, rows, k, n, chunk, group):
    """Seeded activations quantized per (row, chunk) as K5's kernels do,
    and an int4 (``group``-row scale groups) or int8 weight."""
    w = torch.randn(k, n, generator=g, device=dev) * 0.02
    if wbits == 4:
        w_q, sc = Q.quantize_weights_int4(w, group)
        w_p = Q.pack_int4_rows(w_q, group)
    else:
        w_q, sc = Q.quantize_weights(w)
        w_p = Q.pack_int8_rows(w_q)
    x = torch.randn(rows, k // chunk, chunk, generator=g, device=dev)
    x[:, 0, 0] *= 40.0  # a large entry sets its chunk's scale
    q, rs = M._quant_rows_f32(x)
    return q.reshape(rows, k).to(torch.int8), rs[..., 0].contiguous(), w_p, sc


def _core_check(q, rs, w_p, sc, wbits, chunk, group, epi, resid=None, ranks=None):
    """mega_project bit for bit against its plain version; the launch counted."""
    before = M.mega_project.launches
    got = M.mega_project(q, rs, w_p, sc, wbits=wbits, chunk=chunk, group=group, epi=epi,
                         resid=resid, ranks=ranks)
    ref = M.mega_project_plain(q, rs, w_p, sc, wbits=wbits, chunk=chunk, group=group, epi=epi,
                               resid=resid)
    torch.cuda.synchronize()
    assert M.mega_project.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, ref), float((got - ref).abs().max())
    return got


@pytest.mark.parametrize("wbits", [4, 8])
@pytest.mark.parametrize("phase", list(CORE_7B))
@pytest.mark.parametrize("rows", [1, 8, 14, 16, 17, 136])
def test_mega_core_7b_projections(dev, wbits, phase, rows):
    """Each 7B projection of K5's weight core bit for bit against
    ``_w4a8_chunks`` / ``_w8a8_chunks`` and its epilogue: the gate_up
    product as a plain f32 store over all 2F columns, then with its SwiGLU
    epilogue; the o-projection with its per-head activation chunks."""
    k, n, epi, chunk = CORE_7B[phase]
    g = torch.Generator(device=dev).manual_seed(rows * 10 + wbits)
    q, rs, w_p, sc = _core_operands(g, dev, wbits, rows, k, n, chunk, 1024)
    resid = torch.randn(rows, n, generator=g, device=dev) if epi == "resid" else None
    if epi == "swiglu":
        _core_check(q, rs, w_p, sc, wbits, chunk, 1024, "store")
    _core_check(q, rs, w_p, sc, wbits, chunk, 1024, epi, resid)


@pytest.mark.parametrize("wbits,rows,k,n,chunk,group,epi", [
    (4, 9, 512, 4096 + 96, 256, 256, "store"),    # N not a multiple of the 64-column strip
    (4, 23, 768, 200, 256, 256, "swiglu"),        # F = 100: a gate box reaching into up
    (4, 40, 1024, 36, 128, 512, "resid"),         # chunks split a group, warps split units
    (4, 136, 1024, 100, 128, 512, "resid"),       # chunks split a group, one warp a row set
    (4, 3, 1536, 66, 512, 512, "resid"),          # N % 4 != 0 (cp.async words), 3 groups
    (4, 161, 512, 64, 256, 256, "store"),         # two slabs
    (8, 17, 384, 4100, 128, None, "store"),       # 3 chunks (odd), N % 64 != 0
    (8, 5, 640, 90, 128, None, "resid"),          # N % 4 != 0, 5 chunks
    (8, 200, 512, 130, 256, None, "swiglu"),      # two slabs, N % 4 != 0
    (8, 33, 1152, 4096, 384, None, "resid"),      # 3 chunks of 3 stages
])
def test_mega_core_ragged_edges(dev, wbits, rows, k, n, chunk, group, epi):
    g = torch.Generator(device=dev).manual_seed(rows + k)
    q, rs, w_p, sc = _core_operands(g, dev, wbits, rows, k, n, chunk, group)
    resid = torch.randn(rows, n, generator=g, device=dev) if epi == "resid" else None
    _core_check(q, rs, w_p, sc, wbits, chunk, group, epi, resid)


@pytest.mark.parametrize("wbits,rows,k,n,chunk,group,epi,ranks", [
    (4, 8, 4096, 4096, 128, 1024, "resid", 2),     # the 7B o-projection, 4 groups in 2 runs
    (4, 8, 4096, 4096, 128, 1024, "resid", 4),     # a group a rank
    (4, 8, 11264, 4096, 1024, 1024, "resid", 3),   # 7B down: 11 groups in 3 uneven runs
    (4, 17, 3072, 4098, 1024, 1024, "store", 3),   # N % 4 != 0 (cp.async words)
    (4, 8, 4096, 2048, 1024, 1024, "swiglu", 2),
    (8, 8, 4096, 4096, 128, None, "resid", 2),     # the 7B o-projection
    (8, 8, 11264, 4096, 1024, None, "resid", 3),   # 7B down
    (8, 24, 2048, 256, 256, None, "resid", 2),     # two row sets whose warps split units
    (8, 5, 640, 90, 128, None, "resid", 5),        # 5 units, one a rank
])
def test_mega_core_cluster_split(dev, wbits, rows, k, n, chunk, group, epi, ranks):
    """K split across a cluster of ``ranks`` blocks a strip, the ranks'
    chunk terms added by rank 0 in chunk order: bit for bit as one block."""
    g = torch.Generator(device=dev).manual_seed(rows + k + ranks)
    q, rs, w_p, sc = _core_operands(g, dev, wbits, rows, k, n, chunk, group)
    resid = torch.randn(rows, n, generator=g, device=dev) if epi == "resid" else None
    _core_check(q, rs, w_p, sc, wbits, chunk, group, epi, resid, ranks)


def test_mega_core_refuses(dev):
    """The wrapper raises for what the core does not take; the C entry point
    refuses a plan it cannot run."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, rs, w_p, sc = _core_operands(g, dev, 4, 8, 1024, 64, 128, 512)
    with pytest.raises(ValueError, match="residual"):  # chunk < group needs the residual
        M.mega_project(q, rs, w_p, sc, wbits=4, chunk=128, group=512, epi="store")
    with pytest.raises(ValueError, match="rs"):
        M.mega_project(q, rs[:, :4].contiguous(), w_p, sc, wbits=4, chunk=128, group=512,
                       epi="resid", resid=torch.zeros(8, 64, device=dev))
    out = torch.empty(8, 64, device=dev)
    p = _build.ptr
    good = M.core_plan(64, 1024, 128, 8, 4, "resid", 512).c_args
    for i, bad in ((0, 3), (3, 16), (4, 25), (1, 5), (2, 5), (5, 48), (6, 1024), (4, 3),
                   (7, 0), (7, 3), (7, 9)):
        plan = good[:i] + (bad,) + good[i + 1:]  # one field out of what the kernel takes
        err = _build.library().mmor_mega_project(
            p(q), p(rs), p(w_p), p(sc), p(out), p(out), 8, 1024, 64, 512, 128, 4, 1, *plan,
            _build.stream())
        assert err != 0, plan


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


K9_BOUND = 1e-3  # chip_smoke.py's


@pytest.mark.parametrize("b,dq,d,f,res_dtype", [
    (1, 256, 256, 512, torch.bfloat16),
    (14, 4096, 4096, 11008, torch.bfloat16),  # the 7B decode tail
    (20, 512, 256, 768, torch.float32),       # two 16-row m-tiles, f32 residual
    (70, 256, 512, 1024, torch.bfloat16),     # five 16-row m-tiles, h chunks over 2 rows
])
def test_fused_o_mlp_kernel(dev, b, dq, d, f, res_dtype):
    """K9 against its plain version, one cooperative launch a call, the same
    output bit for bit from two calls (every sum in a fixed order)."""
    from mmor_tpu_torch.tools.perf.bench_fused_mlp import tail_operands

    g = torch.Generator(device=dev).manual_seed(21)
    args = tail_operands(b, dq, d, f, dev, g, res_dtype)
    before = FM.fused_o_mlp.launches
    out = FM.fused_o_mlp(*args)
    again = FM.fused_o_mlp(*args)
    ref = FM.fused_o_mlp_plain(*args)
    torch.cuda.synchronize()
    assert FM.fused_o_mlp.launches == before + 2
    assert out.dtype == res_dtype and out.shape == (b, d)
    assert torch.equal(out, again)
    assert rel_l2(out, ref) <= K9_BOUND


def test_fused_o_mlp_kernel_refuses_bad_operands(dev):
    from mmor_tpu_torch.tools.perf.bench_fused_mlp import tail_operands

    g = torch.Generator(device=dev).manual_seed(22)
    for dq, d in ((264, 256), (256, 272)):  # Dq % 16 != 0, D % 32 != 0
        with pytest.raises(ValueError, match="Dq % 16, D % 32"):
            FM.fused_o_mlp(*tail_operands(4, dq, d, 512, dev, g))
    args = list(tail_operands(4, 256, 256, 512, dev, g))
    with pytest.raises(ValueError, match="phase_ns"):
        FM.fused_o_mlp(*args, phase_ns=torch.zeros(5, dtype=torch.int32, device=dev))
    args[4] = args[4].to(torch.bfloat16)  # a bf16 scale
    with pytest.raises(TypeError):
        FM.fused_o_mlp(*args)


def test_fused_o_mlp_kernel_phase_stamps(dev):
    """With ``phase_ns`` K9 records its clock at its start, barriers and end
    (in order) and gives the same output as without."""
    from mmor_tpu_torch.tools.perf.bench_fused_mlp import tail_operands

    args = tail_operands(14, 512, 512, 1024, dev, torch.Generator(device=dev).manual_seed(25))
    stamps = torch.full((5,), 7, dtype=torch.int64, device=dev)
    out = FM.fused_o_mlp(*args, phase_ns=stamps)
    torch.cuda.synchronize()
    assert torch.equal(out, FM.fused_o_mlp(*args))
    t = stamps.cpu()
    assert bool((t[1:] >= t[:-1]).all()) and int(t[0]) > 7
    phases = FM.phase_times_us(stamps)
    assert phases["launch"] == pytest.approx(sum(v for k, v in phases.items() if k != "launch"))


@pytest.mark.parametrize("mode", ["bf16", "mxu8"])
@pytest.mark.parametrize("m,k,n,dtype", [
    (16, 4096, 11264, torch.bfloat16),  # bench_bitcast's shape
    (5, 256, 70, torch.bfloat16),       # ragged N, N % 4 != 0
    (40, 512, 64, torch.float32),       # above one 16-row tile (mxu8: K2's wgmma kernel)
    (100, 4160, 4100, torch.bfloat16),  # the wgmma kernel at K % 128 != 0
])
def test_w8b_matmul_kernel(dev, mode, m, k, n, dtype):
    """K10c against its plain version: mxu8 bit for bit, bf16 within
    rel_l2 1e-3 (1e-5 in f32); each mode counts its own launches."""
    g = torch.Generator(device=dev).manual_seed(23)
    x = randn(g, m, k, dev=dev, dtype=dtype)
    w_q, scale = Q.quantize_weights(torch.randn(k, n, generator=g, device=dev) * 0.02)
    w_p = BC.pack_rows_int8(w_q)
    counter = "mxu8_launches" if mode == "mxu8" else "launches"
    before = getattr(BC.w8b_matmul, counter)
    out = BC.w8b_matmul(x, w_p, scale, mode=mode)
    ref = BC.w8b_matmul_plain(x, w_p, scale, mode=mode)
    torch.cuda.synchronize()
    assert getattr(BC.w8b_matmul, counter) == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    if mode == "mxu8":
        assert torch.equal(out, ref)
    else:
        assert rel_l2(out, ref) <= (1e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("hwc,n", [((92, 160, 32), 4096), ((5, 40, 8), 300)])
def test_dma_gather_kernel(dev, hwc, n):
    """K10d equals its plain version bit for bit, windows reaching outside
    the map (negative or too large y or x) included, which are zeros."""
    h, w, c = hwc
    g = torch.Generator(device=dev).manual_seed(24)
    f = randn(g, h, w, c, dev=dev)
    idx = torch.stack([torch.randint(0, h - 1, (n,), generator=g, device=dev),
                       torch.randint(0, w - 15, (n,), generator=g, device=dev)], 1)
    # y = -1, y + 2 > H, x8 = -8, x8 + 16 > W (outside); the last window of the
    # map, and one whose x rounds down to it (inside)
    idx[:6] = torch.tensor([[-1, 0], [h - 1, 0], [0, -3], [0, w - 8], [h - 2, w - 16],
                            [0, w - 9]], device=dev)
    idx = idx.to(torch.int32)
    before = DG.dma_gather.launches
    out = DG.dma_gather(idx, f)
    ref = DG.dma_gather_plain(idx, f)
    torch.cuda.synchronize()
    assert DG.dma_gather.launches == before + 1
    assert out.shape == (n, 2, 16, c)
    assert torch.equal(out, ref)
    assert not out[:4].any() and out[4:6].all()


def assert_one_bf16_step(out, ref):
    """Every output within one bf16 step, at the largest output, of its plain
    value (chip_smoke.py's rule): both round an f32 sum of the same exact
    products, summed in another order, once, so an output that cancels to
    near zero may sit a few of its own steps away."""
    o, r = out.double(), ref.double()
    step = torch.exp2(torch.floor(torch.log2(r.abs().max())) - 7)
    assert float((o - r).abs().max()) <= float(step)


@pytest.mark.parametrize("layout", ["stack", "dslice"])
@pytest.mark.parametrize("x8,m,k,n,ck", [
    (True, 24, 4096, 11264, 2048),   # bench_megakernel_probe's xread
    (True, 40, 512, 96, 256),        # two row groups, the second partly padding
    (False, 24, 4096, 11264, 2048),  # BM_MXU8=0: a 128 KB bf16 tile in shared memory
    (False, 5, 1024, 64, 512),       # bf16 mpad 16: half a row group
])
def test_xread_probe_kernel(dev, layout, x8, m, k, n, ck):
    """K10e x-read against its plain version: int8 x bit for bit, bf16 x
    within one bf16 step at the largest output; each x layout counts its
    own launches."""
    g = torch.Generator(device=dev).manual_seed(25)
    w_p = Q.pack_int8_rows(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                         dtype=torch.int8))
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.005
    x = randn(g, m, k, dev=dev)
    mpad = MP.xread_mpad(m, x8)
    xr = torch.zeros(mpad, k, dtype=torch.int8 if x8 else torch.bfloat16, device=dev)
    xr[:m] = torch.clamp(torch.round(x.float() * 4), -127, 127).to(torch.int8) if x8 else x
    xx = MP.tile_stack(xr, ck) if layout == "stack" else xr
    counter = "launches" if layout == "stack" else "dslice_launches"
    before = getattr(MP.xread_matmul, counter)
    out = MP.xread_matmul(xx, w_p, scale, ck=ck)
    ref = MP.xread_matmul_plain(xx, w_p, scale, ck=ck)
    torch.cuda.synchronize()
    assert getattr(MP.xread_matmul, counter) == before + 1
    assert out.shape == (mpad, n) and out.dtype == torch.bfloat16
    if x8:
        assert torch.equal(out, ref)
    else:
        assert_one_bf16_step(out, ref)


def test_xread_probe_kernel_refuses_a_tile_past_shared_memory(dev):
    """A staged bf16 K-tile of 32 x 4096 (256 KB) cannot fit a block."""
    x = torch.zeros(2, 32, 4096, dtype=torch.bfloat16, device=dev)
    w_p = torch.zeros(2048, 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        MP.xread_matmul(x, w_p, torch.ones(64, device=dev), ck=4096)


@pytest.mark.parametrize("shape", [(16, 256), (3, 8)])
def test_tiny_probe_kernel(dev, shape):
    """K10e's tiny kernel is an identity, bit for bit, as its plain version."""
    x = randn(torch.Generator(device=dev).manual_seed(26), *shape, dev=dev)
    out = MP.tiny(x)
    torch.cuda.synchronize()
    assert torch.equal(out, MP.tiny_plain(x)) and torch.equal(out, x)


@pytest.mark.parametrize("m,k,n,ck", [(24, 4096, 11264, 2048), (5, 512, 64, 256)])
def test_nibble_probe_kernel(dev, m, k, n, ck):
    """K10e nibble product against its plain version: one bf16 step at the
    largest output."""
    g = torch.Generator(device=dev).manual_seed(27)
    w_p = MP.pack_nibble_words(torch.randint(-8, 8, (k, n), generator=g, device=dev,
                                             dtype=torch.int8))
    scale = torch.rand(n, generator=g, device=dev) * 0.02 + 0.005
    xi = MP.deinterleave_chunks(randn(g, m, k, dev=dev), ck, MP.xread_mpad(m, False))
    before = MP.nibble_matmul.launches
    out = MP.nibble_matmul(xi, w_p, scale)
    ref = MP.nibble_matmul_plain(xi, w_p, scale)
    torch.cuda.synchronize()
    assert MP.nibble_matmul.launches == before + 1
    assert_one_bf16_step(out, ref)


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dyn"])
@pytest.mark.parametrize("b,hgn,heads,t", [(24, 2, 16, 1024), (3, 2, 2, 128), (1, 1, 1, 256)])
def test_rowrw_probe_kernel(dev, dyn, b, hgn, heads, t):
    """K10e row probe against its plain version: the full acc and the output
    rows within rel_l2 1e-6 (f32 sums in another order); in static mode row
    (0, 0) is the last program's and every other row zero."""
    g = torch.Generator(device=dev).manual_seed(28)
    q = randn(g, hgn, b, heads * 128, dev=dev)
    kp = torch.randint(-2 ** 31, 2 ** 31 - 1, (hgn * b, heads, 32, t), generator=g, device=dev,
                       dtype=torch.int32)
    before = MP.rowrw.launches
    out, acc = MP.rowrw(q, kp, dyn=dyn)
    ref_out, ref_acc = MP.rowrw_plain(q, kp, dyn=dyn)
    torch.cuda.synchronize()
    assert MP.rowrw.launches == before + 1
    assert rel_l2(acc, ref_acc) <= 1e-6 and rel_l2(out, ref_out) <= 1e-6
    rows = out.reshape(hgn * b, -1)
    if dyn:
        assert torch.equal(rows, acc[:, :1].expand_as(rows))
    else:
        assert bool((rows[0] == acc[-1, 0]).all()) and not rows[1:].any()


@pytest.mark.parametrize("tq,wh,ww,d", [
    (256, 32, 40, 32),  # probe_mosaic_reshape's shapes
    (40, 3, 7, 20),     # K 21: 4-byte copies of natural A
    (37, 4, 11, 11),    # K 44, which the 16 ranks do not divide; every copy 4 bytes
    (36, 5, 9, 12),     # K 45: 16-byte copies of S^T and B, 4-byte ones of natural A
    (64, 4, 10, 64),    # K 40: six ranks with no k; two channel tiles
])
def test_reshape_probe_kernels(dev, tq, wh, ww, d):
    """K10f's copies bit for bit, its three products within rel_l2 1e-6 (f32
    sums in another order), at probe_mosaic_reshape's shapes and ragged
    ones."""
    g = torch.Generator(device=dev).manual_seed(29)
    k = wh * ww
    s3 = torch.randn(tq, wh, ww, generator=g, device=dev)
    win = torch.randn(wh, ww, d, generator=g, device=dev)
    st = torch.randn(k, tq, generator=g, device=dev)
    copies, products = RP.reshape_copy.launches, RP.st_product.launches
    assert torch.equal(RP.reshape_copy(s3, (tq, k)), s3.reshape(tq, k))
    assert torch.equal(RP.reshape_copy(win, (k, d)), win.reshape(k, d))
    onehot = (wh - 1, ww - 2, 0.5)
    for mode, a, b in (("transposed", st, win.reshape(k, d)), ("contracted", s3, win),
                       ("onehot", None, win)):
        out = RP.st_product(a, b, mode=mode, tq=tq, onehot=onehot)
        ref = RP.st_product_plain(a, b, mode=mode, tq=tq, onehot=onehot)
        assert out.shape == (tq, d) and rel_l2(out, ref) <= 1e-6, mode
    torch.cuda.synchronize()
    assert RP.reshape_copy.launches == copies + 2 and RP.st_product.launches == products + 3
