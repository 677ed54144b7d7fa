"""The port's microbenchmark kernels (K7, K8, K10a-K10d) and their tools
(``mmor_tpu_torch/tools/perf``) against the JAX package, on the CPU (K10e
and K10f: ``tests/test_torch_megakernel_probe.py``; their benches' mains run
here with the others).

The same seeded numpy inputs go through the JAX side and the port's plain
versions (CPU tensors; the CUDA kernels are held to those on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``). On the JAX side
each TPU kernel body runs in Pallas interpret mode, inside a ``pallas_call``
built here around the module's own body (``quantized_matmul._kernel``,
``attention._packed_decode_kernel``, ``bench_w8a16._w8a16_kernel``,
``bench_packed.make_wp_kernel``), or through the JAX script's own wrapper
with its ``pl.pallas_call`` in interpret mode (``bench_bitcast.w8b_matmul``,
and ``bench_dma_gather.dma_gather`` with its ``N``, ``CHUNK`` and ``NSEM``
cut to 64, 32 and 4); K7 and K8 are also held to their JAX wrappers' CPU
paths.

Tolerances:
- K8 against JAX's row quantization, the interpret body and the row rescale:
  bit for bit (the same integer products, the same f32 epilogue order).
  Against JAX ``int8_matmul`` on the CPU, which takes f32 dequantized
  weights and unquantized x: rel_l2 <= 1.5e-2, the activation quantization's
  error (measured 6.9e-3 in f32 and 7.1e-3 in bf16 here).
- K7 against the interpret body: rel_l2 <= 1e-6 (f32 sums in another order;
  measured 1.3e-7 to 2.1e-7). Against JAX ``decode_attention_packed`` on the
  CPU, which keeps an f32 q where the TPU body (and the port) rounds q to
  bf16: rel_l2 <= 1e-2 (measured 1.3e-3).
- K10a and K10b against the interpret bodies: rel_l2 <= 1e-6 in f32 (f32
  sums in another order; measured 8e-9 to 5e-8); in bf16, every output
  within one bf16 step of its value (both round an f32 sum once).
- K10c against the interpret body: mxu8 bit for bit (K8's activation rule,
  the same integer products, the same epilogue order); bf16 as K10a.
- K10d against the interpret body, and its (2, 2, C) torch twin against
  ``xla_gather``: exact (copies).
- The slab-packed words, and ``bench_bitcast.pack_rows_int8``'s row words,
  equal JAX's exactly.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mmor_tpu.models.llama import quantize_kv
from mmor_tpu.ops import attention as jattn
from mmor_tpu.ops import quantized_matmul as jqmm
from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.ops import attention as tattn
from mmor_tpu_torch.ops import quantized_matmul as tqmm
from mmor_tpu_torch.tools.perf import (bench_bitcast, bench_decode_parts, bench_dma_gather,
                                       bench_fused_mlp, bench_megakernel_probe, bench_packed,
                                       bench_prefill_matmul, bench_stream, bench_w8a16,
                                       probe_mosaic_reshape)
from tools.perf import bench_bitcast as jbitcast
from tools.perf import bench_dma_gather as jdma
from tools.perf import bench_packed as jpacked
from tools.perf import bench_w8a16 as jw8a16
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

M, K = 16, 256
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def jnp_np(a) -> np.ndarray:
    a = jnp.asarray(a)
    return np.array(a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a)


def weights(n: int, seed: int = 0, m: int = M, k: int = K):
    """Seeded x (m, k) f32 and N(0, 0.02) weights, quantized by JAX:
    (x, w f32, w_q int8, scale f32) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), np.float32)
    w = (rng.standard_normal((k, n), np.float32) * 0.02).astype(np.float32)
    w_q, scale = jqmm.quantize_weights(jnp.asarray(w))
    return x, w, np.array(w_q), np.array(scale)


def matmul_interpret(kernel, xs, w, scale, *, block_m, block_k, block_n, acc_dtype):
    """A pallas_call in interpret mode around one of the (M, K) x (K, N)
    kernel bodies: ``xs`` the x operands (one, or K10b's slabs), ``w`` the
    (K_rows, N) weight, ``scale`` (1, N). Returns the (M, N) f32 output."""
    m, n, k_rows = xs[0].shape[0], w.shape[1], w.shape[0]
    grid = (m // block_m, n // block_n, k_rows // block_k)
    xspec = pl.BlockSpec((block_m, block_k), lambda i, j, kk: (i, kk))
    return pl.pallas_call(
        kernel(grid[2]),
        grid=grid,
        in_specs=[xspec] * len(xs) + [
            pl.BlockSpec((block_k, block_n), lambda i, j, kk: (kk, j)),
            pl.BlockSpec((1, block_n), lambda i, j, kk: (0, j))],
        out_specs=pl.BlockSpec((block_m, block_n), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((block_m, block_n), acc_dtype)],
        interpret=True,
    )(*xs, w, scale)


# ------------------------------------------------------------------ K8
def jax_w8a8(xj, w_q, scale):
    """JAX's W8A8 path on the TPU, its kernel body in interpret mode: the
    wrapper's row quantization (quantized_matmul.py:81-84), the operands
    zero-padded to (32, 128, 128) tiles (the int8 sublane tile is 32), the
    row rescale. Returns (out (M, N) as numpy f32, x_q, row_scale (M, 1))."""
    m, k = xj.shape
    n = w_q.shape[1]
    xf = xj.astype(jnp.float32)
    row_amax = jnp.max(jnp.abs(xf), axis=1, keepdims=True)
    row_scale = jnp.where(row_amax > 0, row_amax / 127.0, 1.0)
    x_q = jnp.clip(jnp.round(xf / row_scale), -127, 127).astype(jnp.int8)
    mp, kp, np_ = -(-m // 32) * 32, -(-k // 128) * 128, -(-n // 128) * 128
    acc = matmul_interpret(lambda n_k: functools.partial(jqmm._kernel, n_k=n_k),
                           [jnp.pad(x_q, ((0, mp - m), (0, kp - k)))],
                           jnp.pad(jnp.asarray(w_q), ((0, kp - k), (0, np_ - n))),
                           jnp.pad(jnp.asarray(scale), (0, np_ - n))[None, :], block_m=32,
                           block_k=128, block_n=128, acc_dtype=jnp.int32)
    return jnp_np((acc[:m, :n] * row_scale).astype(xj.dtype)), x_q, row_scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_matches_jax_kernel_body_bit_for_bit(dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, w_q, scale = weights(384)
    ref, x_q, row_scale = jax_w8a8(jnp.asarray(x).astype(jdt), w_q, scale)

    xt = torch.from_numpy(x).to(tdt)
    xq_t, rs_t = tqmm.quantize_rows_div(xt)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(x_q))
    np.testing.assert_array_equal(rs_t.numpy(), np.asarray(row_scale)[:, 0])
    got = tqmm.int8_matmul(xt, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (M, 384)
    np.testing.assert_array_equal(to_np(got), ref)


@pytest.mark.parametrize("m,k,n,dtype", [
    (16, 1024, 384, "bf16"),  # bench_stream's layer, K and N cut
    (1, 512, 344, "bf16"),    # one row
    (3, 192, 70, "bf16"),     # ragged N, N % 4 != 0
    (16, 640, 130, "f32"),    # N % 4 != 0, five 128-row k tiles
    (16, 512, 260, "f32"),    # N % 16 != 0
    (5, 64, 300, "bf16"),     # K 64: one k tile, half of it past K
    (7, 256, 400, "bf16"),    # the last 128-column strip ragged
    (16, 4160, 128, "bf16"),  # 33 k tiles, the last half past K
    (100, 256, 90, "bf16"),   # above 16 rows, ragged M and N
    (70, 128, 64, "f32"),
])
def test_int8_matmul_matches_jax_kernel_body_at_card_shapes(m, k, n, dtype):
    """K8's plain version, which the card tests hold its CUDA kernels to bit
    for bit, against the JAX kernel body at the shape classes those kernels
    branch on (tests/test_torch_kernels_cuda.py::test_int8_matmul_unpacked_kernel,
    K and N cut where the interpret grid would be long), a zero row among them."""
    jdt, tdt = DTYPES[dtype]
    x, _, w_q, scale = weights(n, seed=2, m=m, k=k)
    if m > 1:
        x[-1] = 0.0  # a zero row takes row scale 1
    ref, _, _ = jax_w8a8(jnp.asarray(x).astype(jdt), w_q, scale)
    got = tqmm.int8_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w_q),
                           torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_array_equal(to_np(got), ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_matches_jax_cpu_path(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, w_q, scale = weights(256, seed=1)
    w_qt, scale_t = tqmm.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(w_qt.numpy(), w_q)
    np.testing.assert_array_equal(scale_t.numpy(), scale)
    ref = jnp_np(jqmm.int8_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(w_q),
                                  jnp.asarray(scale)))
    got = tqmm.int8_matmul(torch.from_numpy(x).to(tdt), w_qt, scale_t)
    assert rel_l2(to_np(got), ref) <= 1.5e-2


# ------------------------------------------------------------------ K7
def left_padded_mask(b: int, t: int) -> np.ndarray:
    mask = np.ones((b, t), np.int32)
    mask[:, :4] = 0  # left padding, as tests/test_attention.py makes it
    mask[1, : t // 3] = 0
    return mask


def test_decode_attention_packed_matches_jax_cpu_path():
    rng = np.random.default_rng(2)
    b, h, t, d = 2, 3, 24, 16  # tests/test_attention.py:104's shapes
    q = rng.standard_normal((b, h, 1, d), np.float32)
    k = rng.standard_normal((b, h, t, d), np.float32)
    v = rng.standard_normal((b, h, t, d), np.float32)
    k_p, k_s = quantize_kv(jnp.asarray(k))
    v_p, v_s = quantize_kv(jnp.asarray(v))
    mask = left_padded_mask(b, t)
    ref = np.asarray(jattn.decode_attention_packed(jnp.asarray(q), k_p, v_p, k_s, v_s,
                                                   jnp.asarray(mask)))

    def cache(words):
        return tattn.unpack_kv_heads(torch.from_numpy(np.array(words)))

    def scales(s):
        return torch.from_numpy(jnp_np(s)).to(torch.bfloat16)

    got = tattn.decode_attention_packed(torch.from_numpy(q), cache(k_p), cache(v_p),
                                        scales(k_s), scales(v_s), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, d)
    assert rel_l2(got.numpy(), ref) <= 1e-2


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t", [24, 128])
def test_decode_attention_packed_matches_jax_kernel_body(scale_dtype, t):
    jdt, tdt = DTYPES[scale_dtype]
    rng = np.random.default_rng(3)
    b, h, d = 2, 3, 16
    q = rng.standard_normal((b, h, 1, d), np.float32)
    k8 = rng.integers(-127, 128, (b, h, t, d), dtype=np.int8)
    v8 = rng.integers(-127, 128, (b, h, t, d), dtype=np.int8)
    ks = rng.uniform(0.005, 0.02, (b, h, t)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, h, t)).astype(np.float32)
    mask = left_padded_mask(b, t)
    sm_scale = 1.0 / np.sqrt(d)

    bh = b * h
    k_words = jattn.pack_kv_heads(jnp.asarray(k8)).reshape(bh, d // 4, t)
    v_words = jattn.pack_kv_heads(jnp.asarray(v8)).reshape(bh, d // 4, t)
    row = pl.BlockSpec((1, 1, t), lambda i: (i, 0, 0))
    words = pl.BlockSpec((1, d // 4, t), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        functools.partial(jattn._packed_decode_kernel, sm_scale=sm_scale),
        grid=(bh,),
        in_specs=[pl.BlockSpec((1, 1, d), lambda i: (i, 0, 0)), words, words, row, row,
                  pl.BlockSpec((1, 1, t), lambda i: (i // h, 0, 0))],
        out_specs=pl.BlockSpec((1, d, 1), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, d, 1), jnp.float32),
        interpret=True,
    )(jnp.asarray(q).reshape(bh, 1, d).astype(jnp.bfloat16), k_words, v_words,
      jnp.asarray(ks).astype(jdt).reshape(bh, 1, t),
      jnp.asarray(vs).astype(jdt).reshape(bh, 1, t), jnp.asarray(mask).reshape(b, 1, t))
    ref = np.asarray(out).reshape(b, h, 1, d)

    got = tattn.decode_attention_packed(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(ks).to(tdt), torch.from_numpy(vs).to(tdt), torch.from_numpy(mask),
        sm_scale=sm_scale)
    assert rel_l2(got.numpy(), ref) <= 1e-6


# ------------------------------------------------------------ K10a, K10b
def assert_close(got: torch.Tensor, ref: np.ndarray, dtype: str) -> None:
    """f32: rel_l2 <= 1e-6; bf16: each output within one bf16 step."""
    if dtype == "f32":
        assert rel_l2(to_np(got), ref) <= 1e-6
        return
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(to_np(got) - ref) <= step)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w8a16_matmul_matches_jax_kernel_body(dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, w_q, scale = weights(384, seed=4)
    xj = jnp.asarray(x).astype(jdt)
    out = matmul_interpret(lambda n_k: functools.partial(jw8a16._w8a16_kernel, n_k=n_k),
                           [xj.astype(jnp.bfloat16)], jnp.asarray(w_q),
                           jnp.asarray(scale)[None, :], block_m=16, block_k=128,
                           block_n=128, acc_dtype=jnp.float32)
    ref = jnp_np(out.astype(jdt))
    got = bench_w8a16.w8a16_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w_q),
                                   torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (M, 384)
    assert_close(got, ref, dtype)


def int4_weights(n: int, seed: int):
    """int4 values in [-8, 7] and per-channel amax / 7 scales, as the TPU
    script quantizes one layer."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, n), np.float32) * 0.02
    amax = np.abs(w).max(axis=0)
    s4 = np.where(amax > 0, amax / np.float32(7.0), 1.0).astype(np.float32)
    return np.clip(np.round(w / s4), -8, 7).astype(np.int8), s4


def test_slab_packing_equals_jax():
    rng = np.random.default_rng(5)  # every field value, the sign bits included
    w_q = rng.integers(-128, 128, (K, 256), dtype=np.int8)
    w_q4 = rng.integers(-8, 8, (K, 256), dtype=np.int8)
    for jfn, tfn, wq, parts, bits in ((jpacked.pack4_int8, bench_packed.pack4_int8, w_q, 4, 8),
                                      (jpacked.pack8_int4, bench_packed.pack8_int4, w_q4, 8, 4)):
        ref = np.asarray(jfn(jnp.asarray(wq)))
        got = tfn(torch.from_numpy(wq))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(bench_packed.unpack_slabs(got, parts, bits).numpy(), wq)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("parts,bits", [(4, 8), (8, 4)])
def test_wp_matmul_matches_jax_kernel_body(parts, bits, dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, w_q, scale = weights(256, seed=6)
    if bits == 4:
        w_q, scale = int4_weights(256, seed=6)
    w_p = np.array(jpacked.pack4_int8(jnp.asarray(w_q)) if bits == 8
                     else jpacked.pack8_int4(jnp.asarray(w_q)))
    kp = K // parts
    xj = jnp.asarray(x).astype(jdt)
    xs = [xj[:, i * kp:(i + 1) * kp].astype(jnp.bfloat16) for i in range(parts)]
    out = matmul_interpret(lambda n_k: jpacked.make_wp_kernel(n_k, parts, bits), xs,
                           jnp.asarray(w_p), jnp.asarray(scale)[None, :], block_m=16,
                           block_k=kp // 2, block_n=128, acc_dtype=jnp.float32)
    ref = jnp_np(out.astype(jdt))
    got = bench_packed.wp_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w_p),
                                 torch.from_numpy(scale), parts=parts, bits=bits)
    assert got.dtype == tdt and got.shape == (M, 256)
    assert_close(got, ref, dtype)


# ------------------------------------------------------------ K10c, K10d
def interpret_pl() -> types.SimpleNamespace:
    """``pallas`` as a JAX script sees it, with ``pallas_call`` in interpret
    mode."""
    view = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    view.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return view


def test_row_packing_equals_jax():
    w_q = np.random.default_rng(7).integers(-128, 128, (K, 256), dtype=np.int8)
    got = bench_bitcast.pack_rows_int8(torch.from_numpy(w_q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitcast.pack_rows_int8(
        jnp.asarray(w_q))))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["bf16", "mxu8"])
def test_w8b_matmul_matches_jax_kernel_body(monkeypatch, mode, dtype):
    jdt, tdt = DTYPES[dtype]
    monkeypatch.setattr(jbitcast, "pl", interpret_pl())
    x, _, w_q, scale = weights(384, seed=8)
    w_p = np.array(jbitcast.pack_rows_int8(jnp.asarray(w_q)))
    ref = jnp_np(jbitcast.w8b_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(w_p),
                                     jnp.asarray(scale), mode=mode))
    got = bench_bitcast.w8b_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w_p),
                                   torch.from_numpy(scale), mode=mode)
    assert got.dtype == tdt and got.shape == (M, 384)
    if mode == "mxu8":
        np.testing.assert_array_equal(to_np(got), ref)
    else:
        assert_close(got, ref, dtype)


def gather_inputs(n: int, seed: int):
    """A bf16-valued (H, W, C) map as f32 numpy and (n, 2) int32 pairs in the
    JAX script's ranges."""
    rng = np.random.default_rng(seed)
    f = jnp_np(jnp.asarray(rng.standard_normal((jdma.H, jdma.W, jdma.C), np.float32)
                           ).astype(jnp.bfloat16))
    idx = np.stack([rng.integers(0, jdma.H - 1, n), rng.integers(0, jdma.W - 17, n)], 1)
    return idx.astype(np.int32), f


def test_dma_gather_matches_jax_kernel(monkeypatch):
    for name, value in (("N", 64), ("CHUNK", 32), ("NSEM", 4)):
        monkeypatch.setattr(jdma, name, value)
    monkeypatch.setattr(jdma, "pl", interpret_pl())
    idx, f = gather_inputs(64, seed=9)
    ref = jnp_np(jdma.dma_gather.__wrapped__(jnp.asarray(idx),
                                             jnp.asarray(f).astype(jnp.bfloat16)))
    got = bench_dma_gather.dma_gather(torch.from_numpy(idx),
                                      torch.from_numpy(f).to(torch.bfloat16))
    assert got.shape == (64, 2, 16, jdma.C) and got.dtype == torch.bfloat16
    assert np.abs(ref).min(axis=(1, 2, 3)).max() > 0  # the DMAs filled every window
    np.testing.assert_array_equal(to_np(got), ref)


def test_torch_corners_match_xla_gather():
    idx, f = gather_inputs(200, seed=10)
    ref = jnp_np(jdma.xla_gather(jnp.asarray(idx), jnp.asarray(f).astype(jnp.bfloat16)))
    got = bench_dma_gather.torch_corners(torch.from_numpy(idx).long(),
                                         torch.from_numpy(f).to(torch.bfloat16))
    np.testing.assert_array_equal(to_np(got), ref)


# --------------------------------------------------------------- benches
TINY = dict(m=M, k=K, layers=2, repeats=1)
BENCHES = {
    "bench_stream": (lambda: bench_stream.main("cpu", n=256, **TINY),
                     ("torch_bf16", "w8a8", "w8a16", "w8p")),
    "bench_w8a16": (lambda: bench_w8a16.main("cpu", n=384, **TINY),
                    ("torch_bf16", "w8a8", "w8a16", "torch_mixed")),
    "bench_packed": (lambda: bench_packed.main("cpu", n=256, **TINY),
                     ("w8p", "w4p", "torch_bf16")),
    "decode_parts_weights": (
        lambda: bench_decode_parts.main("cpu", part="weights", batch=2, t=24, repeats=1,
                                        cfg=LlamaConfig.tiny()),
        ("weights only (packed)",)),
    "decode_parts_attn": (
        lambda: bench_decode_parts.main("cpu", part="attn", batch=2, t=24, repeats=1,
                                        cfg=LlamaConfig.tiny()),
        ("attention only (2 layers)",)),
    "bench_bitcast": (lambda: bench_bitcast.main("cpu", n=256, **TINY),
                      ("torch_bf16", "w8b_bf16", "w8b_mxu8")),
    "bench_dma_gather": (lambda: bench_dma_gather.main("cpu", n=64, repeats=1),
                         ("torch_corners", "torch_windows", "window_gather")),
    "bench_fused_mlp": (
        lambda: bench_fused_mlp.main("cpu", batches=(3, 17), cfg=LlamaConfig.tiny(), repeats=1),
        ("k9_fused B=3", "k2_chain B=3", "k10c_chain B=3", "torch_bf16 B=17")),
    **{f"bench_megakernel_probe:{part}": (
        lambda part=part: bench_megakernel_probe.main(
            "cpu", part=part, m=5, k=512, n=64, ck=256, repeats=1, rowrw_shape=(3, 2, 2, 128)),
        lines) for part, lines in (
            ("xread", ("a_k2", "b_stack", "c_dslice")),
            ("overhead", ("tiny8", "tiny32", "eager32", "graph32")),
            ("nibble", ("nibble_w4a16", "k2_w8a16", "c_dslice_bf16")),
            ("rowrw", ("rowrw_static", "rowrw_dyn")))},
    "probe_mosaic_reshape": (lambda: probe_mosaic_reshape.main("cpu", repeats=1),
                             ("a.", "b.", "c.", "d.", "e.")),
    "bench_prefill_matmul": (
        lambda: bench_prefill_matmul.main("cpu", m=20, k=512, n=128, group=256, repeats=1),
        ("torch_bf16", "k2_w8a8", "k2_w8a16", "k3_w4a8", "k3_w4a16", "torch_int8")),
}


@pytest.mark.parametrize("bench", list(BENCHES))
def test_bench_main_runs_on_cpu(bench, capsys):
    """Each bench's main at a tiny size on the CPU: its spot checks pass and
    it prints its named lines, untimed."""
    main, lines = BENCHES[bench]
    result = main()
    out = capsys.readouterr().out
    assert set(result["ms"].values()) == {None}
    assert all(err <= bench_w8a16.SPOT_BOUND * 2 for err in result["spot"].values())
    for name in lines:
        assert f"{name} " in out and "not measured (cpu" in out, (name, out)


def test_benches_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (bench_stream.main, bench_bitcast.main, bench_dma_gather.main,
                 bench_fused_mlp.main, bench_megakernel_probe.main, probe_mosaic_reshape.main,
                 bench_prefill_matmul.main):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            main()
