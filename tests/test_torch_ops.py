"""Parity of the PyTorch port's ops (mmor_tpu_torch.ops) with the JAX package.

Same seeded numpy inputs go through the JAX function (on the CPU it takes
its plain XLA path) and the port's plain path (a CPU tensor). The CUDA
kernels themselves are checked against these plain versions on the card by
``chip_smoke.py``.

Tolerances: f32 ops rel_l2 <= 1e-5 (summation order differs between XLA and
PyTorch); integer formats bit-exact; the bf16 resize within two bf16 ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu.models import llama as jllama
from mmor_tpu.ops import attention as jattn
from mmor_tpu.ops import image_preproc as jpre
from mmor_tpu.ops import quantized_matmul as jqmm
from mmor_tpu.ops import serialization as jser
from mmor_tpu_torch.models import llama as tllama
from mmor_tpu_torch.ops import attention as tattn
from mmor_tpu_torch.ops import image_preproc as tpre
from mmor_tpu_torch.ops import quantized_matmul as tqmm
from mmor_tpu_torch.ops import serialization as tser
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

F32_TOL = 1e-5


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("causal,segments,sq,sk,head_dim", [
    (True, False, 24, 24, 16),
    (False, True, 24, 24, 32),
    (True, True, 24, 24, 16),
    (False, False, 8, 24, 32),   # Sq != Sk
    (True, False, 8, 24, 16),    # causal offset Sk - Sq
])
def test_flash_attention_matches_jax(causal, segments, sq, sk, head_dim):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 3, sq, head_dim), np.float32)
    k = rng.standard_normal((2, 3, sk, head_dim), np.float32)
    v = rng.standard_normal((2, 3, sk, head_dim), np.float32)
    kw = {}
    if segments:
        seg = np.ones((2, sq), np.int32)
        seg[0, :5] = 0  # left padding
        seg[1, 10:] = 2  # a second packed sequence
        kw["segment_ids"] = seg
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal,
                                **{n: jnp.asarray(a) for n, a in kw.items()})
    ref_mha = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal,
                                  **{n: jnp.asarray(a) for n, a in kw.items()})
    tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal, **tkw)
    out_mha = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal, **tkw)
    assert out.shape == (2, 3, sq, head_dim)
    assert rel_l2(out, ref) <= F32_TOL
    assert rel_l2(out_mha, ref_mha) <= F32_TOL


# ------------------------------------------------------------------ K2
def test_weight_format_bit_exact():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 48), np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero channel takes scale 1
    jq, js = jqmm.quantize_weights(jnp.asarray(w))
    tq, ts = tqmm.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp = jqmm.pack_int8_rows(jq)
    tp = tqmm.pack_int8_rows(tq)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tqmm.unpack_int8_rows(tp).numpy(),
                                  np.asarray(jqmm.unpack_int8_rows(jp)))


@pytest.mark.parametrize("dtype", [np.float32])
def test_int8_matmul_f32_dequant_matches_jax_cpu_path(dtype):
    """int8_mxu=False is the JAX CPU path's f32 dequantization."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 128)).astype(dtype)
    w_q, scale = jqmm.quantize_weights(jnp.asarray(rng.standard_normal((128, 96)) * 0.05))
    w_p = np.array(jqmm.pack_int8_rows(w_q))
    ref = jqmm.int8_matmul_packed(jnp.asarray(x), jnp.asarray(w_p), scale)
    out = tqmm.int8_matmul_packed(torch.from_numpy(x), torch.from_numpy(w_p),
                                  torch.from_numpy(np.array(scale)), int8_mxu=False)
    assert rel_l2(out, ref) <= F32_TOL


def test_int8_matmul_w8a8_matches_tpu_arithmetic():
    """int8_mxu=True reproduces quantized_matmul.py:214-217 exactly (numpy
    copy below), and stays within 2e-2 rel_l2 of the f32 dequant path (the
    int8 rounding of the activations)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 128)).astype(np.float32)
    x[2] = 0.0  # an all-zero row takes row scale 1
    w = rng.standard_normal((128, 80)) * 0.05
    w_q, scale = jqmm.quantize_weights(jnp.asarray(w))
    w_p = np.array(jqmm.pack_int8_rows(w_q))
    scale = np.array(scale)
    # numpy copy of the TPU caller's activation quantization + epilogue
    row_amax = np.max(np.abs(x), axis=1, keepdims=True).astype(np.float32)
    row_scale = np.where(row_amax > 0, row_amax / np.float32(127.0), np.float32(1.0))
    inv = (np.float32(1.0) / row_scale).astype(x.dtype)
    xq = np.clip(np.round(x * inv), -127, 127).astype(np.int8)
    acc = xq.astype(np.int64) @ np.asarray(w_q).astype(np.int64)
    expect = (acc.astype(np.float32) * scale[None, :]) * row_scale.astype(np.float32)

    xt = torch.from_numpy(x)
    tq, trs = tqmm.quantize_rows(xt)
    np.testing.assert_array_equal(tq.numpy(), xq)
    np.testing.assert_array_equal(trs.numpy(), row_scale[:, 0])
    out = tqmm.int8_matmul_packed(xt, torch.from_numpy(w_p), torch.from_numpy(scale))
    np.testing.assert_array_equal(out.numpy(), expect.astype(np.float32))
    f32 = tqmm.int8_matmul_packed(xt, torch.from_numpy(w_p), torch.from_numpy(scale),
                                  int8_mxu=False)
    assert rel_l2(out, f32) <= 2e-2


@pytest.mark.parametrize("fused", [False, True])
def test_quantize_llama_params_bit_exact(fused):
    rng = np.random.default_rng(4)
    L, d, f, v = 2, 64, 96, 40
    blocks = {n: {"kernel": rng.standard_normal(shape).astype(np.float32) * 0.05}
              for n, shape in (("q_proj", (L, d, d)), ("k_proj", (L, d, d)),
                               ("v_proj", (L, d, d)), ("o_proj", (L, d, d)),
                               ("gate_proj", (L, d, f)), ("up_proj", (L, d, f)),
                               ("down_proj", (L, f, d)))}
    blocks["attn_norm"] = {"scale": np.ones((L, d), np.float32)}
    tree = {"params": {"blocks": blocks,
                       "lm_head": {"kernel": rng.standard_normal((d, v)).astype(np.float32)},
                       "embed_tokens": {"embedding": np.zeros((v, d), np.float32)}}}
    jtree = {"params": {k: dict(val) for k, val in tree["params"].items()}}
    jtree["params"]["blocks"] = {k: dict(val) for k, val in blocks.items()}
    if fused:
        jtree = jllama.fuse_llama_params(jtree)
    jq = jllama.quantize_llama_params(jtree, ffn_pad=32)

    from mmor_tpu_torch.utils.convert_jax import convert_llama

    state = convert_llama(tree)
    if fused:
        state = tllama.fuse_llama_params(state)
    tq = tllama.quantize_llama_params(state, ffn_pad=32)
    expect = convert_llama(jax_to_numpy(jq))
    assert set(tq) == set(expect)
    for key, val in expect.items():
        np.testing.assert_array_equal(tq[key].numpy(), val.numpy(), err_msg=key)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------------------------ K4
def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    x[1, 2, 4] = 0.0
    jp, js = jllama.quantize_kv(jnp.asarray(x))
    tq, ts = tllama.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jattn.unpack_kv_heads(jp)))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js, np.float32))


def test_decode_attention_packed_stack_matches_jax():
    """Same int8 cache in both layouts: the TPU's packed (L, B, H, D/4, T)
    words and the port's (L, B, H, T, D) int8; both dequantize equal."""
    rng = np.random.default_rng(6)
    L, B, H, T, D = 3, 2, 4, 40, 16
    k8 = rng.integers(-127, 128, (L, B, H, T, D), dtype=np.int8)
    v8 = rng.integers(-127, 128, (L, B, H, T, D), dtype=np.int8)
    ks = (rng.random((L, B, H, T)) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random((L, B, H, T)) * 0.02 + 0.005).astype(np.float32)
    mask = np.zeros((B, T), np.int32)
    mask[0, 3:30] = 1
    mask[1, :17] = 1
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    jk = jattn.pack_kv_heads(jnp.asarray(k8))
    jv = jattn.pack_kv_heads(jnp.asarray(v8))
    tk = tattn.pack_kv_heads(torch.from_numpy(k8))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tattn.unpack_kv_heads(tk).numpy(), k8)
    ref = jattn.decode_attention_packed_stack(
        jnp.asarray(q), jk, jv, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(mask),
        jnp.asarray(1, jnp.int32))
    out = tattn.decode_attention_packed_stack(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(ks), torch.from_numpy(vs), torch.from_numpy(mask), 1)
    assert out.shape == (B, H, 1, D)
    assert rel_l2(out, ref) <= F32_TOL


def test_apply_rope_matches_jax():
    """HF half rotation at left-padded positions (row 1 starts at -3 -> 0)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    pos = np.stack([np.arange(10), np.clip(np.arange(10) - 3, 0, None)]).astype(np.int32)
    ref = jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    assert rel_l2(out, ref) <= F32_TOL


# ---------------------------------------------------------- preprocessing
@pytest.mark.parametrize("h,w", [(1536, 2048), (1080, 1920)])
def test_preprocess_views_native_sizes(h, w):
    """bf16 resize: the two frameworks round a few pixels to neighbouring
    bf16 values; bound every pixel by two bf16 ulps at 1.0 over the
    smallest CLIP std (2 * 2**-8 / 0.2613 = 0.030) and the mismatching
    share by 1e-3."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jpre.preprocess_views(jnp.asarray(frame), 336))
    out = tpre.preprocess_views(torch.from_numpy(frame), 336).numpy()
    assert out.shape == ref.shape == (1, 336, 336, 3)
    diff = np.abs(out - ref)
    assert diff.max() <= 2 * 2.0 ** -8 / min(tpre.CLIP_STD)
    assert (diff > 0).mean() <= 1e-3


def test_serialization_codes_match_jax():
    rng = np.random.default_rng(8)
    grid = rng.integers(0, 1024, (300, 3), dtype=np.int32)
    for order in jser.ORDERS:
        np.testing.assert_array_equal(
            tser.encode(torch.from_numpy(grid), order).numpy(),
            np.asarray(jser.encode(jnp.asarray(grid), order)), err_msg=order)
