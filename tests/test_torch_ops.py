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
from pallas_tpu_view import take_tpu_branch
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


# K2's W8A16 branch (int8_mxu=False): x dtype, rows on both sides of the
# kernels' 16-row switch, narrowed projection shapes (K, N); the TPU body's
# cases take N a multiple of 128, as its column blocks need
W8A16_TPU_CASES = [
    pytest.param(np.float32, 5, 256, 256, id="float32-m5"),
    pytest.param("bf16", 5, 256, 384, id="bf16-m5"),
    pytest.param(np.float32, 20, 512, 256, id="float32-m20"),
    pytest.param("bf16", 20, 256, 384, id="bf16-m20"),
]
W8A16_CASES = [pytest.param(np.float32, 5, 128, 96, id="float32"), *W8A16_TPU_CASES[1:]]
BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative


def w8a16_inputs(dtype, m: int, k: int, n: int, seed: int = 2):
    """Seeded numpy (x, w_p, scale): x (m, K) with row 0 zero, its values
    rounded to ``dtype``; N(0, 0.05) weights quantized and packed by JAX."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0] = 0
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w_q, scale = jqmm.quantize_weights(jnp.asarray(rng.standard_normal((k, n)) * 0.05))
    return x, np.array(jqmm.pack_int8_rows(w_q)), np.array(scale)


def w8a16_jax(x, w_p, scale, dtype) -> np.ndarray:
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = jqmm.int8_matmul_packed(jnp.asarray(x).astype(jdt), jnp.asarray(w_p),
                                  jnp.asarray(scale), int8_mxu=False)
    assert out.dtype == jdt and out.shape == (x.shape[0], w_p.shape[1])
    return np.asarray(out.astype(jnp.float32))


def w8a16_port(x, w_p, scale, dtype) -> np.ndarray:
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = tqmm.int8_matmul_packed(torch.from_numpy(x).to(tdt), torch.from_numpy(w_p),
                                  torch.from_numpy(scale), int8_mxu=False)
    assert out.dtype == tdt and out.shape == (x.shape[0], w_p.shape[1])
    return out.float().numpy()


@pytest.mark.parametrize("dtype,m,k,n", W8A16_CASES)
def test_int8_matmul_f32_dequant_matches_jax_cpu_path(dtype, m, k, n):
    """int8_mxu=False is the JAX CPU path's f32 dequantization: f32 output
    within F32_TOL (sums in another order), bf16 within one bf16 rounding
    step."""
    args = w8a16_inputs(dtype, m, k, n)
    out = w8a16_port(*args, dtype)
    assert rel_l2(out, w8a16_jax(*args, dtype)) <= (BF16_STEP if dtype == "bf16" else F32_TOL)
    assert not out[0].any()


@pytest.fixture
def tpu_body(monkeypatch):
    """JAX's quantized matmuls taking their TPU branch, the Pallas bodies in
    interpret mode (``pallas_tpu_view``)."""
    take_tpu_branch(monkeypatch, jqmm)


@pytest.mark.parametrize("dtype,m,k,n", W8A16_TPU_CASES)
def test_int8_matmul_w8a16_matches_jax_tpu_body(tpu_body, dtype, m, k, n):
    """The same inputs through the TPU kernel's W8A16 body
    (quantized_matmul.py:170-174: x rounded to bf16, bf16 products summed in
    f32, times the column scale). bf16 x: the port (and its CUDA kernels)
    within 1e-4 (sums in another order; measured up to 5.1e-5). f32 x: the
    body's rounding of x comes on top, within 5e-3 (measured 1.7e-3), and
    the port given x rounded to bf16 first stays within F32_TOL (measured
    3e-7), the rule the CUDA kernels follow."""
    x, w_p, scale = w8a16_inputs(dtype, m, k, n, seed=3)
    ref = w8a16_jax(x, w_p, scale, dtype)
    got = w8a16_port(x, w_p, scale, dtype)
    assert not ref[0].any() and not got[0].any()
    if dtype == "bf16":
        assert rel_l2(got, ref) <= 1e-4
    else:
        assert rel_l2(got, ref) <= 5e-3
        x_bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        assert rel_l2(w8a16_port(x_bf, w_p, scale, dtype), ref) <= F32_TOL


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


# K4's rows at the edges of its kernel's cluster ranks and skipped
# positions (csrc/decode_attention.cu): each row's valid [lo, hi); T = 600
# is not a multiple of a rank's 512-position span
K4_EDGE_ROWS = {
    "valid_len_1_last": (599, 600),
    "left_padded": (37, 600),
    "no_valid_position": (0, 0),
    "valid_len_1_first": (0, 1),
}


@pytest.mark.parametrize("t", [600, 1])
def test_decode_attention_packed_stack_edges_match_jax(t):
    """K4's plain version against the JAX function (its CPU path) at the
    rows the kernel treats apart: one valid position, first or last; left
    padding; no valid position (equal weights over all of T, the softmax of
    a constant row, in both); T off a rank's span, and T = 1."""
    rng = np.random.default_rng(7)
    rows = list(K4_EDGE_ROWS)
    L, B, H, D = 2, len(rows), 2, 16
    k8 = rng.integers(-127, 128, (L, B, H, t, D), dtype=np.int8)
    v8 = rng.integers(-127, 128, (L, B, H, t, D), dtype=np.int8)
    ks = (rng.random((L, B, H, t)) * 0.02 + 0.005).astype(np.float32)
    vs = (rng.random((L, B, H, t)) * 0.02 + 0.005).astype(np.float32)
    mask = np.zeros((B, t), np.int32)
    for r, name in enumerate(rows):  # at T = 1 every valid range is position 0
        lo, hi = K4_EDGE_ROWS[name]
        mask[r, min(lo, t - 1):min(hi, t)] = 1
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    ref = jattn.decode_attention_packed_stack(
        jnp.asarray(q), jattn.pack_kv_heads(jnp.asarray(k8)),
        jattn.pack_kv_heads(jnp.asarray(v8)), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(mask), jnp.asarray(1, jnp.int32))
    out = tattn.decode_attention_packed_stack(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(ks), torch.from_numpy(vs), torch.from_numpy(mask), 1)
    assert rel_l2(out, ref) <= F32_TOL
    empty = rows.index("no_valid_position")
    uniform = np.einsum("ht,htd->hd", vs[1, empty] / t, v8[1, empty].astype(np.float32))
    assert rel_l2(out[empty, :, 0].numpy(), uniform) <= F32_TOL


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
