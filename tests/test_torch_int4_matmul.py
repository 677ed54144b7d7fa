"""K3's W4A16 branch (``int4_matmul_packed(..., int8_mxu=False)``) against
the JAX package's, on the CPU.

The same seeded numpy x (f32, and the same values rounded to bf16), weights
quantized by JAX's ``quantize_weights_int4`` at 2 groups of 256 rows and
packed by its ``pack_int4_rows``, go through the port's plain W4A16 (the
version a CPU tensor takes; the CUDA kernels are held to it on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``) and through the
JAX function two ways:

- its CPU path (f32 dequantization, then x @ w): the port's plain version
  is that arithmetic, so the two are equal bit for bit;
- the TPU kernel's body (``_packed4_kernel`` with ``int8_mxu=False``),
  reached through ``int4_matmul_packed`` with the module's ``jax.devices``
  reporting a TPU and its ``pl.pallas_call`` in interpret mode
  (``pallas_tpu_view``, shared with ``test_torch_ops.py``'s K2 tests). The body
  rounds x to bf16 and folds the nibbles' +8 bias as dot(x, u) - 8 rowsum(x)
  in f32, where the port (and its CUDA kernels) removes the bias exactly.
  With bf16 x the two differ by that fold alone: rel_l2 <= 1e-4 (measured
  here 5e-10 to 4.8e-7 on the bf16 output). With f32 x the body's rounding
  of x comes on top: rel_l2 <= 5e-3 against the port on the f32 x
  (measured 1.7e-3), and <= 1e-5 against the port on x rounded to bf16
  first, which measures the fold at f32 output precision (measured
  2.7e-7).

Rows 5 (decode-sized) and 20, each with a zero row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu.ops import quantized_matmul as jqmm
from mmor_tpu_torch.ops import quantized_matmul as tqmm
from pallas_tpu_view import take_tpu_branch
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

K, N, GROUP = 512, 256, 256
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(m, dtype) for m in (5, 20) for dtype in DTYPES]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def as_f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def inputs(m: int, dtype: str, seed: int = 0):
    """Seeded (x, w_p, scale) as numpy: x (m, K) f32 with row 0 zero, its
    values rounded to ``dtype``; N(0, 0.02) weights quantized and packed by
    JAX in GROUP-row groups."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K), np.float32)
    x[0] = 0
    x = as_f32(jnp.asarray(x).astype(DTYPES[dtype][0]))
    w_q, scale = jqmm.quantize_weights_int4(
        jnp.asarray(rng.standard_normal((K, N), np.float32) * 0.02), group=GROUP)
    return x, np.array(jqmm.pack_int4_rows(w_q, block=GROUP)), np.array(scale)


def jax_w4a16(x, w_p, scale, dtype: str) -> np.ndarray:
    out = jqmm.int4_matmul_packed(jnp.asarray(x).astype(DTYPES[dtype][0]), jnp.asarray(w_p),
                                  jnp.asarray(scale), group=GROUP, int8_mxu=False)
    assert out.dtype == DTYPES[dtype][0] and out.shape == (x.shape[0], N)
    return as_f32(out)


def port_w4a16(x, w_p, scale, dtype: str) -> np.ndarray:
    out = tqmm.int4_matmul_packed(torch.from_numpy(x).to(DTYPES[dtype][1]),
                                  torch.from_numpy(w_p), torch.from_numpy(scale), group=GROUP,
                                  int8_mxu=False)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (x.shape[0], N)
    return out.float().numpy()


@pytest.fixture
def tpu_body(monkeypatch):
    """JAX's ``int4_matmul_packed`` taking its TPU branch, the Pallas body
    in interpret mode (``pallas_tpu_view``)."""
    take_tpu_branch(monkeypatch, jqmm)


@pytest.mark.parametrize("m,dtype", CASES)
def test_w4a16_matches_jax_cpu_path_bit_for_bit(m, dtype):
    args = inputs(m, dtype)
    got = port_w4a16(*args, dtype)
    np.testing.assert_array_equal(got, jax_w4a16(*args, dtype))
    assert not got[0].any()  # the zero row


@pytest.mark.parametrize("m,dtype", CASES)
def test_w4a16_matches_jax_tpu_body(tpu_body, m, dtype):
    args = inputs(m, dtype, seed=1)
    ref = jax_w4a16(*args, dtype)
    got = port_w4a16(*args, dtype)
    assert rel_l2(got, ref) <= (1e-4 if dtype == "bf16" else 5e-3)
    assert not ref[0].any() and not got[0].any()


@pytest.mark.parametrize("m", [5, 20])
def test_w4a16_bias_fold_against_exact_unbias(tpu_body, m):
    """The body's 8 rowsum(x) fold against the exact unbias, both in f32 on
    the same bf16-rounded x: the port given x rounded to bf16 first, the
    body given the f32 x (which it rounds itself)."""
    x, w_p, scale = inputs(m, "f32", seed=2)
    ref = jax_w4a16(x, w_p, scale, "f32")
    x_bf = as_f32(jnp.asarray(x).astype(jnp.bfloat16))
    got = port_w4a16(x_bf, w_p, scale, "f32")
    err = rel_l2(got, ref)
    assert 0 < err <= 1e-5, err  # measured, not zero: the fold cancels in f32
