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

The CUDA kernel above 16 rows folds its K-groups into one running f32 sum
that it rescales at each group's boundary (``csrc/int4_matmul.cu``,
``a16_wgmma_kernel``); ``rescaled_fold`` states that order on the CPU and
is held to the same two JAX references within the card's bound for this
branch (``chip_smoke.py``'s ``K3_A16_BOUND``), with a column's scales
spanning 2^-20 to 2^20 across its groups, and with zero scales, which the
kernel must take without dividing by them.
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
K3_A16_BOUND = {"bf16": 1e-3, "f32": 5e-3}  # chip_smoke.py's
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


# ------------------------------------------- the kernel's rescaled group fold
FOLD_K = 1024  # 4 groups of GROUP rows


def rescaled_fold(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor,
                  group: int) -> torch.Tensor:
    """The W4A16 kernel's fold at f32 on x rounded to bf16: one running sum
    ``acc`` in units of ``unit``, the last nonzero scale of its column so
    far (1 before any). Entering group g of scales s, acc is multiplied by
    unit / s where s != 0 and s becomes the unit; a zero scale's group
    loads its weights as 0 and leaves acc and the unit as they are. The
    group's exact bf16 products add into acc, and the result is acc * unit.
    Nothing divides by a zero scale."""
    x = x.to(torch.bfloat16).float()
    acc = torch.zeros(x.shape[0], w4.shape[1])
    unit = torch.ones(w4.shape[1])
    for grp in range(x.shape[1] // group):
        rows = slice(grp * group, (grp + 1) * group)
        s = scale[grp]
        zero = s == 0
        factor = torch.where(zero, torch.ones_like(s), unit / torch.where(zero, 1.0, s))
        acc = acc * factor[None, :]
        unit = torch.where(zero, unit, s)
        q = torch.where(zero[None, :], 0.0, w4[rows].float())
        acc = acc + x[:, rows] @ q
    return acc * unit[None, :]


def fold_inputs(m: int, zeros: bool, seed: int):
    """Seeded numpy (x f32 with row 0 zero, int4 values (FOLD_K, N) int8,
    scales (FOLD_K / GROUP, N) f32 spanning 2^-20..2^20 across a column's
    groups, with, for ``zeros``, a zero group scale in every 5th column, a
    column zero in every group and a whole group zero in column 7)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, FOLD_K), np.float32)
    x[0] = 0
    w4 = rng.integers(-7, 8, (FOLD_K, N)).astype(np.int8)
    scale = (0.01 * np.exp2(rng.integers(-20, 21, (FOLD_K // GROUP, N)))).astype(np.float32)
    if zeros:
        scale[1, ::5] = 0
        scale[:, 3] = 0
        scale[2, 7] = 0
    return x, w4, scale


def jax_fold_refs(x, w4, scale, dtype):
    """JAX's int4_matmul_packed(int8_mxu=False) on the packed weights, x in
    ``dtype``, as f32 numpy."""
    jdt = DTYPES[dtype][0]
    w_p = jqmm.pack_int4_rows(jnp.asarray(w4), block=GROUP)
    out = jqmm.int4_matmul_packed(jnp.asarray(x).astype(jdt), w_p, jnp.asarray(scale),
                                  group=GROUP, int8_mxu=False)
    return as_f32(out)


@pytest.mark.parametrize("m,zeros", [(5, False), (20, False), (20, True)])
def test_w4a16_rescaled_fold_matches_jax_cpu_path(m, zeros):
    """The fold against JAX's CPU path (f32 dequantization, then x @ w) on
    the same bf16-valued x in f32, within K3_A16_BOUND (measured 3.2e-7 to
    3.6e-7: f32 sums in another order); a fold that skipped the rescale
    (each group's dot added in the first group's units) misses it by three
    orders of magnitude (measured 1.1 to 1.2)."""
    x, w4, scale = fold_inputs(m, zeros, seed=4)
    x_bf = as_f32(jnp.asarray(x).astype(jnp.bfloat16))
    ref = jax_fold_refs(x_bf, w4, scale, "f32")
    got = rescaled_fold(torch.from_numpy(x_bf), torch.from_numpy(w4), torch.from_numpy(scale),
                        GROUP).numpy()
    assert np.isfinite(got).all()
    assert rel_l2(got, ref) <= K3_A16_BOUND["bf16"]
    assert not got[0].any()
    # control: the running sum never rescaled
    first = torch.from_numpy(scale[0]).clamp_min(1e-30)
    unscaled = (torch.from_numpy(x_bf) @ torch.from_numpy(w4).float()) * first
    assert rel_l2(unscaled.numpy(), ref) > 10 * K3_A16_BOUND["bf16"]


@pytest.mark.parametrize("m,zeros", [(5, True), (20, False)])
def test_w4a16_rescaled_fold_matches_jax_tpu_body(tpu_body, m, zeros):
    """The fold against the TPU kernel's W4A16 body (interpret mode) on bf16
    x, the bf16 output within K3_A16_BOUND's bf16 bound (measured 0: the
    same bf16 outputs)."""
    x, w4, scale = fold_inputs(m, zeros, seed=5)
    ref = jax_fold_refs(x, w4, scale, "bf16")
    got = rescaled_fold(torch.from_numpy(x), torch.from_numpy(w4), torch.from_numpy(scale), GROUP)
    got = got.to(torch.bfloat16).float().numpy()
    assert rel_l2(got, ref) <= K3_A16_BOUND["bf16"]


def test_w4a16_rescaled_fold_takes_zero_scales_exactly():
    """A column whose scales are all zero comes out exactly 0, a group of
    zero scale adds nothing (the fold equals the same weights with that
    group's values zeroed at a nonzero scale), and no value is inf or nan:
    nothing divides by a zero scale."""
    x, w4, scale = fold_inputs(20, True, seed=6)
    x, w4t, sc = torch.from_numpy(x), torch.from_numpy(w4), torch.from_numpy(scale)
    got = rescaled_fold(x, w4t, sc, GROUP)
    assert torch.isfinite(got).all()
    assert not got[:, 3].any()
    zeroed, sc1 = w4t.clone(), sc.clone()
    for grp, col in [(1, c) for c in range(0, N, 5)] + [(2, 7)]:
        zeroed[grp * GROUP:(grp + 1) * GROUP, col] = 0
        sc1[grp, col] = 1.0
    sc1[:, 3] = 1.0
    zeroed[:, 3] = 0
    same = rescaled_fold(x, zeroed, sc1, GROUP)
    assert rel_l2(got.numpy(), same.numpy()) <= 1e-6
    # and the port's plain W4A16 (the JAX CPU path) agrees on the same x
    plain = tqmm.int4_matmul_packed_plain(x.to(torch.bfloat16).float(),
                                          tqmm.pack_int4_rows(w4t, GROUP), sc, group=GROUP,
                                          int8_mxu=False)
    assert rel_l2(got.numpy(), plain.numpy()) <= K3_A16_BOUND["bf16"]
