"""K9, the fused o-proj + MLP tail (``mmor_tpu_torch/ops/fused_mlp.py``),
against the JAX package's ``fused_o_mlp`` on the CPU.

The same seeded numpy inputs (weights quantized and packed by JAX's
``quantize_weights`` and ``pack_int8_rows``) go through both packages. The
JAX wrapper has two numerics, so the port's plain version (the one a CPU
tensor takes; the CUDA kernel is held to it on the card by ``chip_smoke.py``
and ``tests/test_torch_kernels_cuda.py``) is held to each:

- the TPU kernel's body, reached through ``fused_o_mlp`` with the module's
  ``jax.devices`` reporting a TPU and its ``pl.pallas_call`` in interpret
  mode: rel_l2 <= 1e-4. Both round attn, h and m to bf16 and sum in f32 in
  another order, so an h or m entry at a near-tie can sit one bf16 step
  apart (measured here: equal bit for bit with bf16 residuals, 3.3e-8 with
  f32 ones);
- the JAX CPU branch, which keeps attn, h and m in f32: rel_l2 <= 2e-3
  (measured here 5.4e-4 with an f32 output, the three bf16 roundings, and
  1.2e-3 to 1.4e-3 with a bf16 one, where those move some outputs across a
  rounding boundary of the output itself).

Batches 4, 13 and 20 (none a multiple of 16, the last above one 16-row
tile), with bf16 and f32 residuals.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mmor_tpu.ops import fused_mlp as jfm
from mmor_tpu.ops import quantized_matmul as jqmm
from mmor_tpu_torch.ops import fused_mlp as tfm
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

DQ, D, F = 256, 256, 512
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(4, "bf16"), (13, "f32"), (20, "bf16")]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def as_f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def inputs(b: int, dtype: str, seed: int = 0):
    """Seeded (attn, x_res, norm_scale, wo_p, wo_s, wgu_p, wgu_s, wd_p, wd_s)
    as numpy, x_res's f32 values rounded to ``dtype``; weights N(0, 0.02)
    quantized and packed by JAX."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    attn = rng.standard_normal((b, DQ), np.float32)
    x_res = as_f32(jnp.asarray(rng.standard_normal((b, D), np.float32)).astype(jdt))
    ns = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    packed = []
    for k, n in ((DQ, D), (D, 2 * F), (F, D)):
        w_q, s = jqmm.quantize_weights(jnp.asarray(rng.standard_normal((k, n), np.float32) * 0.02))
        packed += [np.array(jqmm.pack_int8_rows(w_q)), np.array(s)]
    return (attn, x_res, ns, *packed)


def jax_args(args, dtype: str) -> list:
    a = [jnp.asarray(x) for x in args]
    a[1] = a[1].astype(DTYPES[dtype][0])
    return a


def port(args, dtype: str) -> torch.Tensor:
    t = [torch.from_numpy(x) for x in args]
    t[1] = t[1].to(DTYPES[dtype][1])
    out = tfm.fused_o_mlp(*t)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (args[0].shape[0], D)
    return out


@pytest.fixture
def tpu_body(monkeypatch):
    """JAX's ``fused_o_mlp`` taking its TPU branch, the Pallas body in
    interpret mode (the module's ``jax`` and ``pl`` names replaced by views
    that differ only in ``devices`` and ``pallas_call``)."""
    fake_jax = types.SimpleNamespace(**{k: getattr(jax, k) for k in ("lax", "nn")},
                                     ShapeDtypeStruct=jax.ShapeDtypeStruct,
                                     devices=lambda: [types.SimpleNamespace(platform="tpu")])
    fake_pl = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    fake_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jfm, "jax", fake_jax)
    monkeypatch.setattr(jfm, "pl", fake_pl)
    return jfm.fused_o_mlp


@pytest.mark.parametrize("b,dtype", CASES)
def test_fused_o_mlp_matches_jax_tpu_body(tpu_body, b, dtype):
    args = inputs(b, dtype)
    ref = as_f32(tpu_body(*jax_args(args, dtype)))
    got = port(args, dtype).float().numpy()
    assert rel_l2(got, ref) <= 1e-4


@pytest.mark.parametrize("b,dtype", CASES)
def test_fused_o_mlp_matches_jax_cpu_path(b, dtype):
    args = inputs(b, dtype, seed=1)
    ref = as_f32(jfm.fused_o_mlp(*jax_args(args, dtype)))
    got = port(args, dtype).float().numpy()
    assert rel_l2(got, ref) <= 2e-3


@pytest.mark.parametrize("b,n_tiles,groups,stages,smem", [
    (1, 1, 1, 4, 214144), (8, 1, 1, 4, 214144), (14, 2, 1, 3, 230528), (17, 2, 2, 3, 230528),
])
def test_tail_plan_at_the_7b_tail(b, n_tiles, groups, stages, smem):
    """The CUDA kernel's plan at the 7B tail (csrc/fused_mlp.cu): 8-row
    n-tiles of 16-row groups, a ring of stages (32 KB of words and their x)
    that fits a block, and each phase's units (32 columns, gate_up's 32
    gate with their 32 up) and ring stages a unit (256 word rows, gate_up's
    128 of both)."""
    plan = tfm.tail_plan(b, 4096, 4096, 11008)
    assert (plan["n_tiles"], plan["row_groups"], plan["stages"]) == (n_tiles, groups, stages)
    assert plan["smem"] == smem and smem <= 232448
    assert plan["o"] == (128 * groups, 4) and plan["down"] == (128 * groups, 11)
    assert plan["gate_up"] == (344 * groups, 8)


def test_fused_o_mlp_refuses_mismatched_weights():
    t = [torch.from_numpy(a) for a in inputs(4, "f32")]
    t[5] = t[5][:, :-4]  # gate_up words of 2F - 4 columns
    with pytest.raises(ValueError, match="wgu_s"):
        tfm.fused_o_mlp(*t)
