"""The megakernel design probes (K10e) and the layout probe (K10f) of the port's
tools against the JAX scripts, on the CPU.

The same seeded numpy inputs go through each JAX script's Pallas kernel body
in interpret mode (``tools/perf/bench_megakernel_probe.py``'s ``_kern_stack``,
``_kern_dslice``, ``_kern_tiny``, ``_kern_nib`` and ``_kern_rowrw`` inside a
``pallas_call`` built here as the script builds it, with ``CK`` cut to 256;
``tools/perf/probe_mosaic_reshape.py``'s ``main`` with its ``pl`` swapped for
an interpret-mode view) and through the port's wrappers on CPU tensors,
which are their plain versions (the CUDA kernels are held to those on the
card by ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``).

Tolerances:
- x-read with int8 x, the tiny kernel, the packers: bit for bit (the same
  exact integer tile sums cast to f32 and added in the same order; an
  identity; the same words).
- x-read with bf16 x and the nibble product: every output within one bf16
  step of its own value (both round an f32 sum of the same exact products,
  summed in another order, once).
- The row probe's output rows against the interpret body: rel_l2 <= 1e-6
  (f32 sums in another order); every row in dynamic mode, row (0, 0) alone
  in static mode, where the TPU left the other rows undefined (NaN in
  interpret mode). Its full acc against numpy in float64: rel_l2 <= 1e-6.
- K10f: the five printed names and all-ones sums equal the JAX script's,
  at its shape and at the card tests' ragged ones; the plain versions
  against numpy at random inputs, the copies exact, the products
  rel_l2 <= 1e-6.
"""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mmor_tpu_torch.ops.quantized_matmul import pack_int8_rows
from mmor_tpu_torch.tools.perf import bench_megakernel_probe as MP
from mmor_tpu_torch.tools.perf import probe_mosaic_reshape as RP
from mmor_tpu.ops.quantized_matmul import pack_int8_rows as jpack_int8_rows
from test_torch_perf_tools import assert_close, interpret_pl, jnp_np, rel_l2, to_np
from tools.perf import bench_megakernel_probe as jbm
from tools.perf import probe_mosaic_reshape as jprobe
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

M, K, N, CK, BN = 24, 512, 256, 256, 128  # two K-tiles, two weight tiles


def bf16_values(rng, shape) -> np.ndarray:
    """Seeded normal values that bf16 holds exactly, as f32 numpy."""
    return jnp_np(jnp.asarray(rng.standard_normal(shape, np.float32)).astype(jnp.bfloat16))


def matmul_call(kern, x_spec, x, w, scale, mpad, bkp):
    """The scripts' (n_n * n_k,) grid of one K-tile a step around ``kern``,
    in interpret mode: x by ``x_spec``, the (bkp, BN) weight tile of step s,
    the scale's, and the (mpad, BN) output tile with its f32 scratch."""
    n_k, n_n = K // CK, N // BN
    return pl.pallas_call(
        functools.partial(kern, n_k=n_k), grid=(n_n * n_k,),
        in_specs=[x_spec, pl.BlockSpec((bkp, BN), lambda s: (s % n_k, s // n_k)),
                  pl.BlockSpec((1, BN), lambda s: (0, s // n_k))],
        out_specs=pl.BlockSpec((mpad, BN), lambda s: (0, s // n_k)),
        out_shape=jax.ShapeDtypeStruct((mpad, N), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((mpad, BN), jnp.float32)], interpret=True,
    )(x, w, scale[None, :])


# ------------------------------------------------------------------ xread
@pytest.mark.parametrize("x8", [True, False], ids=["int8", "bf16"])
def test_xread_matches_jax_kernel_bodies(monkeypatch, x8):
    monkeypatch.setattr(jbm, "CK", CK)
    monkeypatch.setattr(jbm, "MXU8", x8)
    rng = np.random.default_rng(0)
    wq = rng.integers(-127, 128, (K, N), dtype=np.int8)
    scale = rng.uniform(0.005, 0.02, N).astype(np.float32)
    x = bf16_values(rng, (M, K))
    if x8:  # the script's pre-quantized activations (:178-179)
        x = np.clip(np.round(x * 4.0), -127, 127).astype(np.int8)
    mpad = MP.xread_mpad(M, x8)
    assert mpad == (max(32, -(-M // 32) * 32) if x8 else max(16, -(-M // 16) * 16))
    xr = np.zeros((mpad, K), x.dtype)
    xr[:M] = x
    n_k = K // CK
    xt = xr.reshape(mpad, n_k, CK).transpose(1, 0, 2).copy()
    jdt = jnp.int8 if x8 else jnp.bfloat16
    wp = jpack_int8_rows(jnp.asarray(wq))
    refs = {
        "stack": jnp_np(matmul_call(jbm._kern_stack, pl.BlockSpec((n_k, mpad, CK),
                                                               lambda s: (0, 0, 0)),
                                 jnp.asarray(xt).astype(jdt), wp, jnp.asarray(scale), mpad,
                                 CK // 4)),
        "dslice": jnp_np(matmul_call(jbm._kern_dslice, pl.BlockSpec((mpad, K), lambda s: (0, 0)),
                                  jnp.asarray(xr).astype(jdt), wp, jnp.asarray(scale), mpad,
                                  CK // 4))}
    tdt = torch.int8 if x8 else torch.bfloat16
    xr_t = torch.from_numpy(xr).to(tdt)
    xt_t = MP.tile_stack(xr_t, CK)
    np.testing.assert_array_equal(to_np(xt_t), xt.astype(np.float32) if not x8 else xt)
    w_p = pack_int8_rows(torch.from_numpy(wq))
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(wp))
    for layout, xx in (("stack", xt_t), ("dslice", xr_t)):
        got = MP.xread_matmul(xx, w_p, torch.from_numpy(scale), ck=CK)
        assert got.dtype == torch.bfloat16 and got.shape == (mpad, N)
        if x8:
            np.testing.assert_array_equal(to_np(got), refs[layout])
        else:
            assert_close(got, refs[layout], "bf16")


@pytest.mark.parametrize("ck,stack,rows,stages", [
    (2048, True, 128, 3),   # the bench's stack: a 64 KB K-tile beside three 48 KB stages
    (2048, False, 128, 3),  # the bench's 2-D x: 64 KB stages with their x boxes
    (64, True, 16, 4),      # K = CK = 64: a tile of 16 word rows, one stage
    (64, False, 16, 3),
    (576, False, 16, 3),    # 144 word rows a tile: 16 divides it, 32 does not
    (3712, True, 32, 2),    # the stack's largest tile: 29 x boxes beside two stages
    (3776, False, 16, 3),   # c holds no tile: any CK
])
def test_xread_plan(ck, stack, rows, stages):
    """The int8 x-read kernel's plan (csrc/megakernel_probe.cu's xr::plan):
    a stage's word rows divide a K-tile's, the ring and the tile fit a
    block's shared memory."""
    plan = MP.xread_plan(ck, stack)
    assert (plan["stage_rows"], plan["stages"]) == (rows, stages)
    assert (ck // 4) % rows == 0 and plan["smem"] <= MP.SMEM_PER_BLOCK


@pytest.mark.parametrize("ck,stack", [(3776, True), (4096, True), (96, False), (32, True)])
def test_xread_plan_refuses(ck, stack):
    """A stack's tile too large for two stages beside it, or a CK off 64."""
    with pytest.raises(ValueError):
        MP.xread_plan(ck, stack)


# --------------------------------------------------------------- overhead
def test_tiny_matches_jax_kernel_bit_for_bit():
    x = bf16_values(np.random.default_rng(1), (16, 256))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jnp_np(pl.pallas_call(jbm._kern_tiny, out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype),
                             interpret=True)(xj))
    got = MP.tiny(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), ref)
    np.testing.assert_array_equal(ref, x)  # bf16(1.0000001) is 1.0: an identity


# ----------------------------------------------------------------- nibble
def test_nibble_packing_and_deinterleave_equal_jax():
    rng = np.random.default_rng(2)
    wq = rng.integers(-8, 8, (K, N), dtype=np.int8)  # every nibble, the sign bits included
    got = MP.pack_nibble_words(torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbm.pack_int4_rows(jnp.asarray(wq))))
    np.testing.assert_array_equal(MP.unpack_nibble_words(got).numpy(), wq)

    x = bf16_values(rng, (M, K))
    mpad, n_k = MP.xread_mpad(M, False), K // CK
    xj = jnp.asarray(x).astype(jnp.bfloat16)  # the script's :280-284
    xc = xj.reshape(M, n_k, CK).transpose(1, 0, 2)
    xi = jnp.zeros((n_k, mpad, CK), jnp.bfloat16).at[:, :M].set(
        jnp.concatenate([xc[..., 0::2], xc[..., 1::2]], axis=-1))
    got = MP.deinterleave_chunks(torch.from_numpy(x).to(torch.bfloat16), CK, mpad)
    np.testing.assert_array_equal(to_np(got), jnp_np(xi))


def test_nibble_matmul_matches_jax_kernel_body():
    rng = np.random.default_rng(3)
    wq = rng.integers(-8, 8, (K, N), dtype=np.int8)
    scale = rng.uniform(0.005, 0.02, N).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(torch.bfloat16)
    mpad = MP.xread_mpad(M, False)
    xi = MP.deinterleave_chunks(x, CK, mpad)
    ref = jnp_np(matmul_call(jbm._kern_nib, pl.BlockSpec((1, mpad, CK), lambda s: (s % (K // CK),
                                                                                 0, 0)),
                          jnp.asarray(to_np(xi)).astype(jnp.bfloat16),
                          jbm.pack_int4_rows(jnp.asarray(wq)), jnp.asarray(scale), mpad, CK // 8))
    got = MP.nibble_matmul(xi, MP.pack_nibble_words(torch.from_numpy(wq)),
                           torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (mpad, N)
    assert_close(got, ref, "bf16")


# ------------------------------------------------------------------ rowrw
RB, HGN, HEADS, T = 3, 2, 2, 128


def rowrw_inputs(seed: int):
    rng = np.random.default_rng(seed)
    q = bf16_values(rng, (HGN, RB, HEADS * 128))
    kp = rng.integers(-2 ** 30, 2 ** 30, (HGN * RB, HEADS, 32, T), dtype=np.int32)
    return q, kp


def key_rows_np(kp: np.ndarray) -> np.ndarray:
    """The second-minor bitcast in numpy: row 4r + b is byte b of word row r."""
    s, g, r, t = kp.shape
    b = kp.view(np.uint32)[:, :, :, None, :] >> (8 * np.arange(4, dtype=np.uint32))[:, None]
    return (b & 0xFF).astype(np.uint8).view(np.int8).reshape(s, g, 4 * r, t)


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dyn"])
def test_rowrw_matches_jax_kernel_body(dyn):
    q, kp = rowrw_inputs(4)
    ref = jnp_np(pl.pallas_call(
        functools.partial(jbm._kern_rowrw, b=RB, dyn=dyn), grid=(HGN * RB,),
        in_specs=[pl.BlockSpec((HGN, RB, HEADS * 128), lambda s: (0, 0, 0)),
                  pl.BlockSpec((1, HEADS, 32, T), lambda s: (s, 0, 0, 0))],
        out_specs=pl.BlockSpec((HGN, RB, HEADS * 128), lambda s: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((HGN, RB, HEADS * 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((HGN, RB, HEADS * 128), jnp.float32)], interpret=True,
    )(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(kp)))
    out, acc = MP.rowrw(torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(kp), dyn=dyn)
    assert out.shape == (HGN, RB, HEADS * 128) and out.dtype == torch.float32
    assert acc.shape == (HGN * RB, T) and acc.dtype == torch.float32
    if dyn:
        assert rel_l2(out.numpy(), ref) <= 1e-6
    else:
        assert rel_l2(out.numpy()[0, 0], ref[0, 0]) <= 1e-6
        assert not out.numpy().reshape(HGN * RB, -1)[1:].any()  # the port's zeros

    k8 = key_rows_np(kp).astype(np.float64)
    np.testing.assert_array_equal(MP.key_rows(torch.from_numpy(kp)).numpy(), key_rows_np(kp))
    rows = q.reshape(HGN * RB, -1).astype(np.float64)
    if not dyn:
        rows = np.broadcast_to(rows[:1], rows.shape)
    want = np.einsum("sk,skt->st", rows, k8.reshape(HGN * RB, HEADS * 128, T))
    assert rel_l2(acc.numpy(), want) <= 1e-6


# ------------------------------------------------------------------- K10f
def ok_lines(text: str) -> list[tuple[str, float]]:
    return [(m.group(1), float(m.group(2)))
            for m in re.finditer(r"^\[OK \] (.+?): out_sum=(-?[\d.]+)", text, re.M)]


def test_reshape_probe_main_matches_jax_main(monkeypatch):
    monkeypatch.setattr(jprobe, "pl", interpret_pl())
    with contextlib.redirect_stdout(io.StringIO()) as jax_out:
        jprobe.main()
    with contextlib.redirect_stdout(io.StringIO()) as port_out:
        result = RP.main("cpu", repeats=1)
    ref, got = ok_lines(jax_out.getvalue()), ok_lines(port_out.getvalue())
    assert len(ref) == 5 and "[FAIL]" not in jax_out.getvalue(), jax_out.getvalue()
    assert got == ref
    assert [s for _, s in ref] == [327680.0, 40960.0, 10485760.0, 10485760.0, 4096.0]
    assert list(result["sums"].items()) == got


@pytest.mark.parametrize("tq,wh,ww,d", [
    (37, 4, 11, 11),  # K 44, which the card kernel's 16 ranks do not divide
    (36, 5, 9, 12),   # K 45
    (64, 4, 10, 64),  # K 40: ranks with no k, two channel tiles
])
def test_reshape_probe_main_matches_jax_main_at_card_shapes(monkeypatch, tq, wh, ww, d):
    """Both scripts' mains at the ragged shapes the card tests give K10f
    (tests/test_torch_kernels_cuda.py::test_reshape_probe_kernels; probe e's
    one-hot row 3 and column 5 lie inside each window)."""
    for mod in (jprobe, RP):
        for name, value in (("TQ", tq), ("WH", wh), ("WW", ww), ("D", d), ("K", wh * ww)):
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jprobe, "pl", interpret_pl())
    with contextlib.redirect_stdout(io.StringIO()) as jax_out:
        jprobe.main()
    with contextlib.redirect_stdout(io.StringIO()) as port_out:
        RP.main("cpu", repeats=1)
    ref, got = ok_lines(jax_out.getvalue()), ok_lines(port_out.getvalue())
    assert len(ref) == 5 and "[FAIL]" not in jax_out.getvalue(), jax_out.getvalue()
    assert got == ref
    k = wh * ww
    assert [s for _, s in ref] == [tq * k, k * d, tq * k * d, tq * k * d, tq * d * 0.5]


def test_reshape_probe_plain_versions_match_numpy():
    rng = np.random.default_rng(5)
    tq, wh, ww, d = 24, 4, 5, 8
    k = wh * ww
    s3 = rng.standard_normal((tq, wh, ww), np.float32)
    win = rng.standard_normal((wh, ww, d), np.float32)
    st = rng.standard_normal((k, tq), np.float32)
    got = RP.reshape_copy(torch.from_numpy(s3), (tq, k))
    np.testing.assert_array_equal(got.numpy(), s3.reshape(tq, k))
    np.testing.assert_array_equal(RP.reshape_copy(torch.from_numpy(win), (k, d)).numpy(),
                                  win.reshape(k, d))
    w2 = win.reshape(k, d).astype(np.float64)
    iy, ix, wx = 1, 3, 0.5
    onehot = np.zeros((tq, k))
    onehot[:, iy * ww + ix] = wx
    for mode, a, b, want in (
            ("transposed", st, win.reshape(k, d), st.T.astype(np.float64) @ w2),
            ("contracted", s3, win, s3.reshape(tq, k).astype(np.float64) @ w2),
            ("onehot", None, win, onehot @ w2)):
        out = RP.st_product(None if a is None else torch.from_numpy(a), torch.from_numpy(b),
                            mode=mode, tq=tq, onehot=(iy, ix, wx))
        assert out.shape == (tq, d) and out.dtype == torch.float32
        assert rel_l2(out.numpy(), want) <= 1e-6, mode
