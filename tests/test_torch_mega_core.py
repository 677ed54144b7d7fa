"""K5's weight core (``csrc/mega_core.cuh``) on the CPU: its tiling
(``ops/mega_decode.py::core_plan``, with the kernel's indexing of the
plan's numbers stated here) and its fold order (``core_fold`` here)
against the plain chunk folds the card holds the kernel to bit for bit
(``_w4a8_chunks`` / ``_w8a8_chunks``), and both against the JAX
reference's fold, ``mmor_tpu/ops/mega_decode.py::mega_decode_layers_reference``'s
``mm_quant`` (:1477-1485), called from its own code object.

Tolerances: the port's folds agree with each other bit for bit (the same
exact int32 dots, folded in the same order with the same f32 roundings);
with the reference bit for bit at int8 (its f32 products of int-valued
operands are exact below 2^24); at int4 within rel_l2 1e-6, since the
reference folds each group's scale into the weights before its f32
product (``dq_layer``: "identical up to f32 rounding") where the kernel
multiplies the exact dot by the scale.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu.ops import mega_decode as J
from mmor_tpu.ops import quantized_matmul as JQ
from mmor_tpu_torch.ops import mega_decode as M
from mmor_tpu_torch.ops import quantized_matmul as Q
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

# (K, N, chunk, epilogue) of the 7B phases, int4 groups of 1024 rows
PHASES_7B = {"qkv": (4096, 12288, 1024, "store"), "o": (4096, 4096, 128, "resid"),
             "gate_up": (4096, 22528, 1024, "swiglu"), "down": (11264, 4096, 1024, "resid")}


def _operands(seed, wbits, rows, k, n, chunk, group):
    """Seeded numpy activations quantized per (row, chunk) and a packed int4
    (``group``-row scale groups) or int8 weight; returns the port's tensors
    and the float activations."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[:, 0] *= 30.0  # a large entry sets the first chunk's scale
    w = torch.from_numpy((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    if wbits == 4:
        w_q, sc = Q.quantize_weights_int4(w, group)
        w_p = Q.pack_int4_rows(w_q, group)
    else:
        w_q, sc = Q.quantize_weights(w)
        w_p = Q.pack_int8_rows(w_q)
    q, rs = M._quant_rows_f32(torch.from_numpy(x).reshape(rows, k // chunk, chunk))
    return x, q.reshape(rows, k).to(torch.int8), rs[..., 0].contiguous(), w_p, sc


def _plain(q, rs, w_p, sc, wbits, chunk, group):
    if wbits == 4:
        return M._w4a8_chunks(q, rs, w_p, sc, group, chunk)
    return M._w8a8_chunks(q, rs, w_p, sc, chunk)


def _reference_mm_quant(rows: int, ck: int):
    """The JAX reference's ``mm_quant`` and the ``chunk_quant`` it calls,
    built from ``mega_decode_layers_reference``'s own code objects with the
    closure they would have for ``rows`` rows and activation chunk ``ck``."""
    codes = {c.co_name: c for c in J.mega_decode_layers_reference.__code__.co_consts
             if isinstance(c, types.CodeType)}
    env = dict(ck=ck, rows=rows, f32=jnp.float32)

    def build(name):
        code = codes[name]
        cells = tuple(types.CellType(env[v]) for v in code.co_freevars)
        return types.FunctionType(code, J.__dict__, name, None, cells)

    env["chunk_quant"] = build("chunk_quant")
    return build("mm_quant"), env["chunk_quant"]


# ------------------------------------------------ the kernel's order, stated
# csrc/mega_core.cuh's indexing of a plan's numbers (c_args and the shape):
# its boxes, row sets, unit warps, ring loads, stage slices and folds
def steps_per_unit(plan):
    """32-row steps of a unit (128 K rows each at int8, 128 low and 128
    high at int4)."""
    return plan.unit_k // (128 if plan.wbits == 8 else 256)


def units(plan):
    return plan.k // plan.unit_k


def box_columns(plan, strip, box):
    """The weight columns of box ``box`` of block column ``strip`` (past N
    they load as zeros and are not stored)."""
    if plan.epi == "swiglu":  # a gate box and its up box
        first = box * (plan.n // 2) + strip * M.CORE_BOX_COLS
    else:
        first = (strip * plan.boxes + box) * M.CORE_BOX_COLS
    return range(first, first + M.CORE_BOX_COLS)


def set_rows(plan, slab, row_set):
    """The activation rows of row set ``row_set`` of slab ``slab``."""
    first = slab * plan.slab_rows + 8 * plan.gw * row_set
    end = min(first + 8 * plan.gw, (slab + 1) * plan.slab_rows, plan.rows)
    return range(first, max(first, end))


def rank_units(plan, rank):
    """The units that block ``rank`` of a strip's cluster takes: the
    rank-th of ``ranks`` runs in K order."""
    return range(rank * units(plan) // plan.ranks, (rank + 1) * units(plan) // plan.ranks)


def ring_order(plan, rank=0):
    """The 32-row steps of each of a rank's ring loads, in load order:
    rounds of ``wu`` of its units, a stage of each of the round's units in
    turn."""
    per = plan.stage_rows // M.CORE_STAGE_WORDS
    lpu = steps_per_unit(plan) // per
    mine = rank_units(plan, rank)
    order = []
    for r0 in range(0, len(mine), plan.wu):
        nr = min(plan.wu, len(mine) - r0)
        order += [range(((mine[0] + r0 + w) * lpu + t) * per,
                        ((mine[0] + r0 + w) * lpu + t + 1) * per)
                  for t in range(lpu) for w in range(nr)]
    return order


def stage_k(plan, i):
    """The first K rows of 32-row step i's 128-row slices: one at int8; at
    int4 its words' low-nibble rows and their high-nibble rows, half a
    group later."""
    if plan.wbits == 8:
        return (128 * i,)
    gwr, wr0 = plan.group // 8, M.CORE_STAGE_WORDS * i
    lo = (wr0 // gwr) * plan.group + 4 * (wr0 % gwr)
    return lo, lo + plan.group // 2


def unit_chunks(plan, u):
    """The activation chunks unit u folds, in the order it folds them."""
    per = plan.unit_k // plan.chunk
    return list(range(u * per, (u + 1) * per))


def core_fold(q, rs, w_p, scale, plan):
    """The weight core's accumulation in the kernel's order: each unit's
    stages add their 128-row slices' exact dots to the dots of the chunks
    they lie in (at int4 the nibbles biased by +8, less 8 times the
    activations' row sums), then the unit folds its chunks into the f32
    sums, acc += (dot * w_scale[group]) * rs[:, c] at int4 and acc += dot *
    rs[:, c] at int8, units in order; then (int8) times the per-channel
    scale. The (rows, N) f32 sums before the epilogue; the dots are the
    same integers whichever block or warp takes them."""
    biased = plan.wbits == 4
    if biased:
        w = (Q.unpack_int4_rows(w_p, block=plan.group) + 8).double()
    else:
        w = Q.unpack_int8_rows(w_p).double()
    qd = q.double()
    acc = torch.zeros(q.shape[0], w.shape[1], dtype=torch.float32)
    spu = steps_per_unit(plan)
    for u in range(units(plan)):
        dots = {}
        for kst in range(u * spu, (u + 1) * spu):
            for k0 in stage_k(plan, kst):
                x = qd[:, k0:k0 + 128]
                part = x @ w[k0:k0 + 128]
                if biased:
                    part = part - 8 * x.sum(dim=1, keepdim=True)
                c = k0 // plan.chunk
                dots[c] = dots.get(c, 0) + part
        for c in unit_chunks(plan, u):
            t = dots.pop(c).float()
            if biased:
                t = t * scale[c * plan.chunk // plan.group][None, :]
            acc = acc + t * rs[:, c:c + 1]
    return acc * scale[None, :] if plan.wbits == 8 else acc


def _covered_once(ranges, total):
    hits = np.zeros(total, np.int64)
    for r in ranges:
        idx = np.asarray([i for i in r if i < total], np.int64)
        np.add.at(hits, idx, 1)
    return bool((hits == 1).all())


@pytest.mark.parametrize("wbits", [4, 8])
@pytest.mark.parametrize("phase,rows,ranks", [
    ("qkv", 8, 1), ("o", 8, 1), ("gate_up", 8, 1), ("down", 8, 1), ("qkv", 136, 1),
    ("o", 136, 1), ("gate_up", 136, 1), ("down", 136, 1), ("o", 1, 1), ("down", 17, 1),
    ("qkv", 144, 1), ("o", 200, 1), ("o", 8, 2), ("o", 8, 4), ("down", 8, 2), ("down", 8, 3),
])
def test_core_plan_tiles_every_output_once(wbits, phase, rows, ranks):
    """The 7B plans: every weight column is in one box of one strip (SwiGLU:
    gate column j and up column F + j in the same strip), every row in one
    row set of one slab, every K row in one stage slice, every chunk folded
    once and in order, every unit in one rank of a strip's cluster (K split
    across 2-4 blocks: 11 units of down in 3 uneven runs), taken in turn by
    the row set's warps, each rank's ring a permutation of its part of the
    K walk; the launch fits the H100's shared memory and its warps."""
    k, n, chunk, epi = PHASES_7B[phase]
    plan = M.core_plan(n, k, chunk, rows, wbits, epi, 1024, ranks)
    boxes = [box_columns(plan, s, b) for s in range(plan.strips) for b in range(plan.boxes)]
    assert _covered_once(boxes, n)
    if epi == "swiglu":
        f, half = n // 2, plan.boxes // 2
        for s in range(plan.strips):
            for b in range(half):
                gate, up = box_columns(plan, s, b), box_columns(plan, s, b + half)
                assert [c + f for c in gate] == list(up)
    sets = [set_rows(plan, sl, r) for sl in range(plan.slabs) for r in range(plan.wr)]
    assert _covered_once(sets, rows)
    assert all(len(r) <= 8 * plan.gw for r in sets)
    slices = [range(k0, k0 + 128) for i in range(units(plan) * steps_per_unit(plan))
              for k0 in stage_k(plan, i)]
    assert _covered_once(slices, k)
    chunks = [c for u in range(units(plan)) for c in unit_chunks(plan, u)]
    assert chunks == list(range(k // chunk))
    spu = steps_per_unit(plan)
    for u in range(units(plan)):  # a unit's chunks hold exactly its steps' slices
        ks = {k0 // chunk for i in range(u * spu, (u + 1) * spu) for k0 in stage_k(plan, i)}
        assert ks == set(unit_chunks(plan, u))
    mine = [rank_units(plan, r) for r in range(plan.ranks)]
    assert all(len(m) >= 1 for m in mine)
    taken = [m[u] for m in mine for w in range(plan.wu) for u in range(w, len(m), plan.wu)]
    assert sorted(taken) == list(range(units(plan)))
    # every step in one load of the rank that takes its unit, each unit's
    # loads in K order
    loads = [ld for r in range(plan.ranks) for ld in ring_order(plan, r)]
    assert sorted(i for ld in loads for i in ld) == list(range(units(plan) * spu))
    assert all(len(ld) == plan.stage_rows // M.CORE_STAGE_WORDS for ld in loads)
    for r in range(plan.ranks):
        assert {ld[0] // spu for ld in ring_order(plan, r)} == set(mine[r])
    for u in range(units(plan)):
        firsts = [ld[0] for ld in loads if ld[0] // spu == u]
        assert firsts == sorted(firsts)
    assert plan.stages % plan.wu == 0
    assert plan.wr * plan.wu <= M.CORE_WARPS and plan.smem <= M.CORE_SMEM
    assert plan.slab_rows <= 8 * plan.gw * plan.wr and 1 <= plan.stages <= M.CORE_MAX_STAGES


@pytest.mark.parametrize("wbits,rows,k,n,chunk,group", [
    (4, 1, 512, 64, 256, 256), (4, 8, 1024, 96, 512, 512), (4, 13, 768, 40, 256, 256),
    (4, 40, 1024, 64, 128, 512), (4, 136, 1024, 36, 128, 512), (4, 8, 1536, 32, 512, 512),
    (8, 1, 384, 64, 128, None), (8, 8, 1024, 96, 256, None), (8, 17, 640, 40, 128, None),
    (8, 40, 1152, 64, 384, None), (8, 136, 512, 36, 256, None), (8, 200, 768, 32, 256, None),
])
def test_core_fold_matches_plain_chunks(wbits, rows, k, n, chunk, group):
    """``core_fold`` (the kernel's stages, biased nibbles and unit-ordered
    folds) equals the plain chunk fold bit for bit: 1 to 12 chunks (odd
    counts included), chunks that split int4 groups, 1 to 200 rows."""
    _, q, rs, w_p, sc = _operands(rows * 7 + k, wbits, rows, k, n, chunk, group)
    epi = "resid" if wbits == 4 and chunk != group else "store"
    plan = M.core_plan(n, k, chunk, rows, wbits, epi, group)
    got = core_fold(q, rs, w_p, sc, plan)
    assert torch.equal(got, _plain(q, rs, w_p, sc, wbits, chunk, group))


@pytest.mark.parametrize("wbits,rows,k,n,chunk,group", [
    (4, 1, 512, 64, 256, 256), (4, 8, 1024, 96, 512, 512), (4, 13, 768, 48, 256, 256),
    (4, 40, 1024, 64, 128, 512), (4, 8, 1536, 32, 512, 512),
    (8, 1, 384, 64, 128, None), (8, 8, 1024, 96, 256, None), (8, 17, 640, 40, 128, None),
    (8, 40, 1152, 64, 384, None), (8, 136, 512, 36, 256, None),
])
def test_core_folds_match_jax_reference_mm_quant(wbits, rows, k, n, chunk, group):
    """The same activations and weights through the JAX reference's
    ``mm_quant`` (its chunk quantization, its per-chunk products and folds,
    int4 weights dequantized per group as its ``dq_layer`` does; the
    o-projection's per-head fold is ``mm_quant`` at chunk = head dim): its
    int8 activations and scales equal the port's bit for bit, its sums the
    port's plain fold and ``core_fold``'s (int8 bit for bit, int4 within
    rel_l2 1e-6)."""
    x, q, rs, w_p, sc = _operands(rows * 3 + k, wbits, rows, k, n, chunk, group)
    mm_quant, chunk_quant = _reference_mm_quant(rows, chunk)
    jq, jrs = chunk_quant(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jq).reshape(rows, k), q.numpy().astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jrs)[..., 0], rs.numpy())
    if wbits == 4:
        wv = np.asarray(JQ.unpack_int4_rows(jnp.asarray(w_p.numpy()), block=group),
                        np.float32)
        wv = (wv.reshape(k // group, group, n) * sc.numpy()[:, None, :]).reshape(k, n)
        colscale = np.ones(n, np.float32)
    else:
        wv = np.asarray(JQ.unpack_int8_rows(jnp.asarray(w_p.numpy())), np.float32)
        colscale = sc.numpy()
    ref = np.asarray(mm_quant(jnp.asarray(x), jnp.asarray(wv), jnp.asarray(colscale)))
    epi = "resid" if wbits == 4 and chunk != group else "store"
    plan = M.core_plan(n, k, chunk, rows, wbits, epi, group)
    plain = _plain(q, rs, w_p, sc, wbits, chunk, group).numpy()
    folded = core_fold(q, rs, w_p, sc, plan).numpy()
    np.testing.assert_array_equal(folded, plain)
    if wbits == 8:
        np.testing.assert_array_equal(plain, ref)
    else:
        err = np.linalg.norm(plain.astype(np.float64) - ref) / np.linalg.norm(ref)
        assert err <= 1e-6, err


@pytest.mark.parametrize("epi", ["store", "resid", "swiglu"])
def test_mega_project_cpu_is_the_plain_fold(epi):
    """On CPU tensors ``mega_project`` is its plain version: the chunk fold
    and the epilogue K5's plain chain applies (the residual added, SiLU of
    the gate columns times the paired up columns)."""
    _, q, rs, w_p, sc = _operands(5, 4, 9, 512, 64, 256, 256)
    acc = M._w4a8_chunks(q, rs, w_p, sc, 256, 256)
    resid = torch.randn(9, 64, generator=torch.Generator().manual_seed(0))
    got = M.mega_project(q, rs, w_p, sc, wbits=4, chunk=256, group=256, epi=epi, resid=resid)
    want = {"store": acc, "resid": resid + acc,
            "swiglu": acc[:, :32] * torch.sigmoid(acc[:, :32]) * acc[:, 32:]}[epi]
    assert torch.equal(got, want)


def test_core_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="residual"):  # chunks split a group: o only
        M.core_plan(64, 1024, 128, 8, 4, "store", 512)
    with pytest.raises(ValueError, match="int4 needs"):
        M.core_plan(64, 640, 128, 8, 4, "store", 128)
    with pytest.raises(ValueError, match="int8 needs"):
        M.core_plan(64, 640, 256, 8, 8, "store")
    with pytest.raises(ValueError, match="epilogue"):
        M.core_plan(64, 512, 128, 8, 8, "gelu")
    with pytest.raises(ValueError, match="swiglu"):
        M.core_plan(63, 512, 128, 8, 8, "swiglu")
    with pytest.raises(ValueError, match="ranks"):  # 4 units of K for 5 blocks
        M.core_plan(64, 4096, 1024, 8, 4, "store", 1024, 5)
    with pytest.raises(ValueError, match="ranks"):  # above the portable cluster
        M.core_plan(64, 16384, 1024, 8, 4, "store", 1024, 9)


@pytest.mark.parametrize("wbits", [4, 8])
@pytest.mark.parametrize("rows", [8, 16, 136])
def test_megakernel_plans_at_7b(wbits, rows):
    """The four plans K5 hands its C entry point at 7B (D 4096, ffn 11264,
    32 heads, K-chunk 1024): the o-projection at the head dim's chunks, one
    box a block for o and down and two for qkv and gate_up, all of the
    decode and chunk rows in one slab, and 32 plan integers."""
    weights = M.MegaWeights([[] for _ in range(8)], torch.ones(1, 2, 4096), 1024, 11264, 32,
                            wbits)
    plans = M.core_plans(weights, rows)
    assert [p.chunk for p in plans] == [1024, 128, 1024, 1024]
    assert [p.boxes for p in plans] == [2, 1, 2, 1]
    assert [p.strips for p in plans] == [192, 128, 352, 128]
    assert all(p.slabs == 1 and p.slab_rows >= rows for p in plans)
    assert sum(len(p.c_args) for p in plans) == 32
    # K split over a 2-block cluster: the int4 down projection at up to 8 rows
    assert [p.ranks for p in plans] == [1, 1, 1, 2 if wbits == 4 and rows <= 8 else 1]
    if rows <= 16:  # 16 KB of words a stage: 128 word rows of one box, 64 of two
        assert [p.stage_rows for p in plans] == [64, 128, 64, 128]
