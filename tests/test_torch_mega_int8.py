"""Parity of the port's decode megakernel at its int8 widths (K5-int8: int8
weights with per-channel scales, W8A8; an int8 KV cache) with the JAX package
on the CPU, serial and overlapped.

The LLaMA is ``tests/test_torch_mega.py``'s megakernel geometry: dim 512, 4
heads of 128, ffn 1024, so ``pick_ck`` is 256 (the activation K-chunk, and
the int4 group of the mixed pairs). Weights and inputs are seeded numpy
arrays given to both packages (the quantized trees come from the port's
quantizers, which ``tests/test_torch_ops.py`` and ``test_torch_mega.py`` hold
bit-exact to the JAX package's); the port gets the JAX trees and caches
through ``utils/convert_jax.py``. The JAX side runs its reference arithmetic
(``mega_decode_layers_reference``, and ``generate_stepwise`` /
``generate_overlapped`` on their CPU fallback).

Tolerances, as for the int4 path (``test_torch_mega.py``,
``test_torch_overlap.py``) and for the same reasons:
- K5's plain version against ``mega_decode_layers_reference`` at (8, 8),
  (4, 8) and (8, 4), two layers at once: x_out rel_l2 <= 2e-3 (a bf16
  output; at int4 weights the reference folds the group scales into f32
  weights where the port sums exact integers), the int8 K/V columns never
  more than 1 apart and equal in >= 99.9% of entries, the first layer's
  scales rel_l2 <= 1e-6;
- the int8 cache plumbing (``apply_kv_update``, ``mega_cache_from_jax``, the
  prefill's cache, the working-cache updates, flushes and the handoff):
  equal to JAX's;
- pf rows at (8, 8), each layer alone: x rel_l2 <= 2e-3, K/V within one bin,
  the decode rows' equal in >= 99.9% and the chunk rows' in >= 99.8% (an f32
  tie in the RMSNorm flips an activation bin about once a layer), scales
  rel_l2 <= 1e-3; the decode rows bit-identical with and without the chunk;
- the port of ``test_pf_prefill_matches_tokenwise_decode_oracle`` at its
  bounds: layer 0's K/V bit-exact, later layers within one bin in > 90% of
  entries, scales and the last prompt token's hidden state rel_l2 < 0.05;
  the handed-off cache equal to JAX's ``pf_full_to_decode_cache`` of the
  same prefill buffer;
- ``generate_stepwise`` at (8, 8): the same tokens as JAX's;
- ``generate_overlapped`` at (8, 8), teacher-forced on JAX's tokens: the same
  choice at every step whose two best logits are more than 0.125 apart, at
  >= 2/3 of the steps (``test_torch_overlap.py``); batch 0 run freely equal
  to ``generate_stepwise``;
- the granules: the predictor's capacity, ``generate_overlapped``'s T2 and
  ``OverlapServer``'s shape rule equal to JAX's at both KV widths.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu import config as jcfg
from mmor_tpu.inference import SceneGraphPredictor as JPredictor
from mmor_tpu.models import llama as jllama
from mmor_tpu.models import mm2sg as jmm2sg
from mmor_tpu.ops import mega_decode as jmd
from mmor_tpu.ops import mega_overlap as jmo
from mmor_tpu.ops.attention import pack_kv_heads, unpack_kv_heads
from mmor_tpu_torch.cli.common import quantize_mega
from mmor_tpu_torch.inference import SceneGraphPredictor
from mmor_tpu_torch.models import llama as tllama
from mmor_tpu_torch.models import mm2sg as tmm2sg
from mmor_tpu_torch.ops import mega_decode as tmd
from mmor_tpu_torch.ops import mega_overlap as tmo
from mmor_tpu_torch.utils.convert_jax import convert_llama, mega_cache_from_jax
from test_torch_mega import (
    GROUP,
    MEGA_LLAMA,
    _mm2sg_pair,
    int4_tree,
    llama_params,
    rel_l2,
    torch_cfg,
    tt,
)
from test_torch_overlap import NEAR_TIE, _assert_columns, _batch
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

X_BOUND, KV_AGREE, PF_KV_AGREE, SCALE_BOUND = 2e-3, 0.999, 0.998, 1e-3
ORACLE_BIN_SHARE, ORACLE_REL = 0.9, 0.05
STACKS = ("k", "k_s", "v", "v_s")

j_quant_k4 = jax.jit(jmd.quantize_k_int4)
j_quant_v4 = jax.jit(jmd.quantize_v_int4)
j_unpack_k4 = jax.jit(lambda kp: jmd.unpack_k_int4(kp, 2 * kp.shape[-1]))
j_unpack_v4 = jax.jit(lambda vp: jmd.unpack_v_int4(vp, 8 * vp.shape[-2]))
j_quant_k8 = jax.jit(jllama.quantize_kv)
j_quant_v8 = jax.jit(jmd.quantize_kv_tmajor)
j_apply = jax.jit(jmd.apply_kv_update)
j_work_update = jax.jit(jmo.apply_pf_work_update)
j_flush = jax.jit(jmo.flush_pf_work)
j_handoff = jax.jit(jmo.pf_full_to_decode_cache, static_argnums=(2, 3))


def mega_cfg(base, wbits: int, kvbits: int):
    """The megakernel serving config of a float LLaMA config at these widths."""
    return dataclasses.replace(
        base, weight_quant=True, kv_quant=True, fused_qkv=True, mega_decode=True,
        weight_bits=wbits, kv_bits=kvbits, quant_int8_mxu=False,
        weight_group=GROUP if wbits == 4 else base.weight_group)


def quant_tree(lm_params, wbits: int, ffn_pad: int = 0):
    """A JAX LLaMA float tree -> its fused serving tree at ``wbits``."""
    if wbits == 4:
        return int4_tree(lm_params, GROUP, ffn_pad)
    inner = lm_params.get("params", lm_params)
    state = tllama.quantize_llama_params(tllama.fuse_llama_params(convert_llama(inner)),
                                         ffn_pad, bits=8)
    n_layers = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    split = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    blocks = {k: v for k, v in inner["blocks"].items() if k not in split}
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        blocks[name] = {leaf: np.stack([state[f"blocks.{i}.{name}.{leaf}"].numpy()
                                        for i in range(n_layers)])
                        for leaf in ("w_p", "scale")}
    head = {leaf: state[f"lm_head.{leaf}"].numpy() for leaf in ("w_p", "scale")}
    out = dict(inner, blocks=blocks, lm_head=head)
    return {"params": out} if "params" in lm_params else out


def jax_kv(rng, kvbits: int, lead: tuple, scale_axes=None):
    """Random K/V stacks (*lead, T, 128) quantized in a JAX megakernel
    layout: (k, k_s, v, v_s), scales transposed by ``scale_axes``."""
    kf = jnp.asarray(rng.standard_normal((*lead, 128)) * 0.5, jnp.float32)
    vf = jnp.asarray(rng.standard_normal((*lead, 128)) * 0.5, jnp.float32)
    if kvbits == 4:
        (kq, ks), (vq, vs) = j_quant_k4(kf), j_quant_v4(vf)
    else:
        (kq, ks), (vq, vs) = j_quant_k8(kf), j_quant_v8(vf)
    if scale_axes is not None:
        ks, vs = ks.transpose(scale_axes), vs.transpose(scale_axes)
    return kq, ks.astype(jnp.bfloat16), vq, vs.astype(jnp.bfloat16)


def port_cache(jcache: dict, kvbits: int) -> dict:
    """The port's decode cache from a JAX megakernel cache."""
    k, v = np.asarray(jcache["k"]), np.asarray(jcache["v"])
    if kvbits == 4:
        k, v = np.asarray(j_unpack_k4(jcache["k"])), np.asarray(j_unpack_v4(jcache["v"]))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return mega_cache_from_jax(k, f32(jcache["k_s"]), v, f32(jcache["v_s"]),
                               np.asarray(jcache["kv_mask"]), int(jcache["write_pos"]),
                               np.asarray(jcache["tok_pos"]), kv_bits=kvbits)


def port_work(jwork: dict, kvbits: int) -> dict:
    """The port's (L, H, T2, ...) working cache from a JAX one (scales (L, H,
    T2)), through the decode-cache converter with a batch axis of one."""
    one = dict(k=jwork["k"][:, None], v=jwork["v"][:, None],
               k_s=jwork["k_s"][:, :, None], v_s=jwork["v_s"][:, :, None],
               kv_mask=np.zeros((1, jwork["k_s"].shape[-1]), np.int32), write_pos=0,
               tok_pos=np.zeros(1, np.int32))
    return {k: v[:, 0].contiguous() for k, v in port_cache(one, kvbits).items()
            if k in STACKS}


def _case(wbits: int, kvbits: int, n_layers: int, prefix: int, seed: int):
    """(config, geometry, JAX tree, JAX cache, port cache, x, port model)
    for 8 decode rows against a 64-position cache."""
    base = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=n_layers))
    cfg = mega_cfg(base, wbits, kvbits)
    qparams = quant_tree(llama_params(base, seed, 0.02), wbits)
    geo = jmd.MegaGeometry.from_config(cfg, batch=8, t_cap=64)
    rng = np.random.default_rng(seed + 1)
    kq, ks, vq, vs = jax_kv(rng, kvbits, (n_layers, 8, 4, 64), (0, 2, 1, 3))
    mask = np.zeros((8, 64), np.int32)
    for r in range(8):
        mask[r, r:prefix] = 1  # left padding that differs by row
    jcache = dict(k=kq, k_s=ks, v=vq, v_s=vs, kv_mask=jnp.asarray(mask),
                  write_pos=jnp.asarray(prefix, jnp.int32),
                  tok_pos=jnp.asarray(prefix - np.arange(8), jnp.int32))
    x = (rng.standard_normal((8, 512)) * 0.3).astype(np.float32)
    tmodel = tllama.LlamaModel(torch_cfg(cfg))
    tmodel.load_state_dict(convert_llama(qparams))
    return cfg, geo, qparams, jcache, port_cache(jcache, kvbits), x, tmodel


def bf(a) -> torch.Tensor:
    return tt(jnp.asarray(a).astype(jnp.float32)).to(torch.bfloat16)


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ----------------------------------------------------------------- K5 plain
@pytest.mark.parametrize("wbits,kvbits", [(8, 8), (4, 8), (8, 4)])
def test_mega_decode_layers_plain_matches_reference(wbits, kvbits):
    cfg, geo, qparams, jcache, tcache, x, tmodel = _case(wbits, kvbits, 2, prefix=56,
                                                         seed=40 + 2 * wbits + kvbits)
    tapes, _ = jmd.make_mega_lm(qparams, geo)
    xb = jnp.asarray(x, jnp.bfloat16)
    cos, sin = jmd.rope_tables(jcache["tok_pos"], 128, cfg.rope_theta)
    # eager, as test_torch_mega's int4 case (jit moves the reference itself)
    ref = jmd.mega_decode_layers_reference(xb, tapes, jcache, cos, sin, geo)
    weights = tmd.MegaWeights.from_model(tmodel)
    assert (weights.wbits, weights.group) == (wbits, GROUP)
    assert tcache["k"].dtype == (torch.int8 if kvbits == 8 else torch.uint8)
    got = tmd.mega_decode_layers(bf(xb), weights, tcache, tt(cos), tt(sin))
    ref = [f32(r) for r in ref]
    got = [g.float().numpy() for g in got]
    assert rel_l2(got[0], ref[0]) <= X_BOUND
    for i in (1, 3):  # knew, vnew
        _assert_columns(got[i], ref[i], f"column {i}")
    for i in (2, 4):  # knew_s, vnew_s of the first layer
        assert rel_l2(got[i][0], ref[i][0]) <= 1e-6


# ---------------------------------------------------------------- the cache
def test_mega_cache_from_jax_int8_matches_unpack():
    """The converter's int8 case against the JAX package's own unpackers."""
    _, _, _, jcache, tcache, _, _ = _case(8, 8, 1, prefix=40, seed=50)
    np.testing.assert_array_equal(tcache["k"].numpy(),
                                  np.asarray(unpack_kv_heads(jcache["k"])))
    np.testing.assert_array_equal(tcache["v"].numpy(),
                                  np.asarray(jmd.unpack_v_tmajor(jcache["v"])))
    np.testing.assert_array_equal(tcache["k_s"].float().numpy(),
                                  f32(jcache["k_s"]).transpose(0, 2, 1, 3))
    assert tcache["k"].dtype == torch.int8 and tcache["k_s"].dtype == torch.bfloat16


def test_int8_caches_match_jax():
    """apply_kv_update's int8 column, and the prefill's int8 megakernel
    cache, equal JAX's."""
    _, _, _, jcache, tcache, _, _ = _case(8, 8, 1, prefix=40, seed=51)
    rng = np.random.default_rng(52)
    knew = rng.integers(-127, 128, (1, 8, 4, 128)).astype(np.int8)
    vnew = rng.integers(-127, 128, (1, 8, 4, 128)).astype(np.int8)
    knew_s = rng.uniform(0.001, 0.05, (1, 8, 4)).astype(np.float32)
    vnew_s = rng.uniform(0.001, 0.05, (1, 8, 4)).astype(np.float32)
    j2 = j_apply(jcache, *map(jnp.asarray, (knew, knew_s, vnew, vnew_s)))
    t2 = tmd.apply_kv_update(tcache, *map(tt, (knew, knew_s, vnew, vnew_s)))
    assert t2["write_pos"] == int(j2["write_pos"]) == 41
    want = port_cache(j2, 8)
    for name in ("k", "k_s", "v", "v_s", "kv_mask", "tok_pos"):
        np.testing.assert_array_equal(t2[name].float().numpy(), want[name].float().numpy(),
                                      err_msg=name)

    # the prefill writes the int8 capacity cache in the port's layout
    base = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=1, dtype=jnp.float32,
                                   param_dtype=jnp.float32))
    cfg = mega_cfg(base, 8, 8)
    qp = quant_tree(llama_params(base, 53, 0.02), 8)
    ids = np.random.default_rng(54).integers(3, 128, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :5] = 0
    jl, jkv = jax.jit(lambda p, i, m: jllama.LlamaModel(cfg).apply(
        p, input_ids=i, attention_mask=m, prefill_pad_to=64))(
        qp, jnp.asarray(ids), jnp.asarray(mask))
    jc = jllama.build_cache(cfg, jkv, jnp.asarray(mask), 64)
    tm = tllama.LlamaModel(torch_cfg(cfg))
    tm.load_state_dict(convert_llama(qp))
    with torch.no_grad():
        bufs = tllama.alloc_kv_buffers(tm.cfg, 2, 64, "cpu")
        tl, filled = tm(input_ids=tt(ids), attention_mask=tt(mask),
                        prefill_cache_buffers=bufs)
    tc = tllama.build_cache(tm.cfg, filled, tt(mask), 64)
    assert rel_l2(tl, jl) <= 1e-4
    want = port_cache(jc, 8)
    m = mask[None, :, None, :]
    for name in ("k", "v"):
        diff = np.abs(tc[name].numpy()[..., :12, :].astype(np.int32)
                      - want[name].numpy()[..., :12, :]) * m[..., None]
        assert diff.max() <= 1 and (diff == 0).mean() >= KV_AGREE, name
        assert rel_l2(tc[name + "_s"].float().numpy()[..., :12] * m,
                      want[name + "_s"].float().numpy()[..., :12] * m) <= 1e-3
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), np.asarray(jc["kv_mask"]))
    np.testing.assert_array_equal(tc["tok_pos"].numpy(), np.asarray(jc["tok_pos"]))


# ------------------------------------------------------------------ pf rows
def _pf_inputs(rng, c: int, t2: int, wp: int):
    """A chunk of c rows at positions [wp, wp + c) (the first 3 columns
    masked) and a random int8 working cache of T2 columns, the first wp
    visible: JAX's pf dict and the port's."""
    kq, ks, vq, vs = jax_kv(rng, 8, (2, 4, t2))
    cos, sin = jmd.rope_tables(jnp.arange(wp, wp + c), 128, 10000.0)
    x = jnp.asarray(rng.standard_normal((c, 512)) * 0.3, jnp.bfloat16)
    amask = np.ones(c, np.int32)
    amask[:3] = 0
    mask = (np.arange(t2) < wp).astype(np.int32)
    jpf = dict(x=x, cos=cos, sin=sin, amask=jnp.asarray(amask), mask=jnp.asarray(mask),
               k=kq, k_s=ks, v=vq, v_s=vs)
    tpf = dict(x=bf(x), cos=tt(cos), sin=tt(sin), amask=tt(amask), mask=tt(mask),
               **port_work(dict(k=kq, k_s=ks, v=vq, v_s=vs), 8))
    return jpf, tpf


@pytest.fixture(scope="module")
def pf_case():
    """B 8 decode rows against a 64-position int8 cache and a pf chunk of 32
    rows against a 128-column int8 working cache through two (8, 8) layers.
    For each layer alone, fed the reference's outputs of the layer before:
    the JAX reference's outputs (eager) and the port's inputs; and the
    port's inputs for both layers at once."""
    cfg, _, qparams, jcache, tcache, x, tmodel = _case(8, 8, 2, prefix=56, seed=55)
    jpf, tpf = _pf_inputs(np.random.default_rng(56), 32, 128, wp=64)
    weights = tmd.MegaWeights.from_model(tmodel)
    cos, sin = jmd.rope_tables(jcache["tok_pos"], 128, cfg.rope_theta)
    xb, xpf = jnp.asarray(x, jnp.bfloat16), jpf["x"]
    whole = ((bf(xb), weights, tcache, tt(cos), tt(sin)), tpf)
    geo = jmd.MegaGeometry.from_config(dataclasses.replace(cfg, n_layers=1), batch=8,
                                       t_cap=64, pf_chunk=32, pf_t=128)
    layers = []
    for li in range(2):
        inner = qparams["params"]
        one = {"params": dict(inner, blocks=jax.tree.map(lambda t: t[li:li + 1],
                                                          inner["blocks"]))}
        tapes, _ = jmd.make_mega_lm(one, geo)
        ref = jmd.mega_decode_layers_reference(
            xb, tapes, dict(jcache, **{k: jcache[k][li:li + 1] for k in STACKS}), cos, sin,
            geo, pf=dict(jpf, x=xpf, **{k: jpf[k][li:li + 1] for k in STACKS}))
        w1 = tmd.MegaWeights([[slot[li]] for slot in weights.layers],
                             weights.norms[li:li + 1], weights.group, weights.ffn,
                             weights.heads, weights.wbits)
        args = (bf(xb), w1, dict(tcache, **{k: tcache[k][li:li + 1] for k in STACKS}),
                tt(cos), tt(sin))
        layers.append((ref, args, dict(tpf, x=bf(xpf),
                                       **{k: tpf[k][li:li + 1] for k in STACKS})))
        xb, xpf = ref[0], ref[5]["x"]
    return layers, whole


@pytest.mark.parametrize("layer", [0, 1])
def test_pf_int8_plain_matches_reference(pf_case, layer):
    ref, args, tpf = pf_case[0][layer]
    got = tmd.mega_decode_layers(*args, pf=tpf)
    assert len(got) == 6
    assert rel_l2(got[0].float(), f32(ref[0])) <= X_BOUND
    assert rel_l2(got[5]["x"].float(), f32(ref[5]["x"])) <= X_BOUND
    for i, name in ((1, "knew"), (3, "vnew")):
        _assert_columns(got[i], ref[i], name)
        _assert_columns(got[5][name], ref[5][name], "pf " + name, PF_KV_AGREE)
        assert rel_l2(got[i + 1], f32(ref[i + 1])) <= SCALE_BOUND
        assert rel_l2(got[5][name + "_s"], f32(ref[5][name + "_s"])) <= SCALE_BOUND


def test_pf_int8_decode_rows_unaffected(pf_case):
    args, tpf = pf_case[1]
    plain = tmd.mega_decode_layers(*args)
    withpf = tmd.mega_decode_layers(*args, pf=tpf)
    for name, a, b in zip(("x", "knew", "knew_s", "vnew", "vnew_s"), plain, withpf[:5]):
        assert torch.equal(a, b), name


def _jax_full(tfull: dict) -> dict:
    """A port int8 prefill buffer (L, B, H, T2, Dh) in the JAX layout:
    D-packed keys, T-packed values, (L, H, B, T2) scales."""
    k, v = jnp.asarray(tfull["k"].numpy()), jnp.asarray(tfull["v"].numpy())
    scale = lambda s: jnp.asarray(s.float().numpy()).transpose(0, 2, 1, 3).astype(jnp.bfloat16)
    return dict(k=pack_kv_heads(k), v=jmd.pack_v_tmajor(v), k_s=scale(tfull["k_s"]),
                v_s=scale(tfull["v_s"]))


def test_pf_int8_cache_plumbing_matches_jax():
    """Chunk updates of two streams' int8 working caches, their flushes and
    the handoff into a 512-column cache whose old contents must not survive."""
    l, b, h, dh, c, t2, t_cap, p = 2, 2, 4, 128, 64, 256, 512, 200
    cfg = mega_cfg(jcfg.LlamaConfig(**MEGA_LLAMA), 8, 8)
    tcfg = torch_cfg(cfg)
    rng = np.random.default_rng(57)
    jwork, jfull = jmo.alloc_pf_work(cfg, t2), jmo.alloc_pf_full(cfg, b, t2)
    twork, tfull = tmo.alloc_pf_work(tcfg, t2, "cpu"), tmo.alloc_pf_full(tcfg, b, t2, "cpu")
    assert twork["k"].shape == (l, h, t2, dh) and twork["k"].dtype == torch.int8
    for stream in range(b):
        for wp in range(0, t2, c):
            knew, vnew = (rng.integers(-127, 128, (l, c, h, dh)).astype(np.int8)
                          for _ in range(2))
            knew_s, vnew_s = (rng.uniform(1e-3, 5e-2, (l, c, h)).astype(np.float32)
                              for _ in range(2))
            out = dict(knew=knew, knew_s=knew_s, vnew=vnew, vnew_s=vnew_s)
            jwork = j_work_update(jwork, {k: jnp.asarray(v) for k, v in out.items()},
                                  jnp.asarray(wp, jnp.int32))
            tmo.apply_pf_work_update(twork, {k: tt(v) for k, v in out.items()}, wp)
        want = port_work(jwork, 8)
        for name in STACKS:
            np.testing.assert_array_equal(twork[name].float().numpy(),
                                          want[name].float().numpy(), err_msg=name)
        jfull, jwork = j_flush(jfull, jwork, jnp.asarray(stream, jnp.int32))
        tfull, twork = tmo.flush_pf_work(tfull, twork, stream)
    fresh = tmo.alloc_pf_work(tcfg, t2, "cpu")
    assert all(torch.equal(twork[k], fresh[k]) for k in fresh)
    amask = np.ones((b, p), np.int32)
    amask[1, :7] = 0
    jc = j_handoff(jfull, jnp.asarray(amask), t_cap, t2)
    bufs = tllama.alloc_kv_buffers(tcfg, b, t_cap, "cpu")
    for name in bufs:  # a retiring batch's contents
        bufs[name].copy_(torch.from_numpy(rng.integers(-127, 128, bufs[name].shape)).to(
            bufs[name].dtype))
    tc = tmo.pf_full_to_decode_cache(tfull, tt(amask), bufs)
    want = port_cache(jc, 8)
    for name in ("k", "k_s", "v", "v_s", "kv_mask", "tok_pos"):
        np.testing.assert_array_equal(tc[name].float().numpy(), want[name].float().numpy(),
                                      err_msg=name)
    assert tc["write_pos"] == int(jc["write_pos"]) == p


def test_pf_prefill_matches_tokenwise_int8_oracle():
    """``tests/test_mega_overlap.py::test_pf_prefill_matches_tokenwise_decode_oracle``
    in the port: a left-padded prompt through the pf path at (8, 8) (4
    chunks of 64 over a 256-column int8 working cache, riding 8 decode rows)
    and the handoff, against the same prompt's real tokens one by one
    through the plain K5 path over a growing int8 cache."""
    cfg, _, _, _, tcache, _, tmodel = _case(8, 8, 2, prefix=40, seed=58)
    server = tmd.MegaServer(tmodel.cfg, tmodel)
    c, t2, t_out, pad, t_cap = 64, 256, 250, 5, 512
    nc = t2 // c
    rng = np.random.default_rng(59)
    embeds = torch.from_numpy(rng.standard_normal((t2, 512)) * 0.3).to(torch.bfloat16)
    amask = torch.zeros(t2, dtype=torch.int32)
    amask[pad:t_out] = 1
    pos = torch.clamp(torch.cumsum(amask, 0) - 1, min=0).to(torch.int32)

    step = tmo.make_overlap_step(server, 8, c, t2)
    work = tmo.alloc_pf_work(tmodel.cfg, t2, "cpu")
    full = tmo.alloc_pf_full(tmodel.cfg, 1, t2, "cpu")
    tok = torch.arange(8, dtype=torch.int32)
    for j in range(nc):
        span = slice(j * c, (j + 1) * c)
        ck = dict(x=embeds[span], pos=pos[span], amask=amask[span], stream_amask=amask,
                  wp=j * c)
        tok, tcache, work, x_pf = step(tcache, tok[:, None], work, ck)
    hidden = x_pf[t_out - 1 - (nc - 1) * c]
    full, work = tmo.flush_pf_work(full, work, 0)
    jhanded = j_handoff(_jax_full(full), jnp.asarray(amask[None, :t_out].numpy()), t_cap, t2)
    handed = tmo.pf_full_to_decode_cache(
        full, amask[None, :t_out], tllama.alloc_kv_buffers(tmodel.cfg, 1, t_cap, "cpu"))
    want = port_cache(jhanded, 8)
    for name in ("k", "k_s", "v", "v_s", "kv_mask", "tok_pos"):
        np.testing.assert_array_equal(handed[name].float().numpy(),
                                      want[name].float().numpy(), err_msg=name)
    assert handed["write_pos"] == t_out and int(handed["tok_pos"][0]) == t_out - pad

    oc = dict(tllama.alloc_kv_buffers(tmodel.cfg, 1, t_cap, "cpu"),
              kv_mask=torch.zeros(1, t_cap, dtype=torch.int32), write_pos=0,
              tok_pos=torch.zeros(1, dtype=torch.int32))
    for col in range(pad, t_out):
        cos, sin = tmd.rope_tables(oc["tok_pos"], 128, cfg.rope_theta)
        xh, *new = tmd.mega_decode_layers(embeds[col][None], server.weights, oc, cos, sin)
        oc = tmd.apply_kv_update(oc, *new)
    n = t_out - pad
    for name in ("k", "v"):
        got = handed[name][:, 0, :, pad:t_out].int()
        want = oc[name][:, 0, :, :n].int()
        assert torch.equal(got[0], want[0]), f"{name}: layer 0 not bit-exact"
        share = float(((got - want).abs() <= 1).float().mean())
        assert share > ORACLE_BIN_SHARE, (name, share)
        err = rel_l2(handed[name + "_s"][:, 0, :, pad:t_out].float(),
                     oc[name + "_s"][:, 0, :, :n].float())
        assert err < ORACLE_REL, (name + "_s", err)
    assert rel_l2(hidden.float(), xh[0].float()) < ORACLE_REL


# --------------------------------------------------------------- generation
@pytest.fixture(scope="module")
def int8_models():
    """The tiny MM2SG with a one-layer (8, 8) megakernel LLaMA of the
    geometry above (f32 elsewhere) in both packages."""
    llama = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=1, dtype=jnp.float32,
                                    param_dtype=jnp.float32, quant_int8_mxu=False))
    cfg, params, tmodel = _mm2sg_pair(llama, seed=60, std=0.05)
    lcfg = dataclasses.replace(mega_cfg(llama, 8, 8), ffn_pad=(-llama.ffn_dim) % 1024)
    qcfg = dataclasses.replace(cfg, llama=lcfg)
    qparams = {"params": dict(params["params"])}
    qparams["params"]["language_model"] = quant_tree(params["params"]["language_model"], 8,
                                                     lcfg.ffn_pad)
    tmodel = quantize_mega(tmodel, 8, 8)
    assert tmodel.cfg == torch_cfg(qcfg)
    want = convert_llama(qparams["params"]["language_model"])
    got = tmodel.language_model.state_dict()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].float().numpy(), value.float().numpy(),
                                      err_msg=key)
    return jmm2sg.MM2SG(qcfg), qparams, tmodel


def test_generate_stepwise_int8_mega_matches_jax(int8_models):
    jmodel, qparams, tmodel = int8_models
    # 20 spliced prompt tokens: the JAX prefill T-packs the values 4 a word
    batch = _batch(np.random.default_rng(61), 12)
    kw = dict(max_cache_len=128, max_new_tokens=10, eos_token_id=-1)
    jtokens, _ = jmm2sg.generate_stepwise(
        jmodel, qparams, {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    ttokens, recycled = tmm2sg.generate_stepwise(
        tmodel, {k: tt(v) for k, v in batch.items()}, **kw)
    assert recycled["k"].dtype == torch.int8 and recycled["k"].shape[3:] == (128, 128)
    np.testing.assert_array_equal(ttokens, np.asarray(jtokens))


def test_generate_overlapped_int8_matches_jax(int8_models, monkeypatch):
    """Three batches of 192-token prompts (200 after the splice: four chunks
    of 64 fill a 256-column working cache), the port teacher-forced on JAX's
    tokens (``test_torch_overlap.py::test_generate_overlapped_matches_jax``);
    run freely, batch 0 equals ``generate_stepwise``."""
    jmodel, qparams, tmodel = int8_models
    batches = [_batch(np.random.default_rng(62 + i), 192) for i in range(3)]
    kw = dict(max_cache_len=256, max_new_tokens=34, eos_token_id=-1, chunk=64)
    jbatches = [{k: jnp.asarray(v) for k, v in bt.items()} for bt in batches]
    tbatches = [{k: tt(v) for k, v in bt.items()} for bt in batches]
    jouts = [np.array(o) for o in jmm2sg.generate_overlapped(jmodel, qparams, jbatches, **kw)]

    logits = []  # every head call: 33 steps, the handoff, 33 steps, ...
    head = tmd.MegaServer.head

    def recording_head(self, x):
        out = head(self, x)
        logits.append(out.float())
        return out

    server = tmo.OverlapServer(tmodel.cfg.llama, tmodel.language_model, batch=8,
                               t_cap=256, t2=256, chunk=64)
    schedule = iter([(bi, i) for bi in range(3) for i in range(1, 34)])

    def forced(step):
        def run(cache, tok, *rest):
            bi, i = next(schedule)
            return step(cache, torch.from_numpy(jouts[bi][:, i - 1])[:, None], *rest)
        return run

    server.step_pf, server.step_plain = forced(server.step_pf), forced(server.step_plain)
    ec = dict(encode=tmm2sg.make_encode(tmodel),
              prefill=tmm2sg.make_prefill(tmodel, max_cache_len=256), server=server)
    monkeypatch.setattr(tmd.MegaServer, "head", recording_head)
    forced_outs = tmm2sg.generate_overlapped(tmodel, tbatches, engine_cache=ec, **kw)
    monkeypatch.setattr(tmd.MegaServer, "head", head)
    assert len(logits) == 3 * 33 + 2 and ec["work"]["k"].dtype == torch.int8
    np.testing.assert_array_equal(forced_outs[0][:, 0], jouts[0][:, 0])  # the prefill's
    compared = 0
    for bi in range(3):
        calls = logits[34 * bi - 1:34 * bi + 33] if bi else [None] + logits[:33]
        for i, lg in enumerate(calls):
            if lg is None:
                continue
            top = lg.topk(2, dim=-1).values
            clear = (top[:, 0] - top[:, 1] > NEAR_TIE).numpy()
            np.testing.assert_array_equal(lg.argmax(dim=-1).numpy()[clear],
                                          jouts[bi][clear, i],
                                          err_msg=f"batch {bi} token {i}")
            compared += int(clear.sum())
    assert compared >= 2 / 3 * 3 * 8 * 33, compared

    touts = tmm2sg.generate_overlapped(tmodel, tbatches[:2], **kw)
    serial, _ = tmm2sg.generate_stepwise(tmodel, tbatches[0], max_cache_len=256,
                                         max_new_tokens=34, eos_token_id=-1)
    np.testing.assert_array_equal(touts[0], serial)


# ----------------------------------------------------------------- granules
def test_mega_granules_match_jax(int8_models, monkeypatch):
    """The cache capacity granule (256 columns for an int4 KV cache, 128 for
    int8) of the predictor, ``generate_overlapped``'s working cache T2 and
    ``OverlapServer``'s shape rule, against the JAX package's, at prompt
    lengths and chunks where the two granules part."""
    jmodel, qparams, tmodel = int8_models

    class Stop(Exception):
        pass

    for kvbits in (8, 4):
        jl = dataclasses.replace(jmodel.cfg.llama, kv_bits=kvbits)
        jc = dataclasses.replace(jmodel.cfg, llama=jl, max_new_tokens=300)
        tc = torch_cfg(jc)
        for prompt in (100, 128, 230, 400):
            want = JPredictor._cache_len_for(SimpleNamespace(cfg=jc), prompt)
            got = SceneGraphPredictor._cache_len_for(SimpleNamespace(cfg=tc), prompt)
            assert got == want, (kvbits, prompt, got, want)
        # T2 of generate_overlapped: each package's server is stopped at entry
        for t_in, chunk in ((40, 32), (100, 64), (192, 64), (60, 128)):
            seen = {}

            def stop(name):
                def init(*args, t2, **kwargs):
                    seen[name] = t2
                    raise Stop
                return init

            monkeypatch.setattr(jmo.OverlapServer, "__init__", stop("jax"))
            monkeypatch.setattr(tmo.OverlapServer, "__init__", stop("port"))
            batch = _batch(np.random.default_rng(63), t_in)
            kw = dict(max_cache_len=512, max_new_tokens=300, eos_token_id=-1, chunk=chunk)
            with pytest.raises(Stop):
                jmm2sg.generate_overlapped(jmm2sg.MM2SG(jc), qparams,
                                           [{k: jnp.asarray(v) for k, v in batch.items()}],
                                           **kw)
            tmodel.cfg = tc
            try:
                with pytest.raises(Stop):
                    tmm2sg.generate_overlapped(tmodel, [{k: tt(v) for k, v in batch.items()}],
                                               **kw)
            finally:
                tmodel.cfg = torch_cfg(jmodel.cfg)
            assert seen["port"] == seen["jax"], (kvbits, t_in, chunk, seen)
            monkeypatch.undo()
        # OverlapServer's rule against MegaGeometry.validate's
        for t2, chunk in ((128, 32), (128, 128), (256, 64), (384, 128), (512, 128),
                          (640, 128), (192, 64), (96, 32), (256, 48)):
            try:
                jmd.MegaGeometry.from_config(jl, batch=8, t_cap=1024, pf_chunk=chunk,
                                             pf_t=t2)
                jax_ok = True
            except AssertionError:
                jax_ok = False
            try:
                tmo.OverlapServer(tc.llama, tmodel.language_model, batch=8, t_cap=1024,
                                  t2=t2, chunk=chunk)
                port_ok = True
            except ValueError:
                port_ok = False
            assert port_ok == jax_ok, (kvbits, t2, chunk, jax_ok)
