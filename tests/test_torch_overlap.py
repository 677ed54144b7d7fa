"""Parity of the port's overlapped int4 serving (K5's piggyback-prefill rows,
``ops/mega_overlap.py``, ``generate_overlapped``) with the JAX package on the
CPU, and its int4 token-by-token oracle.

The LLaMA is the JAX overlap tests' int4 geometry (``tests/test_mega_overlap.py``
``_cfg(4, 4)``): dim 512, 2 layers, 4 heads of 128, ffn 1024, so the K-chunk
and int4 group are 256. Weights and inputs are seeded numpy arrays given to
both packages; the port gets the JAX tree through ``utils/convert_jax.py``.
Each JAX function is jitted once for the module, except the pf reference,
which runs eagerly: its jitted form moves x by ~2e-3 from its own eager
arithmetic.

Tolerances:
- K5's plain version with pf rows against ``mega_decode_layers_reference``
  (B 8, c 32, T2 256, wp 64, the chunk's first 3 columns masked): the decode
  and chunk rows' x rel_l2 <= 2e-3, as for the decode rows alone
  (``tests/test_torch_mega.py``: a bf16 output, and the reference folds the
  weight scales into f32 weights where the port sums exact integers), each
  layer alone; the int8 K/V columns never more than one bin apart, the
  decode rows' equal in >= 99.9% of entries, the chunk rows' in >= 99.8%:
  an f32 tie in the RMSNorm (the reference takes the mean of squares in f32,
  the port in double) flips an activation bin about once a layer at 40
  rows (row 17 of layer 0 here: x / rs 39.499996 against the reference's
  39.5), which moves up to ~5% of that row's K/V entries (22 of its 512),
  0.13% of the chunk's; 99.8% allows one such flip a layer; their scales
  rel_l2 <= 1e-3;
- the decode rows with pf rows riding along: bit-identical to the same call
  without them (no step of the chain mixes rows);
- the cache plumbing (working-cache updates, flushes, the handoff): the
  handed cache's int4 values, scales, mask and positions equal to JAX's;
- the int4 oracle (the prompt through the pf path and the handoff, against
  the same prompt token by token through the plain K5 path, which the JAX
  package checks only at int8, ``tests/test_mega_overlap.py:197-297``):
  layer 0's K/V bit-exact (same embeddings, same quantized chain), later
  layers within one bin in > 90% of entries (the chunk attends to its own
  columns' exact int8 K/V where the oracle reads them back at int4), scales
  and the last prompt token's hidden state rel_l2 < 0.05;
- ``generate_overlapped``, teacher-forced on JAX's tokens for three batches:
  the same choice as JAX's at every step whose two best logits are more
  than 0.125 apart (twice the largest difference seen between the two
  packages' logits, from an f32 tie upstream), at >= 2/3 of the steps; run
  freely, batch 0 identical to ``generate_stepwise``; with chunks added for
  the granule, the same tokens as with one chunk.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu import config as jcfg
from mmor_tpu.models import mm2sg as jmm2sg
from mmor_tpu.ops import mega_decode as jmd
from mmor_tpu.ops import mega_overlap as jmo
from mmor_tpu.sg.prompts import IMAGE_TOKEN_INDEX
from mmor_tpu_torch.models import llama as tllama
from mmor_tpu_torch.models import mm2sg as tmm2sg
from mmor_tpu_torch.ops import mega_decode as tmd
from mmor_tpu_torch.ops import mega_overlap as tmo
from test_torch_mega import (
    MEGA_LLAMA,
    _int4_llama,
    _mega_case,
    _mm2sg_batch,
    _mm2sg_pair,
    _quantize_pair,
    mega_cfg,
    rel_l2,
    torch_cfg,
    tt,
)

X_BOUND, KV_AGREE, PF_KV_AGREE, SCALE_BOUND = 2e-3, 0.999, 0.998, 1e-3
ORACLE_BIN_SHARE, ORACLE_REL = 0.9, 0.05
NEAR_TIE = 0.125  # twice the largest logit difference seen between the packages

j_quant_k = jax.jit(jmd.quantize_k_int4)
j_quant_v = jax.jit(jmd.quantize_v_int4)
j_unpack_k = jax.jit(jmd.unpack_k_int4, static_argnums=1)
j_unpack_v = jax.jit(jmd.unpack_v_int4, static_argnums=1)
j_work_update = jax.jit(jmo.apply_pf_work_update)
j_flush = jax.jit(jmo.flush_pf_work)
j_handoff = jax.jit(jmo.pf_full_to_decode_cache, static_argnums=(2, 3))


def _pack(values) -> torch.Tensor:
    """int4 values (..., dh) -> the port's nibble pairs (..., dh/2)."""
    return tmd.pack_kv_int4(torch.from_numpy((np.asarray(values, np.int16) + 8)
                                             .astype(np.uint8)))


def _pf_inputs(rng, c: int, t2: int, wp: int):
    """A chunk of c rows at positions [wp, wp + c) (the first 3 columns
    masked) and a random working cache of T2 columns, the first wp visible:
    JAX's pf dict and the port's."""
    l, h, dh = 2, 4, 128
    kq, ks = j_quant_k(jnp.asarray(rng.standard_normal((l, h, t2, dh)) * 0.5, jnp.float32))
    vq, vs = j_quant_v(jnp.asarray(rng.standard_normal((l, h, t2, dh)) * 0.5, jnp.float32))
    cos, sin = jmd.rope_tables(jnp.arange(wp, wp + c), dh, 10000.0)
    x = jnp.asarray(rng.standard_normal((c, 512)) * 0.3, jnp.bfloat16)
    amask = np.ones(c, np.int32)
    amask[:3] = 0
    mask = (np.arange(t2) < wp).astype(np.int32)
    jpf = dict(x=x, cos=cos, sin=sin, amask=jnp.asarray(amask), mask=jnp.asarray(mask),
               k=kq, k_s=ks, v=vq, v_s=vs)
    tpf = dict(x=tt(x.astype(jnp.float32)).to(torch.bfloat16), cos=tt(cos), sin=tt(sin),
               amask=tt(amask), mask=tt(mask),
               k=_pack(j_unpack_k(kq, t2)), k_s=tt(ks.astype(jnp.float32)).to(torch.bfloat16),
               v=_pack(j_unpack_v(vq, t2)), v_s=tt(vs.astype(jnp.float32)).to(torch.bfloat16))
    return jpf, tpf


@pytest.fixture(scope="module")
def pf_case():
    """B 8 decode rows against a 64-position cache and a pf chunk of 32 rows
    through two layers. For each layer alone, fed the reference's outputs
    of the layer before: the JAX reference's outputs (eager) and the port's
    inputs; and the port's inputs for both layers at once."""
    cfg, _, qparams, jcache, tcache, x, tmodel = _mega_case(2, prefix=56, seed=21)
    jpf, tpf = _pf_inputs(np.random.default_rng(22), 32, 256, wp=64)
    weights = tmd.MegaWeights.from_model(tmodel)
    cos, sin = jmd.rope_tables(jcache["tok_pos"], 128, cfg.rope_theta)
    bf = lambda a: tt(jnp.asarray(a).astype(jnp.float32)).to(torch.bfloat16)
    xb, xpf = jnp.asarray(x, jnp.bfloat16), jpf["x"]
    whole = ((bf(xb), weights, tcache, tt(cos), tt(sin)), tpf)
    geo = jmd.MegaGeometry.from_config(dataclasses.replace(cfg, n_layers=1), batch=8,
                                       t_cap=64, pf_chunk=32, pf_t=256)
    stacks = ("k", "k_s", "v", "v_s")
    layers = []
    for li in range(2):
        inner = qparams["params"]
        one = {"params": dict(inner, blocks=jax.tree.map(lambda t: t[li:li + 1],
                                                          inner["blocks"]))}
        tapes, _ = jmd.make_mega_lm(one, geo)
        ref = jmd.mega_decode_layers_reference(
            xb, tapes, dict(jcache, **{k: jcache[k][li:li + 1] for k in stacks}), cos, sin,
            geo, pf=dict(jpf, x=xpf, **{k: jpf[k][li:li + 1] for k in stacks}))
        w1 = tmd.MegaWeights([[slot[li]] for slot in weights.layers],
                             weights.norms[li:li + 1], weights.group, weights.ffn,
                             weights.heads)
        args = (bf(xb), w1, dict(tcache, **{k: tcache[k][li:li + 1] for k in stacks}),
                tt(cos), tt(sin))
        layers.append((ref, args, dict(tpf, x=bf(xpf),
                                       **{k: tpf[k][li:li + 1] for k in stacks})))
        xb, xpf = ref[0], ref[5]["x"]
    return layers, whole


def _assert_columns(got, want, what: str, agree: float = KV_AGREE):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= agree, (what, diff.max(),
                                                             (diff == 0).mean())


@pytest.mark.parametrize("layer", [0, 1])
def test_pf_plain_matches_reference(pf_case, layer):
    """Each layer alone: whole-depth chunk rows are not held to these
    bounds, since one activation bin that flips (the reference takes the
    RMSNorm's mean of squares in f32, the port in double) moves that row's
    K/V and, through the causal block, every later row's attention (at this
    seed row 17 of layer 0: x rel_l2 3.4e-3, layer 1's K/V 94.8% equal)."""
    ref, args, tpf = pf_case[0][layer]
    got = tmd.mega_decode_layers(*args, pf=tpf)
    assert len(got) == 6
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    assert rel_l2(got[0].float(), f32(ref[0])) <= X_BOUND
    assert rel_l2(got[5]["x"].float(), f32(ref[5]["x"])) <= X_BOUND
    for i, name in ((1, "knew"), (3, "vnew")):
        _assert_columns(got[i], ref[i], name)
        _assert_columns(got[5][name], ref[5][name], "pf " + name, PF_KV_AGREE)
        assert rel_l2(got[i + 1], f32(ref[i + 1])) <= SCALE_BOUND
        assert rel_l2(got[5][name + "_s"], f32(ref[5][name + "_s"])) <= SCALE_BOUND
    assert got[5]["knew"].shape == (1, 32, 4, 128) and got[5]["x"].dtype == torch.bfloat16


def test_pf_decode_rows_unaffected(pf_case):
    args, tpf = pf_case[1]
    plain = tmd.mega_decode_layers(*args)
    withpf = tmd.mega_decode_layers(*args, pf=tpf)
    for name, a, b in zip(("x", "knew", "knew_s", "vnew", "vnew_s"), plain, withpf[:5]):
        assert torch.equal(a, b), name


def test_pf_cache_plumbing_matches_jax():
    """Chunk updates of two streams' working caches, their flushes and the
    handoff into a 512-column cache whose old contents must not survive."""
    l, b, h, dh, c, t2, t_cap, p = 2, 2, 4, 128, 64, 256, 512, 200
    cfg = mega_cfg(jcfg.LlamaConfig(**MEGA_LLAMA))
    tcfg = torch_cfg(cfg)
    rng = np.random.default_rng(23)
    jwork, jfull = jmo.alloc_pf_work(cfg, t2), jmo.alloc_pf_full(cfg, b, t2)
    twork, tfull = tmo.alloc_pf_work(tcfg, t2, "cpu"), tmo.alloc_pf_full(tcfg, b, t2, "cpu")
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
        jfull, jwork = j_flush(jfull, jwork, jnp.asarray(stream, jnp.int32))
        tfull, twork = tmo.flush_pf_work(tfull, twork, stream)
    fresh = tmo.alloc_pf_work(tcfg, t2, "cpu")
    assert all(torch.equal(twork[k], fresh[k]) for k in fresh)
    amask = np.ones((b, p), np.int32)
    amask[1, :7] = 0
    jc = j_handoff(jfull, jnp.asarray(amask), t_cap, t2)
    bufs = tllama.alloc_kv_buffers(tcfg, b, t_cap, "cpu")
    for name in bufs:  # a retiring batch's contents
        bufs[name].copy_(torch.from_numpy(rng.integers(0, 256, bufs[name].shape)).to(
            bufs[name].dtype))
    tc = tmo.pf_full_to_decode_cache(tfull, tt(amask), bufs)
    for name, unpack in (("k", j_unpack_k), ("v", j_unpack_v)):
        np.testing.assert_array_equal(tmd.unpack_kv_int4(tc[name]).numpy(),
                                      np.asarray(unpack(jc[name], t_cap)), err_msg=name)
        np.testing.assert_array_equal(
            tc[name + "_s"].float().numpy(),
            np.asarray(jc[name + "_s"].astype(jnp.float32)).transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), np.asarray(jc["kv_mask"]))
    np.testing.assert_array_equal(tc["tok_pos"].numpy(), np.asarray(jc["tok_pos"]))
    assert tc["write_pos"] == int(jc["write_pos"]) == p


def test_pf_prefill_matches_tokenwise_int4_oracle():
    """A left-padded prompt through the pf path (4 chunks of 64 over a
    256-column working cache, riding a batch of 8 decode rows) and the
    handoff, against the same prompt's real tokens one by one through the
    plain K5 path over a growing int4 cache."""
    _, _, _, _, tcache, _, tmodel = _mega_case(2, prefix=40, seed=24)
    server = tmd.MegaServer(tmodel.cfg, tmodel)
    c, t2, t_out, pad, t_cap = 64, 256, 250, 5, 512
    nc = t2 // c
    rng = np.random.default_rng(25)
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
    # an observing step: logits and the K/V columns, the state untouched
    observe = tmo.make_overlap_step(server, 8, c, t2, return_logits=True, return_kv=True,
                                    update_state=False)
    before = (tcache["k"].clone(), work["k"].clone(), tcache["write_pos"])
    nxt, x_obs, logits, dec_kv, pf_kv = observe(tcache, tok[:, None], work, ck)
    np.testing.assert_array_equal(nxt.numpy(), logits.argmax(-1).numpy())
    assert x_obs.shape == (c, 512) and logits.shape == (8, 128)
    assert dec_kv[0].shape == (2, 8, 4, 128) and pf_kv["knew"].shape == (2, c, 4, 128)
    assert torch.equal(tcache["k"], before[0]) and torch.equal(work["k"], before[1])
    assert tcache["write_pos"] == before[2]
    full, work = tmo.flush_pf_work(full, work, 0)
    handed = tmo.pf_full_to_decode_cache(
        full, amask[None, :t_out], tllama.alloc_kv_buffers(tmodel.cfg, 1, t_cap, "cpu"))
    assert handed["write_pos"] == t_out and int(handed["tok_pos"][0]) == t_out - pad

    # the oracle: the real tokens one by one at positions 0, 1, ...
    oc = dict(tllama.alloc_kv_buffers(tmodel.cfg, 1, t_cap, "cpu"),
              kv_mask=torch.zeros(1, t_cap, dtype=torch.int32), write_pos=0,
              tok_pos=torch.zeros(1, dtype=torch.int32))
    for col in range(pad, t_out):
        cos, sin = tmd.rope_tables(oc["tok_pos"], 128, tmodel.cfg.rope_theta)
        xh, *new = tmd.mega_decode_layers(embeds[col][None], server.weights, oc, cos, sin)
        oc = tmd.apply_kv_update(oc, *new)
    n = t_out - pad
    for name in ("k", "v"):
        got = tmd.unpack_kv_int4(handed[name][:, 0, :, pad:t_out]).int()
        want = tmd.unpack_kv_int4(oc[name][:, 0, :, :n]).int()
        assert torch.equal(got[0], want[0]), f"{name}: layer 0 not bit-exact"
        share = float(((got - want).abs() <= 1).float().mean())
        assert share > ORACLE_BIN_SHARE, (name, share)
        err = rel_l2(handed[name + "_s"][:, 0, :, pad:t_out].float(),
                     oc[name + "_s"][:, 0, :, :n].float())
        assert err < ORACLE_REL, (name + "_s", err)
    assert rel_l2(hidden.float(), xh[0].float()) < ORACLE_REL


def _batch(rng, t_in: int):
    """``test_torch_mega._mm2sg_batch`` with a prompt of ``t_in`` tokens."""
    batch = _mm2sg_batch(rng, 8)
    ids = rng.integers(3, 128, (8, t_in)).astype(np.int32)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    ids[0, :2] = 0
    mask = np.ones((8, t_in), np.int32)
    mask[0, :2] = 0
    return dict(batch, input_ids=ids, attention_mask=mask)


@pytest.fixture(scope="module")
def overlap_models():
    """The tiny int4 megakernel MM2SG (one LLaMA layer of the geometry
    above, f32 elsewhere) in both packages."""
    llama, lcfg, std = _int4_llama("mega_int4_kv4")
    cfg, params, tmodel = _mm2sg_pair(llama, seed=26, std=std)
    qcfg, qparams, tmodel = _quantize_pair(cfg, params, tmodel, lcfg)
    return jmm2sg.MM2SG(qcfg), qparams, tmodel


def test_generate_overlapped_matches_jax(overlap_models, monkeypatch):
    """Three batches of 192-token prompts (200 after the splice: four chunks
    of 64 fill the 256-column working cache, so the JAX package's choice of
    the last prompt token's row holds).

    The port runs teacher-forced on JAX's tokens (each step is fed JAX's
    token before it), so one step's outcome cannot change the next; its
    choice must equal JAX's at every step whose two best logits (bf16, as K2
    returns them) are more than NEAR_TIE apart. The packages' logits are
    equal except where an f32 tie upstream (an RMSNorm, or a prompt
    embedding's bf16 rounding) put one int4 cache entry a bin apart, which
    moved a logit by up to 0.0625 at this seed; within that margin either
    token may win. Run freely, batch 0 equals ``generate_stepwise`` and a
    second call through ``engine_cache`` repeats every token."""
    jmodel, qparams, tmodel = overlap_models
    batches = [_batch(np.random.default_rng(27 + i), 192) for i in range(3)]
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
    assert len(logits) == 3 * 33 + 2
    np.testing.assert_array_equal(forced_outs[0][:, 0], jouts[0][:, 0])  # the prefill's
    compared = 0
    for bi in range(3):
        # the logits that chose token i of batch bi (batch 0's token 0: the prefill)
        calls = logits[34 * bi - 1:34 * bi + 33] if bi else [None] + logits[:33]
        for i, lg in enumerate(calls):
            if lg is None:
                continue
            top = lg.topk(2, dim=-1).values
            clear = (top[:, 0] - top[:, 1] > NEAR_TIE).numpy()
            got = lg.argmax(dim=-1).numpy()
            np.testing.assert_array_equal(got[clear], jouts[bi][clear, i],
                                          err_msg=f"batch {bi} token {i}")
            compared += int(clear.sum())
    assert compared >= 2 / 3 * 3 * 8 * 33, compared  # 579 of 792 at this seed

    ec = {}
    touts = tmm2sg.generate_overlapped(tmodel, tbatches, engine_cache=ec, **kw)
    assert len(touts) == 3 and all(t.shape == (8, 34) for t in touts)
    serial, _ = tmm2sg.generate_stepwise(tmodel, tbatches[0], max_cache_len=256,
                                         max_new_tokens=34, eos_token_id=-1)
    np.testing.assert_array_equal(touts[0], serial)
    server = ec["server"]
    again = tmm2sg.generate_overlapped(tmodel, tbatches, engine_cache=ec, **kw)
    assert ec["server"] is server
    for t, a in zip(touts, again):
        np.testing.assert_array_equal(t, a)


def test_generate_overlapped_hands_off_the_last_prompt_token(overlap_models):
    """An 18-token spliced prompt: in chunks of 64 its last token sits in
    chunk 0 of four (three added for the 256-column granule); in one chunk of
    256 no chunk is added. The real rows see the same columns either way, so
    both runs hand off the same hidden states and give the same tokens."""
    _, _, tmodel = overlap_models
    batches = [{k: tt(v) for k, v in _batch(np.random.default_rng(30 + i), 10).items()}
               for i in range(2)]
    kw = dict(max_cache_len=256, max_new_tokens=34, eos_token_id=-1)
    chunked = tmm2sg.generate_overlapped(tmodel, batches, chunk=64, **kw)
    whole = tmm2sg.generate_overlapped(tmodel, batches, chunk=256, **kw)
    for a, b in zip(chunked, whole):
        np.testing.assert_array_equal(a, b)


def test_generate_overlapped_too_few_steps_matches_jax(overlap_models):
    jmodel, qparams, tmodel = overlap_models
    batches = [_batch(np.random.default_rng(27 + i), 192) for i in range(2)]
    kw = dict(max_cache_len=256, max_new_tokens=10, eos_token_id=-1, chunk=64)
    with pytest.raises(ValueError) as jerr:
        jmm2sg.generate_overlapped(jmodel, qparams,
                                   [{k: jnp.asarray(v) for k, v in bt.items()}
                                    for bt in batches], **kw)
    with pytest.raises(ValueError) as terr:
        tmm2sg.generate_overlapped(tmodel, [{k: tt(v) for k, v in bt.items()}
                                            for bt in batches], **kw)
    assert str(terr.value) == str(jerr.value)
