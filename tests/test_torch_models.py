"""Parity of the PyTorch port's models with the JAX package at tiny sizes.

Weights are made once with numpy (shapes from ``jax.eval_shape`` of the
flax init), handed to the JAX modules as they are and to the port through
``mmor_tpu_torch.utils.convert_jax``; inputs are seeded numpy arrays.

Tolerances: f32 modules rel_l2 <= 1e-5; logits rel_l2 <= 1e-4; greedy
tokens and decoded strings identical. Quantized paths run the int8 weights
with ``quant_int8_mxu=False``, the numerics of the JAX CPU path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu import config as jcfg
from mmor_tpu.data.or_dataset import ORDataset
from mmor_tpu.data.synthetic import build_synthetic_dataset
from mmor_tpu.inference import ByteTokenizer as JByteTokenizer
from mmor_tpu.inference import SceneGraphPredictor as JPredictor
from mmor_tpu.models import llama as jllama
from mmor_tpu.models import mm2sg as jmm2sg
from mmor_tpu.ops.attention import unpack_kv_heads
from mmor_tpu.sg.prompts import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from mmor_tpu_torch import config as tcfg
from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
from mmor_tpu_torch.models import llama as tllama
from mmor_tpu_torch.models import mm2sg as tmm2sg
from mmor_tpu_torch.utils.convert_jax import convert_llama, convert_mm2sg
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

F32_TOL = 1e-5
LOGIT_TOL = 1e-4


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def numpy_params(shapes, seed: int, std: float = 0.2):
    """Random numpy leaves for an eval_shape tree: norm scales 1 + noise,
    biases and everything else N(0, std) (wide enough that greedy argmax
    has no near-ties)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        return (std * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def torch_cfg(cfg):
    """The port's config with the same field values as a JAX config."""
    fields = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            val = torch_cfg(val)
        elif f.name in ("dtype", "param_dtype"):
            val = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[val]
        fields[f.name] = val
    return getattr(tcfg, type(cfg).__name__)(**fields)


def tt(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- LLaMA
def _llama_case(quant, fused: bool):
    """``quant``: False, True (int8 weights and KV at quant_int8_mxu=False)
    or "len1" (the same with a third row holding one valid token, the
    shortest row the decode attention's kernel sees)."""
    base = jcfg.LlamaConfig.tiny(vocab_size=128)
    rows = 3 if quant == "len1" else 2
    ids = np.random.default_rng(10).integers(3, 128, (rows, 12)).astype(np.int32)
    mask = np.ones((rows, 12), np.int32)
    mask[1, :4] = 0  # left padding: RoPE positions differ from cache slots
    mask[2:, :11] = 0
    shapes = jax.eval_shape(lambda: jllama.LlamaModel(base).init(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask)))
    params = numpy_params(shapes, seed=11)
    cfg = dataclasses.replace(base, fused_qkv=fused)
    if fused:
        params = to_numpy(jllama.fuse_llama_params(params))
    if quant:
        cfg = dataclasses.replace(cfg, weight_quant=True, kv_quant=True,
                                  quant_int8_mxu=False, ffn_pad=32)
        params = to_numpy(jllama.quantize_llama_params(params, ffn_pad=32))
    return cfg, params, ids, mask


@pytest.mark.parametrize("quant", [False, True, "len1"], ids=["bf", "int8", "int8_len1"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
def test_llama_prefill_and_decode_match_jax(quant, fused):
    cfg, params, ids, mask = _llama_case(quant, fused)
    cap, steps = 32, 8
    jmodel = jllama.LlamaModel(cfg)
    jlogits, jkv = jmodel.apply(params, input_ids=jnp.asarray(ids),
                                attention_mask=jnp.asarray(mask),
                                prefill_pad_to=cap if quant else None)
    jcache = jllama.build_cache(cfg, jkv, jnp.asarray(mask), cap)
    jk_prompt = to_numpy({k: jcache[k] for k in ("k", "k_s") if k in jcache})
    jtokens, _ = jllama.greedy_decode_hostloop(jmodel, params, jlogits, jcache,
                                               steps, eos_token_id=-1)

    tmodel = tllama.LlamaModel(torch_cfg(cfg))
    tmodel.load_state_dict(convert_llama(params))
    with torch.no_grad():
        bufs = tllama.alloc_kv_buffers(tmodel.cfg, len(ids), cap, "cpu")
        tlogits, filled = tmodel(input_ids=tt(ids), attention_mask=tt(mask),
                                 prefill_cache_buffers=bufs)
        tcache = tllama.build_cache(tmodel.cfg, filled, tt(mask), cap)
        ttokens, _ = tllama.greedy_decode_hostloop(tmodel, tlogits, tcache, steps,
                                                   eos_token_id=-1)
    assert rel_l2(tlogits, jlogits) <= LOGIT_TOL
    m = mask[None, :, None, :, None]  # the prompt's valid cache slots
    if quant:
        def deq(q, s):
            return np.asarray(q, np.float32) * np.asarray(s, np.float32)[..., None]
        jk = deq(unpack_kv_heads(jk_prompt["k"]), jk_prompt["k_s"])[:, :, :, :12]
        tk = deq(filled["k"].numpy(), filled["k_s"].float().numpy())[:, :, :, :12]
        # an int8 rounding may flip at a half step between the frameworks
        assert rel_l2(tk * m, jk * m) <= 1e-3
    else:
        jk = jk_prompt["k"][:, :, :, :12]
        assert rel_l2(filled["k"][:, :, :, :12].numpy() * m, jk * m) <= F32_TOL
    np.testing.assert_array_equal(ttokens, np.asarray(jtokens))


# ----------------------------------------------------------- MM2SG pieces
@pytest.fixture(scope="module")
def mm2sg_pair():
    """(JAX model, numpy params, port model) at the tiny config."""
    cfg = jcfg.MM2SGConfig.tiny(llama=jcfg.LlamaConfig.tiny(vocab_size=259),
                                max_new_tokens=8)
    jmodel = jmm2sg.MM2SG(cfg)
    b, v, s = 1, cfg.pooler.max_views, cfg.vision.image_size
    ids = jnp.full((b, 8), 3, jnp.int32).at[0, 2].set(IMAGE_TOKEN_INDEX)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), ids, jnp.ones((b, 8), jnp.int32),
        jnp.zeros((b, v, s, s, 3)), jnp.ones((b, v), jnp.int32),
        audio_embedding=jnp.zeros((b, cfg.pooler.audio_dim)),
        segmasks=jnp.zeros((b, 3, 32, 32), jnp.int32),
        pc_points=jnp.zeros((b, cfg.ptv3.max_points, 6)),
        pc_valid=jnp.ones((b, cfg.ptv3.max_points), bool)))
    params = numpy_params(shapes, seed=12)
    tmodel = tmm2sg.MM2SG(torch_cfg(cfg))
    tmodel.load_state_dict(convert_mm2sg(params))
    return jmodel, params, tmodel.eval()


def _apply(jmodel, params, fn, *args):
    run = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=fn))
    return np.asarray(run(params, *[jnp.asarray(a) for a in args]))


def test_vision_tower_matches_jax(mm2sg_pair):
    jmodel, params, tmodel = mm2sg_pair
    px = np.random.default_rng(13).standard_normal((3, 28, 28, 3)).astype(np.float32)
    ref = _apply(jmodel, params, lambda m, x: m.vision_tower(x), px)
    with torch.no_grad():
        out = tmodel.vision_tower(tt(px))
    assert out.shape == ref.shape == (3, 4, 32)
    assert rel_l2(out, ref) <= F32_TOL


def test_pooler_segmask_projector_match_jax(mm2sg_pair):
    jmodel, params, tmodel = mm2sg_pair
    rng = np.random.default_rng(14)
    tokens = rng.standard_normal((2, 12, 32)).astype(np.float32)
    token_mask = np.ones((2, 12), np.int32)
    token_mask[1, 8:] = 0  # third view absent
    pc = rng.standard_normal((2, 16)).astype(np.float32)
    audio = rng.standard_normal((2, 16)).astype(np.float32)
    masks = rng.integers(0, 30, (4, 32, 32)).astype(np.int32)
    seg_ref = _apply(jmodel, params, lambda m, x: m.segmask_encoder(x), masks)
    seg_feat = seg_ref.reshape(2, 2, -1)[:, :1].repeat(3, axis=1)
    pool_ref = _apply(jmodel, params,
                      lambda m, *a: m.image_pooler(a[0], a[1], pc_feature=a[2],
                                                   audio_embedding=a[3],
                                                   segmask_features=a[4]),
                      tokens, token_mask, pc, audio, seg_feat)
    proj_ref = _apply(jmodel, params, lambda m, x: m.mm_projector(x), pool_ref)
    with torch.no_grad():
        seg_out = tmodel.segmask_encoder(tt(masks))
        pool_out = tmodel.image_pooler(tt(tokens), tt(token_mask), pc_feature=tt(pc),
                                       audio_embedding=tt(audio),
                                       segmask_features=tt(seg_feat))
        proj_out = tmodel.mm_projector(tt(pool_ref))
    assert rel_l2(seg_out, seg_ref) <= F32_TOL
    assert pool_out.shape == pool_ref.shape == (2, 4 + 2 + 3, 32)
    assert rel_l2(pool_out, pool_ref) <= F32_TOL
    assert rel_l2(proj_out, proj_ref) <= F32_TOL


def test_point_encoder_matches_jax(mm2sg_pair):
    jmodel, params, tmodel = mm2sg_pair
    rng = np.random.default_rng(15)
    pts = np.zeros((3, 256, 6), np.float32)
    valid = np.zeros((3, 256), bool)
    for b, n in enumerate((200, 37)):  # the third cloud is empty
        pts[b, :n, :3] = rng.uniform(0, 0.4, (n, 3))
        pts[b, :n, 3:] = rng.uniform(0, 1, (n, 3))
        valid[b, :n] = True
    ref = _apply(jmodel, params, lambda m, p, v: m.encode_pc(p, v), pts, valid)
    with torch.no_grad():
        out = tmodel.encode_pc(tt(pts), tt(valid))
    assert out.shape == ref.shape == (3, 16)
    assert not out[2].any()
    assert rel_l2(out, ref) <= F32_TOL


def test_splice_multimodal_matches_jax():
    rng = np.random.default_rng(16)
    emb = rng.standard_normal((3, 10, 8)).astype(np.float32)
    mm = rng.standard_normal((3, 5, 8)).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, :2] = 0
    labels = rng.integers(0, 50, (3, 10)).astype(np.int32)
    j_e, j_m, j_l = jmm2sg.splice_multimodal(*map(jnp.asarray, (emb, pos, mm, mask, labels)))
    t_e, t_m, t_l = tmm2sg.splice_multimodal(*map(tt, (emb, pos, mm, mask, labels)))
    assert t_e.shape == (3, 14, 8)
    np.testing.assert_array_equal(t_e.numpy(), np.asarray(j_e))
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(t_l.numpy(), np.asarray(j_l))
    assert (t_l.numpy() == IGNORE_INDEX).sum() == 3 * 5
    ids = rng.integers(3, 50, (3, 10)).astype(np.int32)
    ids[np.arange(3), pos] = IMAGE_TOKEN_INDEX
    np.testing.assert_array_equal(tmm2sg.find_sentinel(tt(ids)).numpy(), pos)


def test_generate_stepwise_int8_matches_jax(mm2sg_pair):
    """MM2SG prefill + int8-weight, int8-KV greedy decode: same tokens."""
    jmodel, params, _ = mm2sg_pair
    cfg = jmodel.cfg
    qcfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, weight_quant=True, kv_quant=True, quant_int8_mxu=False,
        ffn_pad=(-cfg.llama.ffn_dim) % 1024))
    qparams = {"params": dict(params["params"])}
    qparams["params"]["language_model"] = to_numpy(jllama.quantize_llama_params(
        params["params"]["language_model"], ffn_pad=qcfg.llama.ffn_pad))
    rng = np.random.default_rng(17)
    ids = rng.integers(3, 259, (2, 10)).astype(np.int32)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    mask = np.ones((2, 10), np.int32)
    mask[0, :2] = 0
    ids[0, :2] = 0
    batch = dict(input_ids=ids, attention_mask=mask,
                 images=rng.standard_normal((2, 3, 28, 28, 3)).astype(np.float32),
                 view_mask=np.array([[1, 1, 0], [1, 1, 1]], np.int32),
                 pc_feature=rng.standard_normal((2, 16)).astype(np.float32),
                 audio_embedding=rng.standard_normal((2, 16)).astype(np.float32),
                 segmasks=rng.integers(0, 30, (2, 3, 32, 32)).astype(np.int32))
    cap = 32
    jtokens, _ = jmm2sg.generate_stepwise(
        jmm2sg.MM2SG(qcfg), qparams, {k: jnp.asarray(v) for k, v in batch.items()},
        max_cache_len=cap, max_new_tokens=8, eos_token_id=-1)
    tmodel = tmm2sg.MM2SG(torch_cfg(qcfg))
    tmodel.load_state_dict(convert_mm2sg(qparams))
    ttokens, recycled = tmm2sg.generate_stepwise(
        tmodel.eval(), {k: tt(v) for k, v in batch.items()}, max_cache_len=cap,
        max_new_tokens=8, eos_token_id=-1)
    assert recycled["k"].dtype == torch.int8 and recycled["k"].shape[3] == cap
    np.testing.assert_array_equal(ttokens, np.asarray(jtokens))


def test_byte_tokenizer_matches_jax():
    """Same ids and text as the JAX tokenizer; ids that stand for no byte
    (a 32000-token model can emit them) are skipped where JAX raises."""
    text = "<SG> head_surgeon,drilling,patient </SG> é"
    ids = ByteTokenizer().encode(text)
    assert ids == JByteTokenizer().encode(text)
    assert ByteTokenizer().decode(ids) == JByteTokenizer().decode(ids) == text
    assert ByteTokenizer().decode(ids[:4] + [259, 31999] + ids[4:]) == text


def test_predictor_validate_matches_jax(mm2sg_pair, tmp_path):
    """Synthetic dataset -> both predictors (raw JPEG views, raw point
    clouds through PTv3): identical decoded strings and reports."""
    jmodel, params, tmodel = mm2sg_pair
    paths = build_synthetic_dataset(tmp_path, n_frames=2)
    ds = ORDataset(split="test", data_path=paths["data_path"],
                   mmor_root=paths["mmor_root"], or4d_root=paths["or4d_root"])
    items = [ds[i] for i in range(len(ds))]
    jpred = JPredictor(cfg=jmodel.cfg, model=jmodel,
                       params=jax.tree.map(jnp.asarray, params),
                       tokenizer=JByteTokenizer(), prompt_bucket=64)
    tpred = SceneGraphPredictor(cfg=tmodel.cfg, model=tmodel, tokenizer=ByteTokenizer(),
                                device="cpu", prompt_bucket=64)
    chunks = [items[:2], items[2:]]
    jbatch = jpred.build_batch(chunks[0])
    assert "pc_points" in jbatch  # the MM-OR item carries a raw cloud
    for chunk in chunks:
        expect = jpred._decode_outputs(jpred.build_batch(chunk))
        got = tpred.predict(chunk)
        assert got == expect
        assert any(expect)  # non-empty generations
    jreport, jraw = jpred.validate(items, batch_size=2)
    treport, traw = tpred.validate(items, batch_size=2)
    assert traw == jraw
    assert treport["macro_f1"] == jreport["macro_f1"]
