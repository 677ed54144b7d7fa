"""Parity of the port's int4 serving path with the JAX package on the CPU.

The megakernel cases use the JAX tests' int4 geometry
(``tests/test_mega_decode.py``): LLaMA dim 512, 4 heads of 128, ffn 1024,
batch 8, cache capacity 64, so ``pick_ck`` is 256 and the weights quantize
to int4 with 256-row groups. Weights and inputs are seeded numpy arrays
given to both packages; the port gets the JAX tree through
``utils/convert_jax.py``.

Tolerances: the JAX CPU path of K3 (f32 dequantization) rel_l2 <= 1e-5 (f32
sums in another order); the W4A8 numerics bit-exact to a numpy model of
them; K5's plain version against ``mega_decode_layers_reference``: x_out
rel_l2 <= 2e-3 (a bf16 output, and the reference folds each chunk's weight
scale into f32 weights before its sum where the port sums exact integers),
the int8 K/V columns identical in >= 99.9% of entries and never more than
1 apart (an activation rounding may flip at a half step), their scales
rel_l2 <= 1e-6 on the first layer, whose input both share; dequantized
caches identical up to such flips (rel_l2 <= 1e-3); tokens and decoded
strings identical. Prefill paths run the int4 weights with
``quant_int8_mxu=False``, the numerics of the JAX CPU path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmor_tpu import config as jcfg
from mmor_tpu.data.or_dataset import ORDataset as JORDataset
from mmor_tpu.data.synthetic import build_synthetic_dataset as j_build_synthetic
from mmor_tpu.eval.sg_eval import SceneGraphEvaluator as JEvaluator
from mmor_tpu.inference import ByteTokenizer as JByteTokenizer
from mmor_tpu.inference import SceneGraphPredictor as JPredictor
from mmor_tpu.models import llama as jllama
from mmor_tpu.models import mm2sg as jmm2sg
from mmor_tpu.ops import mega_decode as jmd
from mmor_tpu.ops import quantized_matmul as jqmm
from mmor_tpu.sg.converters import parse_sg_string as j_parse
from mmor_tpu.sg.prompts import IMAGE_TOKEN_INDEX
from mmor_tpu_torch import config as tcfg
from mmor_tpu_torch.cli.common import quantize_mega
from mmor_tpu_torch.data.or_dataset import ORDataset
from mmor_tpu_torch.data.synthetic import build_synthetic_dataset
from mmor_tpu_torch.eval.sg_eval import SceneGraphEvaluator
from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
from mmor_tpu_torch.models import llama as tllama
from mmor_tpu_torch.models import mm2sg as tmm2sg
from mmor_tpu_torch.ops import mega_decode as tmd
from mmor_tpu_torch.ops import quantized_matmul as tqmm
from mmor_tpu_torch.sg.converters import parse_sg_string
from mmor_tpu_torch.utils.convert_jax import convert_llama, convert_mm2sg, mega_cache_from_jax
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

MEGA_LLAMA = dict(vocab_size=128, dim=512, n_layers=2, n_heads=4, n_kv_heads=4,
                  ffn_dim=1024, max_seq_len=64, dtype=jnp.bfloat16,
                  param_dtype=jnp.bfloat16)
GROUP = 256


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def numpy_params(shapes, seed: int, std: float):
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


def mega_cfg(base):
    """The int4 megakernel serving config of a float LLaMA config."""
    return dataclasses.replace(
        base, weight_quant=True, kv_quant=True, fused_qkv=True, mega_decode=True,
        weight_bits=4, kv_bits=4, weight_group=GROUP, quant_int8_mxu=False)


def int4_tree(lm_params, group: int, ffn_pad: int = 0):
    """A JAX LLaMA float tree -> its int4 serving tree (fused qkv / gate_up,
    int4 blocks, int8 lm_head), quantized by the port's functions, which
    ``test_int4_packing_matches_jax`` holds bit-exact to the JAX package's
    (this skips the JAX package's slow first-call compiles)."""
    inner = lm_params.get("params", lm_params)
    state = tllama.quantize_llama_params(
        tllama.fuse_llama_params(convert_llama(inner)), ffn_pad, bits=4, group=group)
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


def llama_params(base, seed: int, std: float):
    """Random numpy leaves of a JAX LLaMA float tree."""
    shapes = jax.eval_shape(lambda: jllama.LlamaModel(base).init(
        jax.random.PRNGKey(0), input_ids=jnp.zeros((1, 4), jnp.int32),
        attention_mask=jnp.ones((1, 4), jnp.int32)))
    return numpy_params(shapes, seed, std)


def quantized_llama(base, seed: int, std: float):
    """The int4 fused params of a random LLaMA."""
    return int4_tree(llama_params(base, seed, std), GROUP)


# ------------------------------------------------------------ entry points
def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card every entry point raises at entry instead of running
    on the CPU; ``cpu`` must be asked for."""
    from mmor_tpu_torch.cli import evaluate_sg
    from mmor_tpu_torch.cli.common import build_predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.MM2SGConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcfg.example_batch(cfg, 1, 8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_predictor("tiny", ByteTokenizer(), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        SceneGraphPredictor(cfg=cfg, model=None, tokenizer=ByteTokenizer())
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_sg.main(["--synthetic", "1"])
    assert tcfg.example_batch(cfg, 1, 8, seed=0, device="cpu")["input_ids"].device.type == "cpu"


def test_tiny_preset_on_card_raises(monkeypatch):
    """The tiny preset computes in f32 (and its int4 groups are 32 rows),
    which the CUDA kernels do not take: asking for the card raises at entry."""
    from mmor_tpu_torch.cli.common import build_predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for quantize in (None, "int8", "int4"):
        with pytest.raises(ValueError, match="device='cpu'"):
            build_predictor("tiny", ByteTokenizer(), None, quantize=quantize, device="cuda")


# ------------------------------------------------------------ host copies
def test_host_copies_match_jax(tmp_path):
    text = ("<SG> head_surgeon,drilling,patient; nurse , holding, drill; "
            "anaesthetist,closeTo,head_surgeon </SG>")
    assert parse_sg_string(text) == j_parse(text)
    gt = [("head_surgeon", "patient", "drilling"), ("nurse", "drill", "holding")]
    jev, tev = JEvaluator(), SceneGraphEvaluator()
    for ev in (jev, tev):
        ev.add_sample("take_1", text, gt)
        ev.add_sample("take_2", "<SG> patient,lyingOn,operating_table </SG>", gt)
    assert tev.report() == jev.report()
    jpaths = j_build_synthetic(tmp_path / "jax", n_frames=2)
    tpaths = build_synthetic_dataset(tmp_path / "torch", n_frames=2)
    files = lambda root: sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))
    assert files(tmp_path / "torch") == files(tmp_path / "jax")
    jds = JORDataset(split="test", data_path=jpaths["data_path"],
                     mmor_root=jpaths["mmor_root"], or4d_root=jpaths["or4d_root"])
    tds = ORDataset(split="test", data_path=tpaths["data_path"],
                    mmor_root=tpaths["mmor_root"], or4d_root=tpaths["or4d_root"])
    assert len(tds) == len(jds) > 0
    assert tds[0]["sample"] == jds[0]["sample"]


# ------------------------------------------------------- K3 and its format
def test_int4_packing_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((512, 40)).astype(np.float32)
    jq, js = jqmm.quantize_weights_int4(jnp.asarray(w), group=GROUP)
    tq, ts = tqmm.quantize_weights_int4(tt(w), group=GROUP)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp = jqmm.pack_int4_rows(jq, block=GROUP)
    tp = tqmm.pack_int4_rows(tq, block=GROUP)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tqmm.unpack_int4_rows(tp, GROUP).numpy(), np.asarray(jq))

    base = jcfg.LlamaConfig.tiny(vocab_size=64, dim=256, ffn_dim=192)
    params = llama_params(base, seed=2, std=0.05)
    # eager, as serving calls it: under jit XLA turns amax / 7 into a product
    want = to_numpy(jllama.quantize_llama_params(
        jllama.fuse_llama_params(params), ffn_pad=64, bits=4, group=GROUP))
    got = int4_tree(params, GROUP, ffn_pad=64)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    assert flat(got).keys() == flat(want).keys()
    for key, value in flat(want).items():
        np.testing.assert_array_equal(flat(got)[key], value, err_msg=str(key))


def test_int4_matmul_plain_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 512)).astype(np.float32)
    wq, sc = jqmm.quantize_weights_int4(jnp.asarray(
        rng.standard_normal((512, 72)).astype(np.float32) * 0.02), group=GROUP)
    wp = jqmm.pack_int4_rows(wq, block=GROUP)
    ref = np.asarray(jqmm.int4_matmul_packed(jnp.asarray(x), wp, sc, group=GROUP))
    args = (tt(x), tt(wp), tt(sc))
    got = tqmm.int4_matmul_packed(*args, group=GROUP, int8_mxu=False)
    assert rel_l2(got, ref) <= 1e-5
    # W4A8: quantized_matmul.py:395-399 row quantization, per-group folds
    amax = np.abs(x).max(axis=1, keepdims=True)
    rs = np.where(amax > 0, amax / np.float32(127), np.float32(1)).astype(np.float32)
    xq = np.clip(np.round(x * (np.float32(1) / rs)), -127, 127)
    w = np.asarray(wq, np.float64)
    acc = np.zeros((6, 72), np.float32)
    for kk in range(512 // GROUP):
        rows = slice(kk * GROUP, (kk + 1) * GROUP)
        dot = (xq[:, rows].astype(np.float64) @ w[rows]).astype(np.float32)
        acc = acc + dot * np.asarray(sc)[kk][None, :]
    want = acc * rs
    got8 = tqmm.int4_matmul_packed(*args, group=GROUP).numpy()
    np.testing.assert_array_equal(got8, want)


# ----------------------------------------------------------------- K5 plain
unpack_k = jax.jit(lambda kp: jmd.unpack_k_int4(kp, 2 * kp.shape[-1]))
unpack_v = jax.jit(lambda vp: jmd.unpack_v_int4(vp, 8 * vp.shape[-2]))


def _mega_case(n_layers: int, prefix: int, seed: int, std: float = 0.02):
    base = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=n_layers))
    cfg = mega_cfg(base)
    qparams = quantized_llama(base, seed=seed, std=std)
    geo = jmd.MegaGeometry.from_config(cfg, batch=8, t_cap=64)
    assert geo.ck == GROUP and tcfg.pick_ck(torch_cfg(cfg)) == GROUP
    rng = np.random.default_rng(seed + 1)
    l, b, h, t, dh = n_layers, 8, 4, 64, 128
    kf = rng.standard_normal((l, b, h, t, dh)).astype(np.float32) * 0.5
    vf = rng.standard_normal((l, b, h, t, dh)).astype(np.float32) * 0.5
    kq, ks = jax.jit(jmd.quantize_k_int4)(jnp.asarray(kf))
    vq, vs = jax.jit(jmd.quantize_v_int4)(jnp.asarray(vf))
    mask = np.zeros((b, t), np.int32)
    for r in range(b):
        mask[r, r: prefix] = 1  # left padding that differs by row
    jcache = dict(k=kq, k_s=ks.transpose(0, 2, 1, 3), v=vq, v_s=vs.transpose(0, 2, 1, 3),
                  kv_mask=jnp.asarray(mask), write_pos=jnp.asarray(prefix, jnp.int32),
                  tok_pos=jnp.asarray(prefix - np.arange(b), jnp.int32))
    tcache = mega_cache_from_jax(
        np.asarray(unpack_k(kq)), np.asarray(jcache["k_s"]),
        np.asarray(unpack_v(vq)), np.asarray(jcache["v_s"]),
        mask, prefix, np.asarray(jcache["tok_pos"]))
    x = (rng.standard_normal((b, 512)) * 0.3).astype(np.float32)
    tmodel = tllama.LlamaModel(torch_cfg(cfg))
    tmodel.load_state_dict(convert_llama(qparams))
    return cfg, geo, qparams, jcache, tcache, x, tmodel


def test_mega_decode_layers_plain_matches_reference():
    cfg, geo, qparams, jcache, tcache, x, tmodel = _mega_case(2, prefix=56, seed=4)
    tapes, _ = jmd.make_mega_lm(qparams, geo)
    xb = jnp.asarray(x, jnp.bfloat16)
    cos, sin = jmd.rope_tables(jcache["tok_pos"], 128, cfg.rope_theta)
    # eager: under jit XLA's CPU fusions move x_out by ~2e-3 from the
    # reference's own eager arithmetic
    ref = jmd.mega_decode_layers_reference(xb, tapes, jcache, cos, sin, geo)
    tcos, tsin = tmd.rope_tables(tcache["tok_pos"], 128, cfg.rope_theta)
    assert rel_l2(tcos, cos) <= 1e-6 and rel_l2(tsin, sin) <= 1e-6
    tcos, tsin = tt(cos), tt(sin)  # the same tables, so the layers are compared
    got = tmd.mega_decode_layers(tt(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                                 tmd.MegaWeights.from_model(tmodel), tcache, tcos, tsin)
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    got = [g.float().numpy() for g in got]
    assert rel_l2(got[0], ref[0]) <= 2e-3
    for i in (1, 3):  # knew, vnew
        diff = np.abs(got[i] - ref[i])
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    for i in (2, 4):  # knew_s, vnew_s of the first layer
        assert rel_l2(got[i][0], ref[i][0]) <= 1e-6


def test_mega_caches_match_jax():
    """apply_kv_update's int4 column, and the prefill's int4 cache, equal
    JAX's after dequantization."""
    cfg, geo, qparams, jcache, tcache, _, _ = _mega_case(1, prefix=40, seed=5)
    rng = np.random.default_rng(6)
    knew = rng.integers(-127, 128, (1, 8, 4, 128)).astype(np.int8)
    vnew = rng.integers(-127, 128, (1, 8, 4, 128)).astype(np.int8)
    knew_s = rng.uniform(0.001, 0.05, (1, 8, 4)).astype(np.float32)
    vnew_s = rng.uniform(0.001, 0.05, (1, 8, 4)).astype(np.float32)
    j2 = jax.jit(jmd.apply_kv_update)(jcache, *map(jnp.asarray, (knew, knew_s, vnew, vnew_s)))
    t2 = tmd.apply_kv_update(tcache, *map(tt, (knew, knew_s, vnew, vnew_s)))
    assert t2["write_pos"] == int(j2["write_pos"]) == 41
    np.testing.assert_array_equal(t2["kv_mask"].numpy(), np.asarray(j2["kv_mask"]))
    np.testing.assert_array_equal(t2["tok_pos"].numpy(), np.asarray(j2["tok_pos"]))
    jk = np.asarray(unpack_k(j2["k"]), np.float32) * np.asarray(
        j2["k_s"].astype(jnp.float32)).transpose(0, 2, 1, 3)[..., None]
    jv = np.asarray(unpack_v(j2["v"]), np.float32) * np.asarray(
        j2["v_s"].astype(jnp.float32)).transpose(0, 2, 1, 3)[..., None]
    np.testing.assert_array_equal(tmd.dequantize_kv_int4(t2["k"], t2["k_s"]).numpy(), jk)
    np.testing.assert_array_equal(tmd.dequantize_kv_int4(t2["v"], t2["v_s"]).numpy(), jv)

    # the prefill writes the int4 capacity cache in the port's layout
    base = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=1, dtype=jnp.float32,
                                   param_dtype=jnp.float32))
    cfg = mega_cfg(base)
    qp = quantized_llama(base, seed=7, std=0.02)
    ids = np.random.default_rng(8).integers(3, 128, (2, 12)).astype(np.int32)
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
    m = mask[None, :, None, :, None]
    for name, unpack in (("k", unpack_k), ("v", unpack_v)):
        jd = np.asarray(unpack(jc[name]), np.float32) * np.asarray(
            jc[name + "_s"].astype(jnp.float32)).transpose(0, 2, 1, 3)[..., None]
        td = tmd.dequantize_kv_int4(tc[name], tc[name + "_s"]).numpy()
        assert rel_l2(td[..., :12, :] * m, jd[..., :12, :] * m) <= 1e-3
    np.testing.assert_array_equal(tc["kv_mask"].numpy(), np.asarray(jc["kv_mask"]))
    np.testing.assert_array_equal(tc["tok_pos"].numpy(), np.asarray(jc["tok_pos"]))


# --------------------------------------------------------------- generation
def _mm2sg_batch(rng, batch: int):
    ids = rng.integers(3, 128, (batch, 10)).astype(np.int32)
    ids[:, 3] = IMAGE_TOKEN_INDEX
    mask = np.ones((batch, 10), np.int32)
    mask[0, :2] = 0
    ids[0, :2] = 0
    return dict(input_ids=ids, attention_mask=mask,
                images=rng.standard_normal((batch, 3, 28, 28, 3)).astype(np.float32),
                view_mask=np.ones((batch, 3), np.int32),
                pc_feature=rng.standard_normal((batch, 16)).astype(np.float32),
                audio_embedding=rng.standard_normal((batch, 16)).astype(np.float32),
                segmasks=rng.integers(0, 30, (batch, 3, 32, 32)).astype(np.int32))


def _mm2sg_pair(llama, seed: int, std: float):
    """(JAX model config, JAX params, port model) of a tiny MM2SG."""
    cfg = jcfg.MM2SGConfig.tiny(llama=llama, max_new_tokens=10)
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
    params = numpy_params(shapes, seed, std)
    tmodel = tmm2sg.MM2SG(torch_cfg(cfg))
    tmodel.load_state_dict(convert_mm2sg(params))
    return cfg, params, tmodel.eval()


def _quantize_pair(cfg, params, tmodel, lcfg):
    """Both packages' MM2SG with the language model quantized to ``lcfg``
    (JAX: ``mmor_tpu/cli/common.py``'s int4 branch; the port:
    ``quantize_mega`` at int4, which must derive the same config and
    weights)."""
    qcfg = dataclasses.replace(cfg, llama=lcfg)
    qparams = {"params": dict(params["params"])}
    qparams["params"]["language_model"] = int4_tree(
        params["params"]["language_model"], lcfg.weight_group, lcfg.ffn_pad)
    tmodel = quantize_mega(tmodel, 4, 4)
    assert tmodel.cfg == torch_cfg(qcfg)
    want = convert_llama(qparams["params"]["language_model"])
    got = tmodel.language_model.state_dict()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].float().numpy(), value.float().numpy(),
                                      err_msg=key)
    return qcfg, qparams, tmodel


def _int4_llama(mode: str):
    """(float LLaMA config, its int4 serving config, weight std) of a mode;
    CPU numerics of the JAX package (quant_int8_mxu=False)."""
    if mode == "mega_int4_kv4":
        llama = jcfg.LlamaConfig(**dict(MEGA_LLAMA, n_layers=1, dtype=jnp.float32,
                                        param_dtype=jnp.float32, quant_int8_mxu=False))
        return llama, dataclasses.replace(mega_cfg(llama), ffn_pad=0), 0.05
    # the tiny preset: its K-chunk is 32, so int4 weights, int8 KV, per-op
    llama = jcfg.LlamaConfig.tiny(vocab_size=259 if mode == "predictor" else 128,
                                  quant_int8_mxu=False)
    lcfg = dataclasses.replace(
        llama, weight_quant=True, kv_quant=True, fused_qkv=True, weight_bits=4,
        weight_group=32, ffn_pad=(-llama.ffn_dim) % 1024)
    return llama, lcfg, 0.2


@pytest.mark.parametrize("mode", ["mega_int4_kv4", "per_op_int4_kv8"])
def test_generate_stepwise_int4_matches_jax(mode):
    llama, lcfg, std = _int4_llama(mode)
    cfg, params, tmodel = _mm2sg_pair(llama, seed=9, std=std)
    qcfg, qparams, tmodel = _quantize_pair(cfg, params, tmodel, lcfg)
    assert tmodel.cfg.llama.mega_decode == (mode == "mega_int4_kv4")
    batch = _mm2sg_batch(np.random.default_rng(10), 8)
    cap = 64
    jtokens, _ = jmm2sg.generate_stepwise(
        jmm2sg.MM2SG(qcfg), qparams, {k: jnp.asarray(v) for k, v in batch.items()},
        max_cache_len=cap, max_new_tokens=10, eos_token_id=-1)
    ttokens, recycled = tmm2sg.generate_stepwise(
        tmodel, {k: tt(v) for k, v in batch.items()}, max_cache_len=cap,
        max_new_tokens=10, eos_token_id=-1)
    assert recycled is not None and recycled["k"].shape[3] == cap
    np.testing.assert_array_equal(ttokens, np.asarray(jtokens))
    if tmodel.cfg.llama.mega_decode:  # a per-op step is refused, not dropped
        with pytest.raises(TypeError, match="MegaServer"):
            tmm2sg.generate_stepwise(tmodel, {k: tt(v) for k, v in batch.items()},
                                     max_cache_len=cap, max_new_tokens=10,
                                     eos_token_id=-1, step_fn=lambda cache, tok: tok)


def test_mega_eos_compaction_matches_uncompacted():
    """Ten of 16 rows emit EOS first; at the compaction boundary the live
    lanes move to the 8-row bucket, and the surviving rows' tokens equal
    the uncompacted walk's."""
    _, _, _, _, tcache, _, tmodel = _mega_case(1, prefix=24, seed=11)
    server = tmd.MegaServer(tmodel.cfg, tmodel)
    eos = 5
    logits = torch.from_numpy(
        np.random.default_rng(12).standard_normal((16, 1, 128)).astype(np.float32))
    logits[:10, 0, eos] = 50.0
    cache16 = tmd.compact_cache(tcache, torch.arange(16) % 8)

    def walk(eos_id):
        c = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in cache16.items()}
        return tmd.greedy_decode_hostloop_mega(server, logits, c, 12, eos_token_id=eos_id,
                                               compact_every=4)

    plain, _ = walk(-1)
    compact, final = walk(eos)
    assert final["kv_mask"].shape[0] == 8
    hit = plain == eos
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), 12)
    assert (first == 0).sum() == 10
    for r in range(16):
        np.testing.assert_array_equal(compact[r, :first[r]], plain[r, :first[r]])
        assert (compact[r, first[r]:] == eos).all()

    # an observing step: logits and the new K/V column, the cache untouched
    observe = tmd.make_mega_decode_step(server, 8, return_logits=True, return_kv=True,
                                        update_cache=False)
    before = tcache["k"].clone()
    tok = torch.arange(8, dtype=torch.int32)[:, None]
    nxt, logits8, (knew, knew_s, vnew, vnew_s) = observe(tcache, tok)
    np.testing.assert_array_equal(nxt.numpy(), logits8.argmax(-1).numpy())
    assert knew.shape == vnew.shape == (1, 8, 4, 128) and knew_s.shape == (1, 8, 4)
    assert torch.equal(tcache["k"], before) and tcache["write_pos"] == 24


def test_predictor_validate_int4_matches_jax(tmp_path):
    """``quantize="int4"`` at the tiny preset (the per-op int4 configuration):
    the port's and the JAX predictor decode the same strings."""
    llama, lcfg, std = _int4_llama("predictor")
    cfg, params, tmodel = _mm2sg_pair(llama, seed=13, std=std)
    qcfg, qparams, tmodel = _quantize_pair(cfg, params, tmodel, lcfg)
    paths = build_synthetic_dataset(tmp_path, n_frames=2)
    ds = ORDataset(split="test", data_path=paths["data_path"],
                   mmor_root=paths["mmor_root"], or4d_root=paths["or4d_root"])
    items = [ds[i] for i in range(len(ds))]
    jpred = JPredictor(cfg=qcfg, model=jmm2sg.MM2SG(qcfg),
                       params=jax.tree.map(jnp.asarray, qparams),
                       tokenizer=JByteTokenizer(), prompt_bucket=64)
    tpred = SceneGraphPredictor(cfg=tmodel.cfg, model=tmodel, tokenizer=ByteTokenizer(),
                                device="cpu", prompt_bucket=64)
    jreport, jraw = jpred.validate(items, batch_size=2)
    treport, traw = tpred.validate(items, batch_size=2)
    assert traw == jraw
    assert treport["macro_f1"] == jreport["macro_f1"]
