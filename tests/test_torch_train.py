"""Parity of the port's MM2SG LoRA training with the JAX package's, on the CPU.

The tiny preset in f32: weights and inputs from a numpy seed, handed to the
JAX modules as they are and to the port through ``utils/convert_jax.py``
(``convert_mm2sg`` for parameters and their gradients, ``convert_lora`` for
the LoRA factors and theirs). The JAX steps are JAX's own
``make_lora_train_step`` and ``train_step``, jitted, with an optax stage in
front of the optimizer that keeps each step's raw gradients in the
optimizer state.

Tolerances: K1's gradient and the loss rel <= 1e-5; effective weights after
``apply_lora`` rel_l2 <= 1e-6 per tensor; gradients and parameters after
optimizer steps rel_l2 <= 1e-4 over each group (the LoRA a factors, the b
factors, and each trained module; f32 sums in another order); the schedule
within 1e-6 of its peak; data batches, samples and checkpoints exactly
equal.
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmor_tpu import config as jcfg
from mmor_tpu.data import llava_json as jllava
from mmor_tpu.data import sg_train_data as jsgd
from mmor_tpu.data.or_dataset import ORDataset as JORDataset
from mmor_tpu.data.synthetic import build_synthetic_dataset
from mmor_tpu.inference import ByteTokenizer as JByteTokenizer
from mmor_tpu.models import mm2sg as jmm2sg
from mmor_tpu.ops import attention as jattn
from mmor_tpu.sg.prompts import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from mmor_tpu.train import losses as jlosses
from mmor_tpu.train import lora as jlora
from mmor_tpu.train import trainer as jtr
from mmor_tpu_torch.cli import train_mm2sg
from mmor_tpu_torch.data import llava_json as tllava
from mmor_tpu_torch.data import sg_train_data as tsgd
from mmor_tpu_torch.data.or_dataset import ORDataset
from mmor_tpu_torch.inference import ByteTokenizer
from mmor_tpu_torch.models.mm2sg import MM2SG
from mmor_tpu_torch.ops import attention as A
from mmor_tpu_torch.train import lora as tlora
from mmor_tpu_torch.train import losses as tlosses
from mmor_tpu_torch.train import trainer as ttr
from mmor_tpu_torch.utils import checkpoint as ckpt
from mmor_tpu_torch.utils.convert_jax import convert_lora, convert_mm2sg
from test_torch_models import numpy_params, rel_l2, torch_cfg, tt
from torch_threads import share_cores

share_cores()  # parallel test workers oversubscribe the cores

TOL, GRAD_TOL = 1e-5, 1e-4
RANK, ALPHA = 4, 8.0


def jax_cfg():
    return jcfg.MM2SGConfig.tiny(llama=jcfg.LlamaConfig.tiny(vocab_size=259))


def jax_params(cfg, seed: int):
    model = jmm2sg.MM2SG(cfg)
    b, v, s = 1, cfg.pooler.max_views, cfg.vision.image_size
    ids = jnp.full((b, 8), 3, jnp.int32).at[0, 2].set(IMAGE_TOKEN_INDEX)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), ids, jnp.ones((b, 8), jnp.int32),
        jnp.zeros((b, v, s, s, 3)), jnp.ones((b, v), jnp.int32),
        audio_embedding=jnp.zeros((b, cfg.pooler.audio_dim)),
        segmasks=jnp.zeros((b, 3, 32, 32), jnp.int32),
        pc_points=jnp.zeros((b, cfg.ptv3.max_points, 6)),
        pc_valid=jnp.ones((b, cfg.ptv3.max_points), bool)))
    return model, numpy_params(shapes, seed=seed, std=0.1)


def train_batch(seed: int = 30):
    """Two rows (the first left-padded), a view absent, point clouds through
    PTv3, audio and segmasks; the prompt's labels ignored."""
    rng = np.random.default_rng(seed)
    b, t = 2, 24
    ids = rng.integers(3, 259, (b, t)).astype(np.int32)
    ids[:, 5] = IMAGE_TOKEN_INDEX
    mask = np.ones((b, t), np.int32)
    mask[0, :3] = 0
    ids[0, :3] = 0
    labels = np.where((np.arange(t)[None] > 12) & (mask == 1), ids, IGNORE_INDEX)
    pts = np.zeros((b, 256, 6), np.float32)
    valid = np.zeros((b, 256), bool)
    for r, n in enumerate((90, 40)):
        pts[r, :n, :3] = rng.uniform(0, 0.4, (n, 3))
        pts[r, :n, 3:] = rng.uniform(0, 1, (n, 3))
        valid[r, :n] = True
    return dict(input_ids=ids, attention_mask=mask, labels=labels.astype(np.int32),
                images=rng.standard_normal((b, 3, 28, 28, 3)).astype(np.float32),
                view_mask=np.array([[1, 1, 0], [1, 1, 1]], np.int32),
                audio_embedding=rng.standard_normal((b, 16)).astype(np.float32),
                segmasks=rng.integers(0, 30, (b, 3, 32, 32)).astype(np.int32),
                pc_points=pts, pc_valid=valid)


def grad_recorder():
    """An optax stage that passes the gradients on and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def port_model(cfg, params):
    model = MM2SG(torch_cfg(cfg))
    model.load_state_dict(convert_mm2sg(params))
    return model


def port_trainable(jax_tree: dict) -> dict:
    """A JAX step's flat ``trainable`` dict (or its gradient) by port name."""
    return convert_mm2sg({k.removeprefix("params/"): np.asarray(v) for k, v in jax_tree.items()})


def set_port_lora(state, jax_lora) -> None:
    with torch.no_grad():
        for name, ab in convert_lora(jax_lora).items():
            for k, t in ab.items():
                state["lora"][name][k].copy_(t)


def group_of(name: str) -> str:
    """The group a flat optimizer name is compared in: the LoRA a or b
    factors, or a trainable module's parameters."""
    if name.startswith("lora/"):
        return "lora_" + name.rsplit("/", 1)[-1]
    return name.removeprefix("trainable/").split(".")[0]


def assert_groups_match(got: dict, want: dict, what: str) -> None:
    """rel_l2 <= GRAD_TOL over each group's tensors taken together (a
    tensor whose gradient is zero but for rounding, as the attention key
    biases', carries that rounding into its own rel_l2 but not into its
    group's)."""
    assert set(got) == set(want), what
    groups: dict = {}
    for name in want:
        g = groups.setdefault(group_of(name), [0.0, 0.0])
        a, b = got[name].detach().double(), torch.as_tensor(np.asarray(want[name])).double()
        g[0] += float(((a - b) ** 2).sum())
        g[1] += float((b ** 2).sum())
    for group, (diff, ref) in groups.items():
        err = (diff / max(ref, 1e-60)) ** 0.5
        assert err <= GRAD_TOL, f"{what}: {group} rel_l2 {err:.2e}"


def flat_port_state(state) -> dict:
    flat = {f"lora/{n}/{k}": t for n, ab in state["lora"].items() for k, t in ab.items()}
    flat.update({f"trainable/{n}": p for n, p in state["trainable"].items()})
    return flat


def flat_jax_state(jstate) -> dict:
    flat = {f"lora/{n}/{k}": t for n, ab in convert_lora(jstate["lora"]).items()
            for k, t in ab.items()}
    flat.update({f"trainable/{n}": p for n, p in port_trainable(jstate["trainable"]).items()})
    return flat


def assert_state_matches(state, jstate, what: str) -> None:
    assert_groups_match(flat_port_state(state), flat_jax_state(jstate), what)


def run_pair(tcfg: ttr.TrainConfig, steps: int, unfreeze=None, seed: int = 31):
    """The same LoRA steps in both frameworks from the same weights, factors
    (b random, so that every factor has a gradient) and batch. Returns a
    dict: the port's states and metrics after each step and its first
    step's gradients by optimizer name, the JAX states (with the recorded
    gradients under ``opt_state``) and metrics, and the port model."""
    cfg = jax_cfg()
    jmodel, params = jax_params(cfg, seed)
    jtx = optax.chain(grad_recorder(),
                      jtr.make_optimizer(jtr.TrainConfig(**dataclasses.asdict(tcfg))))
    jstep, jstate = jtr.make_lora_train_step(
        jmodel, jtx, jlora.LoraConfig(rank=RANK, alpha=ALPHA),
        jax.tree.map(jnp.asarray, params), vision_unfreeze_last_n=unfreeze)
    rng = np.random.default_rng(seed + 1)
    init_lora = {p: {"a": np.asarray(ab["a"]),
                     "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                 for p, ab in jstate["lora"].items()}
    jstate["lora"] = jax.tree.map(jnp.asarray, init_lora)
    jstep = jax.jit(jstep)
    batch = train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"jstates": [], "jmetrics": [], "states": [], "metrics": []}
    for _ in range(steps):
        jstate, m = jstep(jstate, jbatch)
        out["jstates"].append(jax.tree.map(np.asarray, {
            "lora": jstate["lora"], "trainable": jstate["trainable"],
            "grads": jstate["opt_state"][0]}))
        out["jmetrics"].append({k: float(v) for k, v in m.items()})

    model = port_model(cfg, params)
    step, state = ttr.make_lora_train_step(
        model, ttr.make_optimizer(tcfg), tlora.LoraConfig(rank=RANK, alpha=ALPHA),
        vision_unfreeze_last_n=unfreeze)
    set_port_lora(state, init_lora)
    tbatch = {k: tt(v) for k, v in batch.items()}
    tree = ttr.optimizer_tree(state)
    loss = step.loss_fn(state, tbatch)
    out["grads"] = ttr.gradients(loss, tree)
    out["loss"] = float(loss.detach())
    for _ in range(steps):
        state, m = step(state, tbatch)
        out["states"].append({
            "lora": {n: {k: t.detach().clone() for k, t in ab.items()}
                     for n, ab in state["lora"].items()},
            "trainable": {n: p.detach().clone() for n, p in state["trainable"].items()}})
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["model"], out["init_lora"] = model, init_lora
    return out


@pytest.fixture(scope="module")
def base_run():
    """Three steps at lr 1e-2 over 10 total steps (warmup 1: the first
    update's learning rate is 0), weight decay 0.1 under the HF mask."""
    return run_pair(ttr.TrainConfig(learning_rate=1e-2, total_steps=10, warmup_ratio=0.1,
                                    weight_decay=0.1), steps=3)


@pytest.fixture(scope="module")
def variant_run():
    """The projector's own learning rate, the last CLIP block unfrozen and
    two micro-steps an update: four micro-steps, two updates (the first at
    learning rate 0)."""
    return run_pair(ttr.TrainConfig(learning_rate=1e-2, total_steps=10, warmup_ratio=0.1,
                                    mm_projector_lr=3e-2, grad_accum=2),
                    steps=4, unfreeze=1)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("causal,sq,sk", [(True, 40, 40), (False, 29, 53), (True, 29, 53)])
def test_flash_attention_gradient_matches_jax(causal, sq, sk):
    """The port's K1 gradient on the CPU (plain autograd of mha_reference)
    and its card backward (``flash_attention_bwd``, one recompute and in
    query-row chunks) against jax.grad of the JAX flash_attention."""
    rng = np.random.default_rng(40)
    q, k, v = (rng.standard_normal((2, 3, s, 16)).astype(np.float32) for s in (sq, sk, sk))
    seg = rng.integers(0, 2, (2, sq)).astype(np.int32)
    kseg = rng.integers(0, 2, (2, sk)).astype(np.int32)
    kseg[:, :sq] = seg  # every query row sees a key (K1 stores 0 for one that sees none)
    g = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)

    def f(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, segment_ids=jnp.asarray(seg),
                                    kv_segment_ids=jnp.asarray(kseg))
        return jnp.sum(out * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (tt(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=causal, segment_ids=tt(seg),
                            kv_segment_ids=tt(kseg))
    got = torch.autograd.grad(out, (tq, tk, tv), tt(g))
    assert bool(A.rows_with_keys(tt(seg), tt(kseg), causal, sk).all())
    bwd = A.flash_attention_bwd(tt(q), tt(k), tt(v), tt(seg), tt(kseg), causal, 0.25, tt(g))
    chunked = A.flash_attention_bwd(tt(q), tt(k), tt(v), tt(seg), tt(kseg), causal, 0.25,
                                    tt(g), max_bytes=2 * 3 * sk * 4 * 7)
    for name, w, a, b, c in zip("qkv", want, got, bwd, chunked):
        assert rel_l2(a, w) <= TOL, name
        assert rel_l2(b, w) <= TOL, name
        assert rel_l2(c, w) <= TOL, name


def test_flash_attention_bwd_rows_without_keys():
    """K1 stores 0 for a row with no visible key; its backward gives such a
    row zero dq and no share of dk or dv, as if the row were absent, and
    skips query chunks whose incoming gradient is all zero."""
    rng = np.random.default_rng(41)
    q, k, v, g = (tt(rng.standard_normal((1, 2, 30, 16)).astype(np.float32)) for _ in range(4))
    seg = torch.zeros(1, 30, dtype=torch.int32)
    seg[:, 20:] = 3  # no key carries 3
    kseg = torch.zeros(1, 30, dtype=torch.int32)
    assert torch.equal(A.rows_with_keys(seg, kseg, False, 30)[0], seg[0] == 0)
    causal_rows = A.rows_with_keys(torch.zeros(1, 8, dtype=torch.int32),
                                   torch.zeros(1, 5, dtype=torch.int32), True, 5)
    assert causal_rows.tolist() == [[False, False, False, True, True, True, True, True]]
    for max_bytes in (A.RECOMPUTE_BYTES, 2 * 30 * 4 * 10):
        dq, dk, dv = A.flash_attention_bwd(q, k, v, seg, kseg, False, 0.25, g,
                                           max_bytes=max_bytes)
        assert not dq[:, :, 20:].any()
        kept = A.flash_attention_bwd(q[:, :, :20], k, v, seg[:, :20], kseg, False, 0.25,
                                     g[:, :, :20])
        assert rel_l2(dq[:, :, :20], kept[0]) <= 1e-6
        assert rel_l2(dk, kept[1]) <= 1e-6 and rel_l2(dv, kept[2]) <= 1e-6


# ---------------------------------------------------------------- LoRA
def test_lora_targets_identity_and_effective_weights_match_jax():
    cfg = jax_cfg()
    _, params = jax_params(cfg, 32)
    jl = jlora.init_lora_params(jlora.LoraConfig(rank=RANK, alpha=ALPHA),
                                jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0))
    model = port_model(cfg, params)
    lcfg = tlora.LoraConfig(rank=RANK, alpha=ALPHA)
    targets = {n for n, p in model.named_parameters() if tlora.is_lora_target(lcfg, n, p)}
    assert targets == set(convert_lora(jl))
    assert "language_model.lm_head.weight" in targets
    assert not any("embed_tokens" in n for n in targets)
    assert len(targets) == 7 * cfg.llama.n_layers + 1

    ours = tlora.init_lora_params(lcfg, model, torch.Generator().manual_seed(0))
    assert set(ours) == targets
    assert all(not ab["b"].any() and ab["a"].shape == (RANK, model.get_parameter(n).shape[1])
               for n, ab in ours.items())
    base = dict(model.named_parameters())
    eff = tlora.apply_lora(lcfg, base, ours)
    assert all(torch.equal(eff[n], base[n]) for n in base)  # identity at init
    assert tlora.count_lora_params(ours) == jlora.count_lora_params(jl)

    rng = np.random.default_rng(33)
    jl = {p: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape), jnp.float32)}
          for p, ab in jl.items()}
    want = convert_mm2sg(jax.tree.map(np.asarray, jlora.apply_lora(
        jlora.LoraConfig(rank=RANK, alpha=ALPHA), jax.tree.map(jnp.asarray, params), jl)))
    eff = tlora.apply_lora(lcfg, base, convert_lora(jax.tree.map(np.asarray, jl)))
    for n in targets:
        assert rel_l2(eff[n].detach(), want[n]) <= 1e-6, n
    assert all(torch.equal(eff[n], base[n]) for n in base if n not in targets)


def test_llama_remat_gradients_match_plain_blocks():
    """``remat`` (the JAX package's nn.remat of the block) recomputes each
    decoder block in the backward, on the effective weights LoRA swapped
    in: the same loss and gradients, bit for bit."""
    cfg = jax_cfg()
    params = jax_params(cfg, 37)[1]
    batch = {k: tt(v) for k, v in train_batch(38).items()}
    outs = []
    for remat in (False, True):
        model = port_model(cfg, params)
        model.language_model.cfg = dataclasses.replace(model.language_model.cfg, remat=remat)
        step, state = ttr.make_lora_train_step(model, ttr.make_optimizer(ttr.TrainConfig()),
                                               tlora.LoraConfig(rank=RANK, alpha=ALPHA))
        with torch.no_grad():
            for ab in state["lora"].values():
                ab["b"].normal_(generator=torch.Generator().manual_seed(39))
        tree = ttr.optimizer_tree(state)
        loss = step.loss_fn(state, batch)
        outs.append((loss.detach(), ttr.gradients(loss, tree)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][n], outs[1][1][n]) for n in outs[0][1])


def test_training_refuses_serving_configurations():
    cfg = torch_cfg(jax_cfg())
    for field in ("fused_qkv", "weight_quant"):
        bad = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, **{field: True}))
        with pytest.raises(ValueError, match="unfused float model"):
            ttr.make_lora_train_step(MM2SG(bad), ttr.make_optimizer(ttr.TrainConfig()),
                                     tlora.LoraConfig(rank=RANK))


# -------------------------------------------------------------- losses
@pytest.mark.parametrize("weighted", [False, True])
def test_token_weighted_ce_and_vocab_weights_match_jax(weighted):
    rng = np.random.default_rng(34)
    logits = (3 * rng.standard_normal((2, 9, 17))).astype(np.float32)
    labels = rng.integers(0, 17, (2, 9)).astype(np.int32)
    labels[0, :4] = IGNORE_INDEX
    labels[1, -2:] = IGNORE_INDEX
    freqs = {1: 40, 3: 7, 5: 1, 16: 1000} if weighted else None
    jw = jlosses.build_vocab_weights(freqs, 17)
    tw = tlosses.build_vocab_weights(freqs, 17)
    if weighted:
        np.testing.assert_array_equal(tw, jw)
    else:
        assert jw is None and tw is None
    want = jlosses.token_weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                     None if jw is None else jnp.asarray(jw))
    got = tlosses.token_weighted_ce(tt(logits), tt(labels), None if tw is None else tt(tw))
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


# ----------------------------------------------------------- optimizer
@pytest.mark.parametrize("total,ratio", [(10, 0.1), (1000, 0.03), (7, 0.0)])
def test_schedule_matches_optax(total, ratio):
    warmup = max(1, int(total * ratio))
    ours = ttr.warmup_cosine_decay_schedule(2e-5, warmup, total)
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-5, warmup, total)
    for count in range(total + 1):
        assert abs(ours(count) - float(want(count))) <= 1e-6 * 2e-5, count
    assert ours(0) == 0.0


def test_decay_mask_and_groups_match_jax():
    cfg = jax_cfg()
    _, params = jax_params(cfg, 35)
    flat = {jlora._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    jmask = {jlora._path_str(p): m for p, m in
             jax.tree_util.tree_flatten_with_path(jtr.hf_decay_mask(params))[0]}
    jlabels = {jlora._path_str(p): m for p, m in
               jax.tree_util.tree_flatten_with_path(jtr.mm_projector_labels(params))[0]}
    names = convert_mm2sg({k.removeprefix("params/"): v for k, v in flat.items()
                           if "blocks" not in k})
    assert names  # unscanned leaves keep one name each
    for path in flat:
        if "blocks" in path:
            continue
        (name,) = convert_mm2sg({path.removeprefix("params/"): flat[path]})
        assert ttr.hf_decay_mask(f"trainable/{name}") == jmask[path], path
        assert ttr.mm_projector_labels(name) == jlabels[path], path


# -------------------------------------------------------------- steps
def test_one_lora_step_loss_and_gradients_match_jax(base_run):
    run = base_run
    assert abs(run["loss"] - run["jmetrics"][0]["loss"]) <= TOL * run["jmetrics"][0]["loss"]
    assert abs(run["metrics"][0]["loss"] - run["loss"]) <= TOL * run["loss"]
    assert_groups_match(run["grads"], flat_jax_state(run["jstates"][0]["grads"]), "grads")
    assert all(bool(g.any()) for n, g in run["grads"].items() if n.startswith("lora/"))
    jnorm = run["jmetrics"][0]["grad_norm"]
    assert abs(run["metrics"][0]["grad_norm"] - jnorm) <= TOL * jnorm
    # only the LoRA factors and the trainables have gradients
    assert all(p.grad is None for p in run["model"].parameters())
    assert not any(p.requires_grad for n, p in run["model"].named_parameters()
                   if n.startswith(("language_model", "vision_tower")))


def test_three_lora_steps_match_jax(base_run):
    run = base_run
    first = run["states"][0]
    for n, ab in first["lora"].items():  # the first update's learning rate is 0
        for k, t in ab.items():
            want = convert_lora(run["init_lora"])[n][k]
            assert torch.equal(t, want), (n, k)
    for i, (state, jstate) in enumerate(zip(run["states"], run["jstates"])):
        assert_state_matches(state, jstate, f"step {i + 1}")
    for m, jm in zip(run["metrics"], run["jmetrics"]):
        assert abs(m["loss"] - jm["loss"]) <= TOL * jm["loss"]
    moved = run["states"][2]["lora"]["language_model.blocks.0.q_proj.weight"]["b"]
    assert not torch.equal(moved, run["states"][0]["lora"][
        "language_model.blocks.0.q_proj.weight"]["b"])


def test_full_finetune_step_and_labels_match_jax():
    """``init_train_state`` / ``train_step`` (every parameter trains) against
    the JAX package's, one step at learning rate 1e-2 over 2 total steps
    (warmup 1: the update runs at 0, so the step is held by its loss,
    gradient norm and the optimizer's first moments); ``make_labels``."""
    cfg = jax_cfg()
    jmodel, params = jax_params(cfg, 40)
    tcfg = ttr.TrainConfig(learning_rate=1e-2, total_steps=2, warmup_ratio=0.5)
    jtx = optax.chain(grad_recorder(),
                      jtr.make_optimizer(jtr.TrainConfig(**dataclasses.asdict(tcfg))))
    jstate = jtr.init_train_state(jax.tree.map(jnp.asarray, params), jtx)
    batch = train_batch(41)
    jstate, jm = jax.jit(lambda st, b: jtr.train_step(jmodel, jtx, st, b))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = convert_mm2sg(jax.tree.map(np.asarray, jstate["opt_state"][0]))

    model = port_model(cfg, params)
    tx = ttr.make_optimizer(tcfg)
    state = ttr.init_train_state(model, tx)
    state, m = ttr.train_step(model, tx, state, {k: tt(v) for k, v in batch.items()})
    assert state["step"] == 1 and state["opt_state"]["count"] == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= TOL * float(jm["grad_norm"])
    # the first moments are (1 - b1) times the gradients clipped to norm 1
    unclip = max(1.0, float(m["grad_norm"]) / tcfg.grad_clip) / (1 - tcfg.b1)
    mu = {f"trainable/{n}": t * unclip for n, t in state["opt_state"]["mu"].items()}
    assert_groups_match(mu, {f"trainable/{n}": g for n, g in jgrads.items()}, "mu")
    assert all(torch.equal(p.detach(), tt(np.asarray(convert_mm2sg(params)[n])))
               for n, p in model.named_parameters())

    ids = np.array([[0, 5, 6, 7, 8], [3, 4, 5, 6, 7]], np.int32)
    mask = np.array([[0, 1, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
    prompt = np.array([3, 2], np.int32)
    want = np.asarray(jtr.make_labels(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(prompt)))
    np.testing.assert_array_equal(ttr.make_labels(tt(ids), tt(mask), tt(prompt)).numpy(), want)


def test_mm_projector_lr_matches_jax(variant_run):
    run = variant_run
    for i, (state, jstate) in enumerate(zip(run["states"], run["jstates"])):
        assert_state_matches(state, jstate, f"micro-step {i + 1}")
    # the projector moved at its own rate: three times the base group's here
    p0 = run["states"][1]["trainable"]["mm_projector.fc1.weight"]
    p1 = run["states"][3]["trainable"]["mm_projector.fc1.weight"]
    assert not torch.equal(p0, p1)


def test_vision_unfreeze_last_block_only_moves(variant_run):
    run = variant_run
    before, after = run["states"][1]["trainable"], run["states"][3]["trainable"]
    blocks = {n for n in after if n.startswith("vision_tower.blocks.")}
    last = {n for n in blocks if n.startswith("vision_tower.blocks.1.")}
    assert last and blocks - last
    for n in blocks - last:
        assert torch.equal(after[n], before[n]), n
    assert any(not torch.equal(after[n], before[n]) for n in last)
    assert any(not torch.equal(after[n], before[n]) for n in after
               if n.startswith("vision_tower.") and n not in blocks)


def test_grad_accum_first_micro_step_moves_nothing(variant_run):
    run = variant_run
    first = run["states"][0]
    for n, ab in convert_lora(run["init_lora"]).items():
        for k, want in ab.items():
            assert torch.equal(first["lora"][n][k], want)
    init = dict(port_model(jax_cfg(), jax_params(jax_cfg(), 31)[1]).named_parameters())
    for n, t in first["trainable"].items():
        assert torch.equal(t, init[n].detach()), n
    # the second micro-step's update runs at learning rate 0, the fourth moves
    assert any(not torch.equal(run["states"][3]["trainable"][n], t)
               for n, t in first["trainable"].items())


# ---------------------------------------------------------------- data
@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    paths = build_synthetic_dataset(tmp_path_factory.mktemp("train_data"), n_frames=2)
    kw = dict(split="train", data_path=paths["data_path"], mmor_root=paths["mmor_root"],
              or4d_root=paths["or4d_root"])
    return JORDataset(**kw), ORDataset(**kw)


def _samples(mod, ds):
    samples = mod.generate_finetuning_samples(ds, n_permutations=2, rng=random.Random(0))
    return mod.add_temporal_memory(samples, rng=random.Random(0))


def test_llava_json_samples_match_jax(synthetic):
    jds, tds = synthetic
    (js, jmem), (ts, tmem) = _samples(jllava, jds), _samples(tllava, tds)
    assert ts == js and tmem == jmem and len(ts) == 8
    tok = ByteTokenizer()
    assert tllava.token_frequencies(ts, tok.encode) == jllava.token_frequencies(js, tok.encode)
    mixed = [tllava.generate_finetuning_samples(tds, 1, mixed_modalities=True,
                                                rng=random.Random(5)),
             jllava.generate_finetuning_samples(jds, 1, mixed_modalities=True,
                                                rng=random.Random(5))]
    assert mixed[0] == mixed[1]


def _assert_same_arrays(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("photometric", [False, True])
def test_sg_train_dataset_matches_jax(synthetic, photometric):
    jds, tds = synthetic
    samples = _samples(jllava, jds)[0]
    jcfg_ = jax_cfg()
    mk = lambda mod, tok, cfg: mod.SGTrainDataset(  # noqa: E731
        samples, tok, cfg, mod.SGTrainDataConfig(do_photometric_augment=photometric),
        rng=random.Random(42))
    jdata = mk(jsgd, JByteTokenizer(), jcfg_)
    tdata = mk(tsgd, ByteTokenizer(), torch_cfg(jcfg_))
    for i in range(len(samples)):
        _assert_same_arrays(tdata[i], jdata[i])
    jb, tb = list(jdata.grouped_batches(3)), list(tdata.grouped_batches(3))
    assert len(tb) == len(jb) == 3
    for got, want in zip(tb, jb):
        _assert_same_arrays(got, want)
        assert got["input_ids"].shape[1] % 512 == 0
    assert tsgd.drop_metadata_span("a <robot_metadata_start>x<robot_metadata_end>. b",
                                   "robot_metadata") == "a b"


# --------------------------------------------------------- checkpoints
def test_checkpoint_round_trip(tmp_path):
    g = torch.Generator().manual_seed(36)
    lora = {"language_model.lm_head.weight": {"a": torch.randn(4, 8, generator=g),
                                              "b": torch.randn(6, 4, generator=g)}}
    trainable = {"mm_projector.fc1.weight": torch.randn(3, 5, generator=g).bfloat16()}
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    for step in (3, 12, 5):
        ckpt.save_train_checkpoint(tmp_path, step, lora_params=lora,
                                   non_lora_trainables=trainable)
    (tmp_path / "checkpoint-x").mkdir()
    latest = ckpt.latest_checkpoint(tmp_path)
    assert latest == tmp_path / "checkpoint-12"
    back = ckpt.load_train_checkpoint(latest)
    assert back["step"] == 12 and "state" not in back
    assert all(torch.equal(back["lora"][n][k], lora[n][k]) for n in lora for k in "ab")
    got = back["non_lora_trainables"]["mm_projector.fc1.weight"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, trainable["mm_projector.fc1.weight"])


# ----------------------------------------------------------------- CLI
def test_train_cli_runs_saves_and_resumes(tmp_path, capsys):
    args = ["--preset", "tiny", "--synthetic", "2", "--steps", "2", "--batch_size", "2",
            "--grad_accum", "1", "--save_every", "2", "--lora_rank", "4",
            "--run_dir", str(tmp_path / "run"), "--device", "cpu"]
    first = train_mm2sg.main(args)
    lines = capsys.readouterr().out.splitlines()
    progress = json.loads(lines[-2])
    assert progress["step"] == 2 and np.isfinite(progress["loss"])
    assert first["step"] == 2 and first["initialized_from"] is None
    saved = ckpt.load_train_checkpoint(tmp_path / "run" / "checkpoint-2")
    assert set(saved) == {"step", "lora", "non_lora_trainables"}
    assert "language_model.lm_head.weight" in saved["lora"]
    again = train_mm2sg.main(args)
    out = capsys.readouterr().out
    assert "initialized from" in out and again["start_step"] == 2 and again["step"] == 2
    curriculum = train_mm2sg.main(args[:-4] + ["--run_dir", str(tmp_path / "next"),
                                               "--init_from", str(tmp_path / "run"),
                                               "--steps", "2", "--device", "cpu"])
    assert curriculum["start_step"] == 0 and curriculum["step"] == 2
    assert curriculum["initialized_from"].endswith("checkpoint-2")


def test_train_cli_refusals():
    base = ["--preset", "tiny", "--synthetic", "1", "--steps", "2"]
    if not torch.cuda.is_available():  # the port runs on the card unless asked
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mm2sg.main(base + ["--device", "cuda"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        train_mm2sg.main(base + ["--device", "cpu", "--dp", "2"])
