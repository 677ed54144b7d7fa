"""MM2SG training on the port: LoRA + partial fine-tuning, one device.

Counterpart of ``mmor_tpu/train/trainer.py`` (the reference's HF Trainer +
DeepSpeed path, `LLaVA/llava/train/train.py:1088-1363`): AdamW with warmup
and cosine decay, token-weighted CE over the spliced labels, LoRA on the
decoder with the multimodal modules trained in full.

The optimizer is the port's own code on torch tensors, held to the JAX
package's optax chain: ``MultiSteps(chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule, mask=hf_decay_mask)))``, with the
optional ``mm_projector_lr`` group of ``multi_transform``. Its state keeps
each moment in its parameter's dtype, as optax does, and it updates the
parameters in place. The data-parallel ``make_sharded_*`` steps are not
ported (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
from torch.func import functional_call

from mmor_tpu_torch.models.mm2sg import MM2SG
from mmor_tpu_torch.sg.prompts import IGNORE_INDEX
from mmor_tpu_torch.train import lora as lora_lib
from mmor_tpu_torch.train.losses import token_weighted_ce


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5  # README training command
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    grad_accum: int = 1  # README: per-device batch 4 x grad_accum 4
    # separate LR for the multimodal projector, as in the reference's
    # optimizer groups (llava_trainer.py:191-278); None = single group
    mm_projector_lr: float | None = None


ADAM_EPS = 1e-8  # optax.adamw's eps (eps_root 0)


def _leaf(name: str) -> str:
    return re.split(r"[/.]", name)[-1]


def hf_decay_mask(name: str) -> bool:
    """HF Trainer semantics (llava_trainer.py:191-278 via
    get_decay_parameter_names), on the JAX package's rule: weight decay
    applies to everything except biases and the ``scale`` of modules whose
    name says ``norm``."""
    leaf = _leaf(name)
    if leaf == "bias":
        return False
    return not (leaf == "scale" and "norm" in name.lower())


def mm_projector_labels(name: str) -> str:
    """'proj' for mm_projector parameters, 'base' otherwise (the reference's
    mm_projector_lr group selects names containing 'mm_projector')."""
    return "proj" if "mm_projector" in name else "base"


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, decay)``: a
    linear ramp from 0 over ``warmup_steps``, then a cosine to 0 at
    ``decay_steps`` (counted from 0, warmup included)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (0.0 - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        return peak_value * (0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps))))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (each summed in f32)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """optax's ``MultiSteps(chain(clip_by_global_norm(grad_clip),
    adamw(schedule, b1, b2, weight_decay, mask=hf_decay_mask)),
    every_k_schedule=grad_accum)`` (the ``MultiSteps`` only with
    ``grad_accum`` > 1; with ``mm_projector_lr`` the adamw is one a group, a
    schedule each, as ``multi_transform`` makes it), on a flat dict of named
    tensors updated in place.

    - MultiSteps: each micro-step's gradient joins the running mean
      ``acc + (g - acc) / (n + 1)``; only the k-th updates, on the mean.
    - clip: the gradients are scaled by ``max_norm / g_norm`` only when
      ``g_norm >= max_norm`` (no epsilon).
    - adamw: moments ``(1 - b) * g + b * m``, bias-corrected by the count of
      real updates, ``m_hat / (sqrt(v_hat) + eps)``, plus the decoupled
      ``weight_decay * p`` where ``hf_decay_mask`` allows, times
      ``-schedule(count)`` with count 0 at the first real update (whose
      learning rate is therefore 0)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

        def schedule(peak):
            return warmup_cosine_decay_schedule(
                peak, max(1, int(cfg.total_steps * cfg.warmup_ratio)), cfg.total_steps)

        self.schedules = {"base": schedule(cfg.learning_rate)}
        if cfg.mm_projector_lr is not None:
            self.schedules["proj"] = schedule(cfg.mm_projector_lr)

    def group(self, name: str) -> str:
        return mm_projector_labels(name) if self.cfg.mm_projector_lr is not None else "base"

    def init(self, params: Mapping[str, torch.Tensor]) -> dict[str, Any]:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        state = {"mu": zeros(), "nu": zeros(), "count": 0, "mini_step": 0}
        if self.cfg.grad_accum > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: dict[str, Any]) -> bool:
        """Apply one micro-step's ``grads`` to ``params`` in place; returns
        whether the parameters were updated (every ``grad_accum``-th call)."""
        cfg = self.cfg
        if cfg.grad_accum > 1:
            n = state["mini_step"]
            for name, g in grads.items():
                acc = state["acc"][name]
                acc.copy_(acc + (g.to(acc.dtype) - acc) / (n + 1))
            if n < cfg.grad_accum - 1:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            grads = state["acc"]  # zeroed after the update
        g_norm = global_norm(grads.values())
        clip = bool(g_norm >= cfg.grad_clip)
        count = state["count"] + 1
        lrs = {grp: sched(state["count"]) for grp, sched in self.schedules.items()}
        c1, c2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
        for name, p in params.items():
            g = grads[name].to(p.dtype)
            if clip:
                g = (g / g_norm.to(g.dtype)) * cfg.grad_clip
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
            nu.copy_((1 - cfg.b2) * g ** 2 + cfg.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            if cfg.weight_decay and hf_decay_mask(name):
                update = update + cfg.weight_decay * p
            p.add_(-lrs[self.group(name)] * update)
        state["count"] = count
        if cfg.grad_accum > 1:
            for acc in state["acc"].values():
                acc.zero_()
        return True


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def model_inputs(batch: Mapping[str, Any]) -> tuple[tuple, dict]:
    """The ``MM2SG.forward`` arguments of a training batch (labels kept)."""
    args = (batch["input_ids"], batch["attention_mask"], batch["images"], batch["view_mask"])
    kwargs = {k: batch.get(k) for k in ("pc_feature", "audio_embedding", "segmasks",
                                        "pc_points", "pc_valid", "labels")}
    return args, kwargs


def gradients(loss: torch.Tensor, tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """d loss / d tensor by name; zeros for a tensor the batch does not reach
    (a module of a modality no row carries), as JAX's gradient gives."""
    grads = torch.autograd.grad(loss, list(tensors.values()), allow_unused=True)
    return {name: torch.zeros_like(t) if g is None else g
            for (name, t), g in zip(tensors.items(), grads)}


def init_train_state(model: MM2SG, tx: Optimizer) -> dict[str, Any]:
    """Full fine-tuning: every parameter of ``model`` trains."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params, "opt_state": tx.init(params), "step": 0}


def train_step(model: MM2SG, tx: Optimizer, state, batch, vocab_weights=None):
    """One optimization step of ``init_train_state``'s state, in place.
    ``batch`` carries the MM2SG forward inputs plus ``labels`` (already
    IGNORE_INDEX-masked on the prompt)."""
    args, kwargs = model_inputs(batch)
    logits, labels, _ = model(*args, **kwargs)
    loss = token_weighted_ce(logits, labels, vocab_weights)
    grads = gradients(loss, state["params"])
    tx.step(state["params"], grads, state["opt_state"])
    state["step"] += 1
    return state, {"loss": loss.detach(), "grad_norm": global_norm(grads.values())}


def make_labels(input_ids, attention_mask, prompt_lengths):
    """Supervise only the assistant response: positions < prompt_length (and
    padding) become IGNORE_INDEX, the `preprocess_v1` target masking
    (train.py:432-508)."""
    t = input_ids.shape[1]
    pos = torch.arange(t, device=input_ids.device)[None, :]
    ignore = (pos < prompt_lengths[:, None]) | (attention_mask == 0)
    return torch.where(ignore, torch.full_like(input_ids, IGNORE_INDEX), input_ids)


# --------------------------------------------------------------------- #
# LoRA fine-tuning (reference QLoRA path, train.py:1159-1175, in bf16)
# --------------------------------------------------------------------- #

DEFAULT_TRAINABLE = ("mm_projector", "image_pooler", "segmask_encoder", "point_encoder")


def partition_params(model: MM2SG, trainable_patterns: tuple[str, ...]):
    """Split the model's parameters into (trainable, frozen) dicts by name
    and set ``requires_grad`` to match, so that the frozen remainder gets no
    gradient. Mirrors the reference's trainable set: LoRA on the decoder
    plus fully trained multimodal modules (mm_projector, image_pooler,
    segmask encoder, PTv3), everything else frozen (train.py:1145-1261)."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = any(pat in name for pat in trainable_patterns)
        p.requires_grad_(keep)
        (trainable if keep else frozen)[name] = p
    return trainable, frozen


def optimizer_tree(state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The tensors the optimizer updates, by flat name: ``lora/<weight>/a``
    and ``/b``, ``trainable/<parameter>`` (the JAX step's ``opt_tree``)."""
    tree = {f"lora/{name}/{k}": t for name, ab in state["lora"].items() for k, t in ab.items()}
    tree.update({f"trainable/{name}": p for name, p in state["trainable"].items()})
    return tree


def make_lora_train_step(
    model: MM2SG,
    tx: Optimizer,
    lora_cfg: lora_lib.LoraConfig,
    trainable_patterns: tuple[str, ...] = DEFAULT_TRAINABLE,
    vocab_weights: torch.Tensor | None = None,
    vision_unfreeze_last_n: int | None = None,
):
    """Build (train_step, initial_state) for LoRA + partial fine-tuning.

    state = {lora, trainable, opt_state, step}; ``train_step(state, batch)
    -> (state, {"loss", "grad_norm"})`` updates the LoRA factors and the
    trainable parameters in place. The frozen remainder, the base weights
    included, holds ``requires_grad=False`` and gets no gradient. The LoRA
    factors come from a ``torch.Generator`` seeded with 0 on the model's
    device (the JAX package's ``PRNGKey(0)``). ``vision_unfreeze_last_n``
    reproduces the reference's ``unfreeze_n_vision_tower_layers``
    (train.py:1257-1261) as the JAX package does: the whole CLIP tower
    joins the trainables, and the gradients of all but its last N blocks
    are zeroed (they stay in the optimizer, so weight decay still moves
    them). ``grad_norm`` is the global norm of the micro-step's gradient
    after that mask. ``train_step.loss_fn(state, batch)`` is the step's
    loss alone.
    """
    lcfg = model.cfg.llama
    if lcfg.weight_quant or lcfg.fused_qkv:
        raise ValueError("training runs the unfused float model: build MM2SG with "
                         "weight_quant=False and fused_qkv=False (both are serving "
                         "configurations)")
    if vision_unfreeze_last_n:
        trainable_patterns = tuple(trainable_patterns) + ("vision_tower",)
    trainable, _ = partition_params(model, trainable_patterns)
    params = dict(model.named_parameters())

    vision_masks = {}
    if vision_unfreeze_last_n:
        n_layers = len(model.vision_tower.blocks)
        for name in trainable:
            if m := re.match(r"vision_tower\.blocks\.(\d+)\.", name):
                keep = int(m.group(1)) >= n_layers - vision_unfreeze_last_n
                vision_masks[f"trainable/{name}"] = float(keep)
    device = next(model.parameters()).device
    lora_params = lora_lib.init_lora_params(
        lora_cfg, model, torch.Generator(device=device).manual_seed(0))
    for ab in lora_params.values():
        for t in ab.values():
            t.requires_grad_(True)

    state = {"lora": lora_params, "trainable": trainable, "step": 0}
    state["opt_state"] = tx.init(optimizer_tree(state))

    def loss_fn(state, batch) -> torch.Tensor:
        with torch.profiler.record_function("mmor::lora_apply"):
            eff = lora_lib.apply_lora(lora_cfg, {n: params[n] for n in state["lora"]},
                                      state["lora"])
        args, kwargs = model_inputs(batch)
        logits, labels, _ = functional_call(model, eff, args, kwargs)
        return token_weighted_ce(logits, labels, vocab_weights)

    def step_fn(state, batch):
        tree = optimizer_tree(state)
        loss = loss_fn(state, batch)
        grads = gradients(loss, tree)
        for name, keep in vision_masks.items():
            grads[name] = grads[name] * keep
        grad_norm = global_norm(grads.values())
        tx.step(tree, grads, state["opt_state"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    step_fn.loss_fn = loss_fn
    return step_fn, state
