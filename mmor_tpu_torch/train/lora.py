"""LoRA for the MM2SG language model, on the port's modules.

Counterpart of ``mmor_tpu/train/lora.py``: the reference's PEFT/QLoRA setup
(r=128, alpha=256) run as plain LoRA on unquantized weights,
``W_eff = W + (alpha/r) * B @ A``. The factors live in a dict keyed like the
model's parameters (``language_model.blocks.<i>.q_proj.weight``), one (a, b)
pair a target and layer; ``apply_lora`` materializes the effective weights,
and training runs the unchanged modules on them with
``torch.func.functional_call``, the counterpart of the JAX package's pytree
surgery. ``merge_lora`` is the same computation, kept.

The targets are the JAX package's: every 2-D weight under
``language_model`` except ``embed_tokens``, that is all seven projections of
each block and ``lm_head`` (the reference's PEFT leaves ``lm_head`` out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 128
    alpha: float = 256.0
    # target 2-D weights under these modules (name substring match)
    include: tuple[str, ...] = ("language_model",)
    exclude: tuple[str, ...] = ("embed_tokens",)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def is_lora_target(cfg: LoraConfig, name: str, param: torch.Tensor) -> bool:
    """2-D ``weight`` parameters inside the included modules: the JAX
    package's 2-D and scanned 3-D Dense ``kernel`` leaves, one layer at a
    time."""
    if not name.endswith("weight") or param.ndim != 2:
        return False
    if not any(s in name for s in cfg.include):
        return False
    return not any(s in name for s in cfg.exclude)


def init_lora_params(cfg: LoraConfig, model: nn.Module,
                     generator: torch.Generator) -> dict[str, dict[str, torch.Tensor]]:
    """f32 factors for every target weight (out, in), on its device:
    a (r, in) ~ N(0, 0.01) from ``generator``, b (out, r) = 0, so the
    model is unchanged at step 0."""
    lora = {}
    for name, w in model.named_parameters():
        if not is_lora_target(cfg, name, w):
            continue
        d_out, d_in = w.shape
        a = torch.randn(cfg.rank, d_in, generator=generator, device=w.device) * 0.01
        lora[name] = {"a": a, "b": torch.zeros(d_out, cfg.rank, device=w.device)}
    return lora


def lora_delta(ab: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """b @ a: (out, in), the JAX package's a^T b^T in torch's weight layout."""
    return ab["b"] @ ab["a"]


def apply_lora(cfg: LoraConfig, params: Mapping[str, torch.Tensor],
               lora_params: Mapping[str, Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """``params`` with each target replaced by its effective weight
    ``(W.float() + scale * b @ a).to(W.dtype)``."""
    out = dict(params)
    for name, ab in lora_params.items():
        w = params[name]
        out[name] = (w.float() + lora_delta(ab) * cfg.scale).to(w.dtype)
    return out


def merge_lora(cfg: LoraConfig, params, lora_params) -> dict[str, torch.Tensor]:
    """Fold the factors into the base weights (peft ``merge_and_unload``)."""
    return apply_lora(cfg, params, lora_params)


def count_lora_params(lora_params) -> int:
    return sum(t.numel() for ab in lora_params.values() for t in ab.values())
