"""Training checkpoints in the port's own format, with the reference's split.

Counterpart of ``mmor_tpu/utils/checkpoint.py`` (whose orbax trees the port
does not read; converting them is a separate tool): per-step
``checkpoint-{N}`` directories holding the LoRA adapter and the
``non_lora_trainables`` (pooler / projector / segmask encoder / PTv3 /
tuned-tower weights) apart (`train.py:1284-1297`), each a flat dict of CPU
tensors written by ``torch.save``; auto-resume from the latest checkpoint
(`train.py:1338-1341`); curriculum init from a previous run's directory
(`load_model_weights`, `train.py:1053-1085`). As in the JAX package, no
optimizer state is saved.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import torch

PARTS = ("lora", "non_lora_trainables", "state")


def flatten_lora(lora_params: Mapping[str, Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """{weight name: {"a", "b"}} -> {"<weight name>/a": ..., "/b": ...}."""
    return {f"{name}/{k}": t for name, ab in lora_params.items() for k, t in ab.items()}


def unflatten_lora(flat: Mapping[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    out: dict[str, dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        name, k = key.rsplit("/", 1)
        out.setdefault(name, {})[k] = t
    return out


def save_train_checkpoint(
    run_dir: str | Path,
    step: int,
    *,
    lora_params: Mapping | None = None,
    non_lora_trainables: Mapping[str, torch.Tensor] | None = None,
    full_state: Mapping[str, torch.Tensor] | None = None,
) -> Path:
    """Write ``checkpoint-{step}/{lora,non_lora_trainables,state}.pt``, each
    part that is given."""
    ckpt_dir = Path(run_dir) / f"checkpoint-{step}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    parts = {"lora": None if lora_params is None else flatten_lora(lora_params),
             "non_lora_trainables": non_lora_trainables, "state": full_state}
    for part, flat in parts.items():
        if flat is not None:
            torch.save({k: t.detach().cpu() for k, t in flat.items()},
                       ckpt_dir / f"{part}.pt")
    return ckpt_dir


def latest_checkpoint(run_dir: str | Path) -> Path | None:
    """The highest-numbered ``checkpoint-*`` dir, for auto-resume."""
    run_dir = Path(run_dir)
    if not run_dir.exists():
        return None
    best, best_step = None, -1
    for p in run_dir.glob("checkpoint-*"):
        m = re.fullmatch(r"checkpoint-(\d+)", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def load_train_checkpoint(ckpt_dir: str | Path, map_location=None) -> dict[str, Any]:
    """{"step", and each part present: "lora" ({weight name: {"a", "b"}}),
    "non_lora_trainables" and "state" (flat dicts)}."""
    ckpt_dir = Path(ckpt_dir)
    out: dict[str, Any] = {"step": int(ckpt_dir.name.split("-")[-1])}
    for part in PARTS:
        path = ckpt_dir / f"{part}.pt"
        if path.exists():
            flat = torch.load(path, map_location=map_location, weights_only=True)
            out[part] = unflatten_lora(flat) if part == "lora" else flat
    return out
