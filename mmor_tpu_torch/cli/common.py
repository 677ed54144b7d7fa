"""Shared CLI plumbing: presets, tokenizers, dataset and predictor construction.

Counterpart of ``mmor_tpu/cli/common.py``. Weights are random from a seed
(normal 0.02) unless a checkpoint — a ``torch.save``'d ``MM2SG`` state
dict, e.g. one made by ``utils/convert_jax.py`` — is given.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import torch

from mmor_tpu_torch.data.or_dataset import ORDataset
from mmor_tpu_torch.config import LlamaConfig, MM2SGConfig, pick_ck, preset, require_device
from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
from mmor_tpu_torch.models import common
from mmor_tpu_torch.models.llama import LlamaModel, fuse_llama_params, quantize_llama_params
from mmor_tpu_torch.models.mm2sg import MM2SG


def load_tokenizer(path: str | None):
    """HF tokenizer from a local dir, else the byte-level fallback."""
    if path:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)
        tok.vocab_size = len(tok)
        return tok
    return ByteTokenizer()


def model_config(preset_name: str, tokenizer) -> MM2SGConfig:
    if preset_name == "tiny":
        return MM2SGConfig.tiny(
            llama=LlamaConfig.tiny(vocab_size=max(tokenizer.vocab_size, 259)))
    return preset(preset_name)


def make_dataset(args) -> ORDataset:
    if args.synthetic:
        from mmor_tpu_torch.data.synthetic import build_synthetic_dataset

        root = Path(tempfile.mkdtemp(prefix="mmor_synth_"))
        paths = build_synthetic_dataset(root, n_frames=args.synthetic)
        return ORDataset(split=args.split, data_path=paths["data_path"],
                         mmor_root=paths["mmor_root"], or4d_root=paths["or4d_root"])
    return ORDataset(split=args.split, data_path=args.data_path)


def init_params(model: MM2SG, seed: int = 0) -> None:
    """Seeded random weights in place: N(0, 0.02), norm scales 1, biases 0."""
    device = next(model.parameters()).device
    common.init_params(model, torch.Generator(device=device).manual_seed(seed))


def _swap_language_model(model: MM2SG, lcfg: LlamaConfig, state: dict) -> MM2SG:
    """Replace the float language model with one of config ``lcfg`` holding
    the quantized ``state``."""
    device = next(model.parameters()).device
    model.language_model = None  # free the float weights before the new ones
    with torch.device(device):
        lm = LlamaModel(lcfg)
    lm.load_state_dict(state)
    model.language_model = lm
    model.cfg = dataclasses.replace(model.cfg, llama=lcfg)
    return model


def quantize_int8(model: MM2SG) -> MM2SG:
    """Swap the language model for its packed-int8 twin: int8 weights (K2)
    with ``ffn_pad`` to a multiple of 1024 and an int8 KV cache (K4)."""
    cfg = model.cfg
    ffn_pad = (-cfg.llama.ffn_dim) % 1024
    lcfg = dataclasses.replace(cfg.llama, weight_quant=True, kv_quant=True,
                               ffn_pad=ffn_pad)
    with torch.no_grad():
        state = quantize_llama_params(model.language_model.state_dict(), ffn_pad)
    return _swap_language_model(model, lcfg, state)


def quantize_int4(model: MM2SG) -> MM2SG:
    """Swap the language model for the megakernel serving configuration
    (``mmor_tpu/cli/common.py:109-130``): fused qkv / gate_up, int4 weights
    with per-(K-chunk, channel) scales (K3), ``ffn_pad`` to a multiple of
    1024, an int4 KV cache and decode through K5. Where the K-chunk
    (``pick_ck``) is not a multiple of 256 (the tiny preset) the megakernel
    is off: int4 weights, an int8 KV cache (K4) and per-op decode; that
    configuration runs only on the CPU, since K3's kernel takes groups that
    are multiples of 256."""
    cfg = model.cfg
    ffn_pad = (-cfg.llama.ffn_dim) % 1024
    lcfg = dataclasses.replace(
        cfg.llama, weight_quant=True, kv_quant=True, fused_qkv=True,
        mega_decode=True, weight_bits=4, kv_bits=4, ffn_pad=ffn_pad)
    group = pick_ck(lcfg)
    if group % 256:
        lcfg = dataclasses.replace(lcfg, mega_decode=False, kv_bits=8)
    lcfg = dataclasses.replace(lcfg, weight_group=group)
    with torch.no_grad():
        state = quantize_llama_params(
            fuse_llama_params(model.language_model.state_dict()), ffn_pad,
            bits=4, group=group)
    return _swap_language_model(model, lcfg, state)


def build_predictor(preset_name: str, tokenizer, checkpoint: str | Path | None,
                    temporality: str | None = None, quantize: bool | str | None = None,
                    device: str | torch.device = "cuda",
                    seed: int = 0) -> SceneGraphPredictor:
    """``quantize``: None/False = ``cfg.llama.dtype`` weights and cache;
    "int8" (or True) = packed int8 weights + int8 KV, per-op decode through
    K2 and K4; "int4" = the megakernel configuration (``quantize_int4``).
    Runs on the card unless ``device`` is "cpu"; without a card it raises."""
    mode = {True: "int8", False: None}.get(quantize, quantize)
    if mode not in (None, "int8", "int4"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = require_device(device)
    cfg = model_config(preset_name, tokenizer)
    if device.type == "cuda" and cfg.llama.dtype != torch.bfloat16:
        # the tiny preset: f32 activations (K1 takes bf16) and, under int4,
        # 32-row scale groups (K3 takes multiples of 256)
        raise ValueError(f"preset {preset_name!r} computes in {cfg.llama.dtype}; the "
                         "CUDA kernels take bf16, so it runs only with device='cpu'")
    with torch.device(device):
        model = MM2SG(cfg)
    if checkpoint:
        model.load_state_dict(torch.load(checkpoint, map_location=device))
    else:
        init_params(model, seed)
    if mode == "int8":
        model = quantize_int8(model)
    elif mode == "int4":
        model = quantize_int4(model)
    model.eval()
    return SceneGraphPredictor(cfg=model.cfg, model=model, tokenizer=tokenizer,
                               device=device, temporality=temporality)
