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

from mmor_tpu.data.or_dataset import ORDataset
from mmor_tpu_torch.config import LlamaConfig, MM2SGConfig, preset
from mmor_tpu_torch.inference import ByteTokenizer, SceneGraphPredictor
from mmor_tpu_torch.models import common
from mmor_tpu_torch.models.llama import LlamaModel, quantize_llama_params
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
        from mmor_tpu.data.synthetic import build_synthetic_dataset

        root = Path(tempfile.mkdtemp(prefix="mmor_synth_"))
        paths = build_synthetic_dataset(root, n_frames=args.synthetic)
        return ORDataset(split=args.split, data_path=paths["data_path"],
                         mmor_root=paths["mmor_root"], or4d_root=paths["or4d_root"])
    return ORDataset(split=args.split, data_path=args.data_path)


def init_params(model: MM2SG, seed: int = 0) -> None:
    """Seeded random weights in place: N(0, 0.02), norm scales 1, biases 0."""
    device = next(model.parameters()).device
    common.init_params(model, torch.Generator(device=device).manual_seed(seed))


def quantize_int8(model: MM2SG) -> MM2SG:
    """Swap the language model for its packed-int8 twin: int8 weights (K2)
    with ``ffn_pad`` to a multiple of 1024 and an int8 KV cache (K4)."""
    cfg = model.cfg
    ffn_pad = (-cfg.llama.ffn_dim) % 1024
    lcfg = dataclasses.replace(cfg.llama, weight_quant=True, kv_quant=True,
                               ffn_pad=ffn_pad)
    with torch.no_grad():
        state = quantize_llama_params(model.language_model.state_dict(), ffn_pad)
    device = next(model.parameters()).device
    model.language_model = None  # free the float weights before the new ones
    with torch.device(device):
        lm = LlamaModel(lcfg)
    lm.load_state_dict(state)
    model.language_model = lm
    model.cfg = dataclasses.replace(cfg, llama=lcfg)
    return model


def build_predictor(preset_name: str, tokenizer, checkpoint: str | Path | None,
                    temporality: str | None = None, quantize: bool | str | None = None,
                    device: str | torch.device = "cpu",
                    seed: int = 0) -> SceneGraphPredictor:
    """``quantize``: None/False = ``cfg.llama.dtype`` weights and cache;
    "int8" (or True) = packed int8 weights + int8 KV, per-op decode through
    K2 and K4. "int4" (the decode megakernel configuration) is not ported
    yet."""
    mode = {True: "int8", False: None}.get(quantize, quantize)
    if mode == "int4":
        raise NotImplementedError(
            "--quantize int4 runs the decode megakernel (K3 + K5), which comes "
            "with ROADMAP Queue 1, slice 6")
    if mode not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = torch.device(device)
    cfg = model_config(preset_name, tokenizer)
    with torch.device(device):
        model = MM2SG(cfg)
    if checkpoint:
        model.load_state_dict(torch.load(checkpoint, map_location=device))
    else:
        init_params(model, seed)
    if mode == "int8":
        model = quantize_int8(model)
    model.eval()
    return SceneGraphPredictor(cfg=model.cfg, model=model, tokenizer=tokenizer,
                               device=device, temporality=temporality)
