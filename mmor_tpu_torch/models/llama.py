"""Llama-family decoder: RMSNorm + RoPE + SwiGLU, capacity KV cache.

Counterpart of ``mmor_tpu/models/llama.py``:

- prefill runs K1 flash attention (causal + left-padding segments) and, given
  capacity cache buffers, writes each layer's keys/values into them in place;
- per-op decode is one position per step against the cache stacks: the new
  column is written at the batch-uniform ``write_pos`` while RoPE uses each
  row's own ``tok_pos`` (left padding makes the two differ); with
  ``kv_quant`` the attention is K4 reading its layer of the int8 stack in
  place;
- with ``weight_quant`` every projection is a packed matmul (``QuantDense``):
  K2 for int8 weights, K3 for int4 weights with per-(K-group, channel)
  scales; the lm_head is int8 (K2) either way;
- under ``mega_decode`` (int4 weights, int4 KV) the prefill writes the int4
  cache and decode runs through ``ops/mega_decode.py`` (K5).

The JAX scan over blocks is a Python loop over per-layer modules here.
The int8 cache is (L, B, H, T, D) int8 with (L, B, H, T) bf16 scales, the
int4 cache (L, B, H, T, D/2) uint8 of biased nibble pairs with the same
scales — the port's Hopper layouts (``ops/attention.decode_attention_packed_stack``,
``ops/mega_decode.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mmor_tpu_torch.config import LlamaConfig
from mmor_tpu_torch.models.common import Dense
from mmor_tpu_torch.ops import attention as attn_ops
from mmor_tpu_torch.ops import mega_decode as mega_ops
from mmor_tpu_torch.ops import quantized_matmul as qmm

KVCache = dict[str, Any]


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8 KV quantization over the head dim.

    x: (..., T, D) -> (int8 (..., T, D), scale (..., T) bf16)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


class QuantDense(nn.Module):
    """Dense with packed quantized weights: int8 packed 4 per int32 along K
    with per-channel scales, served by K2 (``bits=8``), or int4 packed 8 per
    int32 with per-(K-``group``, channel) scales, served by K3 (``bits=4``).
    Buffers: ``w_p`` int32 (in/4 or in/8, out), ``scale`` f32 (out,) or
    (in/group, out); fill them with ``quantize_llama_params``."""

    def __init__(self, in_features: int, features: int, *, int8_mxu: bool = True,
                 bits: int = 8, group: int = 1024):
        super().__init__()
        self.int8_mxu, self.bits, self.group = int8_mxu, bits, group
        if bits == 4:
            self.register_buffer("w_p", torch.zeros(in_features // 8, features,
                                                    dtype=torch.int32))
            self.register_buffer("scale", torch.ones(in_features // group, features,
                                                     dtype=torch.float32))
        else:
            self.register_buffer("w_p", torch.zeros(in_features // 4, features,
                                                    dtype=torch.int32))
            self.register_buffer("scale", torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        if self.bits == 4:
            out = qmm.int4_matmul_packed(flat, self.w_p, self.scale, group=self.group,
                                         int8_mxu=self.int8_mxu)
        else:
            out = qmm.int8_matmul_packed(flat, self.w_p, self.scale,
                                         int8_mxu=self.int8_mxu)
        return out.reshape(*x.shape[:-1], out.shape[-1])


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.scale.float()).to(self.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, 1, T, head_dim) f32, for ``rotate``: HF half
    rotation at positions (B, T). Computed once per forward and shared by
    every layer."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[:, :, None] * inv_freq[None, None, :]
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)[:, None]
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)[:, None]
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x (B, H, T, Dh) with ``rope_tables``' output."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """HF-convention rotary embedding. x: (B, H, T, Dh); positions: (B, T)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


class LlamaBlock(nn.Module):
    """One decoder block. ``segment_ids`` given selects prefill; otherwise a
    one-position decode step against the cache stacks in ``caches``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        q_width = cfg.n_heads * cfg.head_dim
        kv_width = cfg.n_kv_heads * cfg.head_dim
        ffn = cfg.ffn_dim + cfg.ffn_pad
        if cfg.weight_quant:
            def dense(fin, fout):
                return QuantDense(fin, fout, int8_mxu=cfg.quant_int8_mxu,
                                  bits=cfg.weight_bits, group=cfg.weight_group)
        else:
            def dense(fin, fout):
                return Dense(fin, fout, bias=False, dtype=cfg.dtype,
                             param_dtype=cfg.param_dtype)
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
        if cfg.fused_qkv:
            self.qkv_proj = dense(cfg.dim, q_width + 2 * kv_width)
        else:
            self.q_proj = dense(cfg.dim, q_width)
            self.k_proj = dense(cfg.dim, kv_width)
            self.v_proj = dense(cfg.dim, kv_width)
        self.o_proj = dense(q_width, cfg.dim)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
        if cfg.fused_qkv:
            self.gate_up_proj = dense(cfg.dim, 2 * ffn)
        else:
            self.gate_proj = dense(cfg.dim, ffn)
            self.up_proj = dense(cfg.dim, ffn)
        self.down_proj = dense(ffn, cfg.dim)

    def forward(self, x, rope, segment_ids, kv_mask, write_pos: int,
                caches: KVCache | None, layer_idx: int) -> torch.Tensor:
        """``rope``: the (cos, sin) of ``rope_tables`` at the positions of x."""
        cfg = self.cfg
        batch, seq, _ = x.shape
        q_width = cfg.n_heads * cfg.head_dim
        kv_width = cfg.n_kv_heads * cfg.head_dim
        h = self.attn_norm(x)
        if cfg.fused_qkv:
            q, k, v = self.qkv_proj(h).split([q_width, kv_width, kv_width], dim=-1)
        else:
            q, k, v = self.q_proj(h), self.k_proj(h), self.v_proj(h)
        q = q.reshape(batch, seq, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        k = k.reshape(batch, seq, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
        v = v.reshape(batch, seq, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
        q = rotate(q, *rope)
        k = rotate(k, *rope)
        if cfg.n_kv_heads != cfg.n_heads:
            reps = cfg.n_heads // cfg.n_kv_heads
            k = k.repeat_interleave(reps, dim=1)
            v = v.repeat_interleave(reps, dim=1)

        if segment_ids is not None:  # prefill
            attn = attn_ops.flash_attention(q, k, v, causal=True,
                                            segment_ids=segment_ids)
            if caches is not None:  # fill this layer's slots [0, seq) in place
                if cfg.kv_quant and cfg.kv_bits == 4:
                    for name, t in (("k", k), ("v", v)):
                        u, s = mega_ops.quantize_kv_int4(t)
                        caches[name][layer_idx, :, :, :seq] = mega_ops.pack_kv_int4(u)
                        caches[name + "_s"][layer_idx, :, :, :seq] = s
                elif cfg.kv_quant:
                    k_q, k_s = quantize_kv(k)
                    v_q, v_s = quantize_kv(v)
                    caches["k"][layer_idx, :, :, :seq] = k_q
                    caches["k_s"][layer_idx, :, :, :seq] = k_s
                    caches["v"][layer_idx, :, :, :seq] = v_q
                    caches["v_s"][layer_idx, :, :, :seq] = v_s
                else:
                    caches["k"][layer_idx, :, :, :seq] = k
                    caches["v"][layer_idx, :, :, :seq] = v
        elif cfg.mega_decode:
            raise ValueError("mega_decode serves decode through "
                             "ops/mega_decode.make_mega_decode_step")
        elif cfg.kv_quant:  # decode against the int8 stacks (K4)
            k_q, k_s = quantize_kv(k)  # (B, H, 1, D), (B, H, 1)
            v_q, v_s = quantize_kv(v)
            caches["k"][layer_idx, :, :, write_pos] = k_q[:, :, 0]
            caches["k_s"][layer_idx, :, :, write_pos] = k_s[:, :, 0]
            caches["v"][layer_idx, :, :, write_pos] = v_q[:, :, 0]
            caches["v_s"][layer_idx, :, :, write_pos] = v_s[:, :, 0]
            attn = attn_ops.decode_attention_packed_stack(
                q, caches["k"], caches["v"], caches["k_s"], caches["v_s"],
                kv_mask, layer_idx)
        else:  # decode against the unquantized stacks
            caches["k"][layer_idx, :, :, write_pos] = k[:, :, 0]
            caches["v"][layer_idx, :, :, write_pos] = v[:, :, 0]
            attn = attn_ops.decode_attention(q, caches["k"][layer_idx],
                                             caches["v"][layer_idx], kv_mask)

        attn = attn.transpose(1, 2).reshape(batch, seq, q_width)
        x = x + self.o_proj(attn)
        h = self.mlp_norm(x)
        if cfg.fused_qkv:
            gate, up = self.gate_up_proj(h).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(h), self.up_proj(h)
        return x + self.down_proj(F.silu(gate) * up)


class LlamaModel(nn.Module):
    """Decoder-only LM. ``cache=None`` is the prefill (it fills
    ``prefill_cache_buffers`` in place when given); a ``cache`` dict makes
    one decode step. Returns (f32 logits, cache)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim,
                                         dtype=cfg.param_dtype)
        self.blocks = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, cfg.dtype, cfg.param_dtype)
        if cfg.weight_quant:
            self.lm_head = QuantDense(cfg.dim, cfg.vocab_size,
                                      int8_mxu=cfg.quant_int8_mxu)
        else:
            self.lm_head = Dense(cfg.dim, cfg.vocab_size, bias=False,
                                 dtype=cfg.dtype, param_dtype=cfg.param_dtype)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids.long()).to(self.cfg.dtype)

    def forward(self, *, input_ids=None, input_embeds=None, attention_mask,
                positions=None, cache: KVCache | None = None,
                last_logit_only: bool = False, prefill_cache_buffers=None):
        cfg = self.cfg
        if input_embeds is None:
            input_embeds = self.embed(input_ids)
        x = input_embeds.to(cfg.dtype)
        seq = x.shape[1]
        if positions is None:
            # left-pad aware positions: the first real token gets position 0
            positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        if cache is None:
            segment_ids = attention_mask.to(torch.int32)
            # ``remat`` (the JAX package's nn.remat of the block): under
            # autograd each block keeps only its input and recomputes itself
            # in the backward
            remat = cfg.remat and torch.is_grad_enabled() and prefill_cache_buffers is None
            for i, block in enumerate(self.blocks):
                if remat:
                    x = _remat_block(block, x, rope, segment_ids, i)
                else:
                    x = block(x, rope, segment_ids, None, 0, prefill_cache_buffers, i)
            new_cache = prefill_cache_buffers
        else:
            wp = cache["write_pos"]
            kv_mask = cache["kv_mask"]
            kv_mask[:, wp:wp + seq] = 1  # the new token attends to itself
            for i, block in enumerate(self.blocks):
                x = block(x, rope, None, kv_mask, wp, cache, i)
            new_cache = dict(cache, write_pos=wp + seq,
                             tok_pos=cache["tok_pos"] + seq)
        if last_logit_only:
            x = x[:, -1:]
        logits = self.lm_head(self.final_norm(x))
        return logits.float(), new_cache


def _remat_block(block: LlamaBlock, x, rope, segment_ids, layer_idx: int) -> torch.Tensor:
    """One prefill block under ``torch.utils.checkpoint``. The block's
    weights go in as inputs, so that the recompute in the backward runs on
    the tensors the forward used, also when a caller swapped them in
    (``torch.func.functional_call``, as LoRA training does)."""
    names, weights = zip(*block.named_parameters())

    def run(x, *ws):
        return torch.func.functional_call(
            block, dict(zip(names, ws)), (x, rope, segment_ids, None, 0, None, layer_idx))

    return torch.utils.checkpoint.checkpoint(run, x, *weights, use_reentrant=False)


def alloc_kv_buffers(cfg: LlamaConfig, batch: int, max_len: int,
                     device) -> KVCache:
    """Capacity cache stacks the prefill fills in place: int8 (L, B, H, T, D)
    keys/values with bf16 (L, B, H, T) scales under ``kv_quant``, or with
    ``kv_bits=4`` uint8 (L, B, H, T, D/2) nibble pairs with the same scales;
    else ``cfg.dtype`` stacks."""
    shape = (cfg.n_layers, batch, cfg.n_heads, max_len, cfg.head_dim)
    if cfg.kv_quant and cfg.kv_bits == 4:
        shape = shape[:-1] + (cfg.head_dim // 2,)
        return dict(
            k=torch.zeros(shape, dtype=torch.uint8, device=device),
            k_s=torch.ones(shape[:-1], dtype=torch.bfloat16, device=device),
            v=torch.zeros(shape, dtype=torch.uint8, device=device),
            v_s=torch.ones(shape[:-1], dtype=torch.bfloat16, device=device))
    if cfg.kv_quant:
        sshape = shape[:-1]
        return dict(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            k_s=torch.ones(sshape, dtype=torch.bfloat16, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            v_s=torch.ones(sshape, dtype=torch.bfloat16, device=device))
    return dict(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def build_cache(cfg: LlamaConfig, filled: KVCache, attention_mask: torch.Tensor,
                max_len: int) -> KVCache:
    """Decode cache from the prefill-filled capacity stacks: the padded
    prompt mask (left padding stays masked for the whole decode), the
    batch-uniform ``write_pos`` and each row's next RoPE position."""
    seq = attention_mask.shape[1]
    if filled["k"].shape[3] != max_len:
        raise ValueError(f"cache stacks hold {filled['k'].shape[3]} slots, "
                         f"expected capacity {max_len}")
    kv_mask = F.pad(attention_mask.to(torch.int32), (0, max_len - seq))
    return dict(filled, kv_mask=kv_mask, write_pos=seq,
                tok_pos=attention_mask.sum(dim=-1).to(torch.int32))


def make_decode_step(model: LlamaModel):
    """One greedy decode step: step(cache, tok (B, 1)) -> (next (B,) int32,
    cache). The cache stacks update in place."""

    def step(cache: KVCache, tok: torch.Tensor):
        logits, cache = model(
            input_embeds=model.embed(tok),
            attention_mask=torch.ones_like(tok, dtype=torch.int32),
            positions=cache["tok_pos"][:, None], cache=cache)
        return logits[:, -1].argmax(dim=-1).to(torch.int32), cache

    return step


def greedy_decode_hostloop(model: LlamaModel, prompt_logits: torch.Tensor,
                           cache: KVCache, max_new_tokens: int, *,
                           eos_token_id: int, step_fn=None):
    """Greedy decode as a host-driven loop of cache-updating steps.

    Every 64 steps the host checks whether every row emitted EOS and stops
    early; afterwards each row is EOS-filled from its first EOS on. Returns
    ((B, max_new_tokens) int32 numpy array, final cache)."""
    batch = prompt_logits.shape[0]
    if step_fn is None:
        step_fn = make_decode_step(model)
    tok = prompt_logits[:, -1].argmax(dim=-1).to(torch.int32)
    toks = [tok]
    for i in range(max_new_tokens - 1):
        tok, cache = step_fn(cache, tok[:, None])
        toks.append(tok)
        if eos_token_id >= 0 and (i + 1) % 64 == 0:
            if bool((tok == eos_token_id).all()):
                break
    out = torch.stack(toks, dim=1).cpu().numpy()
    if out.shape[1] < max_new_tokens:  # early stop: pad with EOS
        out = np.pad(out, ((0, 0), (0, max_new_tokens - out.shape[1])),
                     constant_values=eos_token_id)
    for b in range(batch):  # EOS fill after each row's first EOS
        hits = np.nonzero(out[b] == eos_token_id)[0]
        if hits.size:
            out[b, hits[0]:] = eos_token_id
    return out, cache


_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
               "down_proj", "qkv_proj", "gate_up_proj")


def fuse_llama_params(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """q/k/v -> ``qkv_proj`` and gate/up -> ``gate_up_proj`` weights (for
    ``fused_qkv=True``), on a ``LlamaModel`` state dict."""
    out = dict(state)
    layers = sorted({int(k.split(".")[1]) for k in state if k.startswith("blocks.")})
    for i in layers:
        p = f"blocks.{i}."
        out[p + "qkv_proj.weight"] = torch.cat(
            [out.pop(p + f"{n}.weight") for n in ("q_proj", "k_proj", "v_proj")])
        out[p + "gate_up_proj.weight"] = torch.cat(
            [out.pop(p + f"{n}.weight") for n in ("gate_proj", "up_proj")])
    return out


def quantize_llama_params(state: dict[str, torch.Tensor], ffn_pad: int = 0,
                          bits: int = 8, group: int = 1024) -> dict[str, torch.Tensor]:
    """Float ``LlamaModel`` state dict -> packed state dict for
    ``weight_quant=True`` (``llama.py:673-731``): every block projection
    becomes ``w_p`` (in/4, out) int32 + ``scale`` (out,) f32 quantized per
    output channel, or with ``bits=4`` ``w_p`` (in/8, out) of biased nibbles
    + ``scale`` (in/group, out) quantized per (K-``group``, channel); the
    lm_head is int8 either way. ``ffn_pad`` zero channels are appended to
    gate/up outputs (fused: ``[gate | pad | up | pad]``) and the down input
    first (exact: silu(0) * 0 = 0). Embeddings and norms stay as they are."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: 8 or 4")
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        is_proj = len(parts) == 4 and parts[0] == "blocks" and parts[2] in _PROJ_NAMES
        if not (is_proj or key == "lm_head.weight"):
            out[key] = value
            continue
        kernel = value.t().float()  # (in, out), the JAX layout
        name = parts[2] if is_proj else "lm_head"
        if ffn_pad and name in ("gate_proj", "up_proj"):
            kernel = F.pad(kernel, (0, ffn_pad))
        elif ffn_pad and name == "gate_up_proj":
            d, f2 = kernel.shape
            kernel = F.pad(kernel.reshape(d, 2, f2 // 2), (0, ffn_pad)).reshape(d, -1)
        elif ffn_pad and name == "down_proj":
            kernel = F.pad(kernel, (0, 0, 0, ffn_pad))
        prefix = key[: -len("weight")]
        if bits == 4 and is_proj:
            w_q, scale = qmm.quantize_weights_int4(kernel, group)
            out[prefix + "w_p"] = qmm.pack_int4_rows(w_q, block=group)
        else:
            w_q, scale = qmm.quantize_weights(kernel)
            out[prefix + "w_p"] = qmm.pack_int8_rows(w_q)
        out[prefix + "scale"] = scale
    return out
