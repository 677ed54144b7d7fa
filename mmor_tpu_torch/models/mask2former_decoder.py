"""Masked-attention transformer decoder (Mask2Former / video / DVIS+ variant).

Counterpart of ``mmor_tpu/models/mask2former_decoder.py``: learned queries
shared across the T frames of a clip; layers cycling over the 3 transformer
feature scales, each masked cross-attention (restricted to the foreground of
the previous layer's mask prediction; all-background queries unmask), query
self-attention and FFN; class head (K+1 logits), mask-embed MLP dotted with
the 1/4-scale mask features, and the ReID embedding head.

The attention is plain PyTorch, as it is plain einsums in the JAX module (no
Pallas kernel). The mask-attention bias comes from a bilinear resize of the
mask logits to the next level: ``jax.image.resize`` antialiases when it
downsamples, and so does ``F.interpolate(..., antialias=True)``, with the
same triangle weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.models.common import Dense, LayerNorm
from mmor_tpu_torch.models.layers import MLP, sine_position_embedding_2d

NEG_INF = -1e9
EPS = 1e-6  # flax's LayerNorm default


@dataclass(frozen=True)
class MaskDecoderConfig:
    hidden_dim: int = 256
    num_queries: int = 100
    n_heads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9  # cycles over the 3 scales
    mask_dim: int = 256
    num_classes: int = 124  # reference quirk: VSPW head size kept for OR (24 live)
    reid_dim: int = 256
    with_reid: bool = True
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, **kw):
        base = dict(hidden_dim=32, num_queries=8, n_heads=4, dim_feedforward=64,
                    dec_layers=3, mask_dim=32, num_classes=10, reid_dim=32)
        base.update(kw)
        return cls(**base)


def attention(q, k, v, bias, n_heads: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain MHA with an additive bias; (B, Lq, C) x (B, Lk, C). As in the
    JAX module, the products are in ``dtype`` and the scaled logits, bias and
    softmax in f32."""
    b, lq, c = q.shape
    hd = c // n_heads
    qh = q.reshape(b, lq, n_heads, hd).transpose(1, 2)
    kh = k.reshape(b, -1, n_heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, n_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.matmul(w, vh)
    return out.transpose(1, 2).reshape(b, lq, c)


class AttentionBlock(nn.Module):
    """Attention + residual + post-LN; position embeddings go into q/k only,
    and the residual is ``x`` (for the DVIS referring cross-attention, the
    identity path while ``q_input`` is the reference)."""

    def __init__(self, dim: int, n_heads: int, *, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.q_proj = Dense(dim, dim, **kw)
        self.k_proj = Dense(dim, dim, **kw)
        self.v_proj = Dense(dim, dim, **kw)
        self.out_proj = Dense(dim, dim, **kw)
        self.norm = LayerNorm(dim, EPS, **kw)

    def forward(self, x, q_input, k_input, v_input, bias=None):
        out = attention(self.q_proj(q_input), self.k_proj(k_input), self.v_proj(v_input),
                        bias, self.n_heads, self.dtype)
        return self.norm(x + self.out_proj(out))


class FFNBlock(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, *, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.fc1 = Dense(dim, ffn_dim, **kw)
        self.fc2 = Dense(ffn_dim, dim, **kw)
        self.norm = LayerNorm(dim, EPS, **kw)

    def forward(self, x):
        return self.norm(x + self.fc2(F.relu(self.fc1(x))))


def mask_attention_bias(masks: torch.Tensor, level_shape: tuple[int, int]) -> torch.Tensor:
    """masks (B, Q, T, H, W) logits -> (B, 1, Q, T*h*w) additive bias: 0 where
    the mask resized to ``level_shape`` is foreground (sigmoid >= 0.5), or
    everywhere for a query with no foreground; NEG_INF elsewhere."""
    b, q, t, hm, wm = masks.shape
    h, w = level_shape
    small = F.interpolate(masks.reshape(b, q * t, hm, wm), size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    fg = (torch.sigmoid(small) >= 0.5).reshape(b, q, t * h * w)
    allow = fg | ~fg.any(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=masks.dtype, device=masks.device)
    return torch.where(allow, zero, NEG_INF)[:, None]


class VideoMaskedTransformerDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, in_channels: int = 256):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        c = cfg.hidden_dim
        self.query_feat = nn.Parameter(torch.empty(cfg.num_queries, c, dtype=cfg.param_dtype))
        self.query_embed = nn.Parameter(torch.empty(cfg.num_queries, c, dtype=cfg.param_dtype))
        self.level_embed = nn.Parameter(torch.empty(3, c, dtype=cfg.param_dtype))
        for i in range(3):
            setattr(self, f"input_proj_{i}", Dense(in_channels, c, **kw))
        for i in range(cfg.dec_layers):
            setattr(self, f"cross_attn_{i}", AttentionBlock(c, cfg.n_heads, **kw))
            setattr(self, f"self_attn_{i}", AttentionBlock(c, cfg.n_heads, **kw))
            setattr(self, f"ffn_{i}", FFNBlock(c, cfg.dim_feedforward, **kw))
        self.decoder_norm = LayerNorm(c, EPS, **kw)
        self.class_embed = Dense(c, cfg.num_classes + 1, **kw)
        self.mask_embed = MLP(c, c, cfg.mask_dim, 3, **kw)
        if cfg.with_reid:
            self.reid_embed = MLP(c, c, cfg.reid_dim, 3, **kw)

    def predict(self, queries, mask_features, level_shape):
        """Heads + next-layer attention bias. queries (B, Q, C); mask_features
        (B, T, H, W, C). Returns (class_logits, masks (B, Q, T, H, W),
        attn_bias (B, 1, Q, T*h*w), embds)."""
        x = self.decoder_norm(queries)
        class_logits = self.class_embed(x)
        mask_embed = self.mask_embed(x)  # (B, Q, mask_dim)
        masks = torch.einsum("bqc,bthwc->bqthw", mask_embed, mask_features)
        bias = mask_attention_bias(masks, level_shape)
        embds = self.reid_embed(x) if self.cfg.with_reid else None
        return class_logits, masks, bias, embds

    def forward(self, multi_scale_features: list[torch.Tensor],  # [(B*T, h, w, C)] x3
                mask_features: torch.Tensor,  # (B, T, H/4, W/4, mask_dim)
                num_frames: int):
        cfg = self.cfg
        dt = cfg.dtype
        b = multi_scale_features[0].shape[0] // num_frames
        t = num_frames
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(multi_scale_features):
            _, h, w, _ = f.shape
            src = getattr(self, f"input_proj_{i}")(f) + self.level_embed[i].to(dt)
            srcs.append(src.reshape(b, t * h * w, cfg.hidden_dim))
            pos = sine_position_embedding_2d(h, w, cfg.hidden_dim, device=f.device).to(dt)
            poss.append(pos[None].expand(t, -1, -1).reshape(1, t * h * w, cfg.hidden_dim))
            shapes.append((h, w))

        queries = self.query_feat[None].to(dt).expand(b, -1, -1)
        q_pos = self.query_embed[None].to(dt)

        outputs = []
        cls_logits, masks, bias, embds = self.predict(queries, mask_features, shapes[0])
        outputs.append({"pred_logits": cls_logits, "pred_masks": masks, "pred_embds": embds})
        for layer in range(cfg.dec_layers):
            lvl = layer % 3
            queries = getattr(self, f"cross_attn_{layer}")(
                queries, queries + q_pos, srcs[lvl] + poss[lvl], srcs[lvl], bias)
            queries = getattr(self, f"self_attn_{layer}")(
                queries, queries + q_pos, queries + q_pos, queries)
            queries = getattr(self, f"ffn_{layer}")(queries)
            cls_logits, masks, bias, embds = self.predict(
                queries, mask_features, shapes[(layer + 1) % 3])
            outputs.append({"pred_logits": cls_logits, "pred_masks": masks,
                            "pred_embds": embds})

        final = outputs[-1]
        return {"pred_logits": final["pred_logits"], "pred_masks": final["pred_masks"],
                "pred_embds": final["pred_embds"], "queries": queries,
                "aux_outputs": outputs[:-1]}
