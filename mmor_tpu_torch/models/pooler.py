"""Multi-view / multi-modal fusion pooler, projector and segmask encoder.

Counterpart of ``mmor_tpu/models/pooler.py``: a post-LN BERT encoder over
the concatenated view tokens (attention masked to present views through K1
segment ids), truncated to ``out_tokens``, then one point-cloud token, one
audio token and the segmask tokens, zeros projected where a modality is
absent, so the output length is static.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.config import PoolerConfig
from mmor_tpu_torch.models.common import Dense, LayerNorm
from mmor_tpu_torch.ops import attention as attn_ops


class FlashMHA(nn.Module):
    """query/key/value/out projections around K1 with segment ids."""

    def __init__(self, cfg: PoolerConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.query = Dense(cfg.hidden, cfg.hidden, **kw)
        self.key = Dense(cfg.hidden, cfg.hidden, **kw)
        self.value = Dense(cfg.hidden, cfg.hidden, **kw)
        self.out = Dense(cfg.hidden, cfg.hidden, **kw)

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        heads = lambda t: t.reshape(b, s, self.n_heads, -1).transpose(1, 2)
        out = attn_ops.flash_attention(heads(self.query(x)), heads(self.key(x)),
                                       heads(self.value(x)), segment_ids=segment_ids)
        return self.out(out.transpose(1, 2).reshape(b, s, d))


class BertLayer(nn.Module):
    """Post-LN transformer encoder layer (BERT convention, eps 1e-12)."""

    def __init__(self, cfg: PoolerConfig):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.attn = FlashMHA(cfg)
        self.ln1 = LayerNorm(cfg.hidden, 1e-12, **kw)
        self.fc1 = Dense(cfg.hidden, cfg.mlp_dim, **kw)
        self.fc2 = Dense(cfg.mlp_dim, cfg.hidden, **kw)
        self.ln2 = LayerNorm(cfg.hidden, 1e-12, **kw)

    def forward(self, x: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.attn(x, segment_ids))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(x + h)


class ImagePooler(nn.Module):
    def __init__(self, cfg: PoolerConfig):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.max_positions, cfg.hidden, dtype=cfg.param_dtype))
        self.token_type_embed = nn.Parameter(
            torch.empty(1, 1, cfg.hidden, dtype=cfg.param_dtype))
        self.embed_ln = LayerNorm(cfg.hidden, 1e-12, **kw)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.n_layers))
        self.project_pc = Dense(cfg.pc_feature_dim, cfg.hidden, **kw)
        self.project_audio = Dense(cfg.audio_dim, cfg.hidden, **kw)

    def forward(self, view_tokens, token_mask, pc_feature=None, audio_embedding=None,
                segmask_features=None) -> torch.Tensor:
        """view_tokens (B, V*tokens_per_view, hidden), token_mask (B, same)
        -> (B, out_tokens + 2 + num_segmask_tokens, hidden)."""
        cfg = self.cfg
        batch, seq, _ = view_tokens.shape
        dt, dev = cfg.dtype, view_tokens.device
        x = (view_tokens.to(dt) + self.pos_embed[:, :seq].to(dt)
             + self.token_type_embed.to(dt))
        x = self.embed_ln(x)
        seg_ids = (token_mask != 0).to(torch.int32)
        for layer in self.layers:
            x = layer(x, seg_ids)
        fused = x[:, : cfg.out_tokens]
        pc = (pc_feature if pc_feature is not None
              else torch.zeros(batch, cfg.pc_feature_dim, dtype=dt, device=dev))
        audio = (audio_embedding if audio_embedding is not None
                 else torch.zeros(batch, cfg.audio_dim, dtype=dt, device=dev))
        seg = (segmask_features if segmask_features is not None
               else torch.zeros(batch, cfg.num_segmask_tokens, cfg.hidden,
                                dtype=dt, device=dev))
        pc_tok = self.project_pc(pc.to(dt))[:, None]
        audio_tok = self.project_audio(audio.to(dt))[:, None]
        return torch.cat([fused, pc_tok, audio_tok, seg.to(dt)], dim=1)


class MMProjector(nn.Module):
    """mlp2x_gelu multimodal projector: hidden -> lm_dim."""

    def __init__(self, in_dim: int, lm_dim: int, dtype=torch.bfloat16,
                 param_dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(in_dim, lm_dim, dtype=dtype, param_dtype=param_dtype)
        self.fc2 = Dense(lm_dim, lm_dim, dtype=dtype, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SegmaskEncoder(nn.Module):
    """32x32 label-map CNN: class-id embedding (30 -> 8), then five stride-2
    3x3 convs (explicit padding 1) of out_dim/16 ... out_dim channels with
    ReLU, then a global average pool."""

    def __init__(self, num_classes: int = 30, embed_dim: int = 8, out_dim: int = 1024,
                 dtype=torch.bfloat16, param_dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.class_embed = nn.Embedding(num_classes, embed_dim, dtype=param_dtype)
        widths = [out_dim // 16, out_dim // 8, out_dim // 4, out_dim // 2, out_dim]
        chans = [embed_dim] + widths
        for i in range(5):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                chans[i], chans[i + 1], 3, stride=2, padding=1, dtype=param_dtype))

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (N, 32, 32) int class ids -> (N, out_dim)."""
        x = self.class_embed(masks.long()).to(self.dtype).permute(0, 3, 1, 2)
        for i in range(5):
            conv = getattr(self, f"conv{i + 1}")
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                                stride=2, padding=1))
        return x.mean(dim=(2, 3))
