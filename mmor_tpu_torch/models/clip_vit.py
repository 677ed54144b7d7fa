"""CLIP ViT vision tower (openai/clip-vit-large-patch14-336 geometry).

Counterpart of ``mmor_tpu/models/clip_vit.py`` in patch mode: the feature is
the output of the first ``n_layers - 1`` blocks (hidden layer -2, no final
layernorm) with CLS dropped — 576 patch tokens per 336x336 image. Self
attention runs K1. The global (pooled CLS) mode is a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.config import ClipVitConfig
from mmor_tpu_torch.models.common import Dense, LayerNorm
from mmor_tpu_torch.ops import attention as attn_ops


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipFlashMHA(nn.Module):
    """query/key/value/out projections (flax DenseGeneral layout) around K1."""

    def __init__(self, cfg: ClipVitConfig):
        super().__init__()
        self.n_heads = cfg.n_heads
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.query = Dense(cfg.dim, cfg.dim, **kw)
        self.key = Dense(cfg.dim, cfg.dim, **kw)
        self.value = Dense(cfg.dim, cfg.dim, **kw)
        self.out = Dense(cfg.dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        heads = lambda t: t.reshape(b, s, self.n_heads, -1).transpose(1, 2)
        out = attn_ops.flash_attention(heads(self.query(x)), heads(self.key(x)),
                                       heads(self.value(x)))
        return self.out(out.transpose(1, 2).reshape(b, s, d))


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVitConfig):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.ln1 = LayerNorm(cfg.dim, 1e-5, **kw)
        self.attn = ClipFlashMHA(cfg)
        self.ln2 = LayerNorm(cfg.dim, 1e-5, **kw)
        self.fc1 = Dense(cfg.dim, cfg.mlp_dim, **kw)
        self.fc2 = Dense(cfg.mlp_dim, cfg.dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class ClipVisionTower(nn.Module):
    """(N, H, W, 3) preprocessed pixels -> (N, tokens, dim) patch features."""

    def __init__(self, cfg: ClipVitConfig):
        super().__init__()
        self.cfg = cfg
        # the patch conv is SAME at stride = kernel = 14 on 336: no padding
        self.patch_embed = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                                     bias=False, dtype=cfg.param_dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim, dtype=cfg.param_dtype))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.tokens_per_image + 1, cfg.dim, dtype=cfg.param_dtype))
        self.pre_ln = LayerNorm(cfg.dim, 1e-5, dtype=cfg.dtype,
                                param_dtype=cfg.param_dtype)
        n_run = cfg.n_layers + cfg.feature_layer_offset + 1
        self.blocks = nn.ModuleList(ClipEncoderLayer(cfg) for _ in range(n_run))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if pixels.shape[1] % cfg.patch_size or pixels.shape[2] % cfg.patch_size:
            raise ValueError(f"image {pixels.shape[1:3]} is not a multiple of the "
                             f"{cfg.patch_size}-pixel patch")
        n = pixels.shape[0]
        x = F.conv2d(pixels.to(cfg.dtype).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(cfg.dtype), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (N, 576, D), row-major patches
        cls = self.cls_token.to(cfg.dtype).expand(n, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        x = self.pre_ln(x)
        for block in self.blocks:
            x = block(x)
        return x[:, 1:]
