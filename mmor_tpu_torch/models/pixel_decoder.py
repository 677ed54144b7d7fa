"""MSDeformAttn pixel decoder: deformable transformer encoder + FPN fusion.

Counterpart of ``mmor_tpu/models/pixel_decoder.py`` (the reference's
``MSDeformAttnPixelDecoder``): res3-res5 projected to ``conv_dim`` (1x1 conv
+ GroupNorm(32)), six deformable-attention encoder layers with sine
positions and level embeddings, maps split back out; res2 fused in by a
lateral 1x1 + GroupNorm, the nearest-upsampled finest map, a 3x3 output conv
+ GroupNorm + relu; a final 3x3 conv emits the 1/4-scale mask features.
Frames are a static size upstream, so there are no padding masks.

Returns (mask_features (N, H/4, W/4, mask_dim), [1/32, 1/16, 1/8] maps), NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmor_tpu_torch.models.common import Conv2d, Dense, GroupNorm, LayerNorm
from mmor_tpu_torch.models.layers import DeformableAttention, sine_position_embedding_2d

EPS = 1e-6  # flax's LayerNorm / GroupNorm default


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, *, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.self_attn = DeformableAttention(d_model, n_levels, n_heads, n_points, **kw)
        self.norm1 = LayerNorm(d_model, EPS, **kw)
        self.fc1 = Dense(d_model, d_ffn, **kw)
        self.fc2 = Dense(d_ffn, d_model, **kw)
        self.norm2 = LayerNorm(d_model, EPS, **kw)

    def forward(self, src, pos, reference_points, spatial_shapes):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + attn)
        h = self.fc2(F.relu(self.fc1(src)))
        return self.norm2(src + h)


def reference_points(spatial_shapes, n_levels: int, device=None) -> torch.Tensor:
    """Per-token normalized centers replicated across levels -> (S, L, 2)."""
    refs = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    ref = torch.cat(refs, dim=0)  # (S, 2)
    return ref[:, None, :].expand(ref.shape[0], n_levels, 2)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` on NCHW: half-pixel centres,
    source index floor((i + 0.5) * in / out) (PyTorch's "nearest-exact";
    its "nearest" takes floor(i * in / out))."""
    return F.interpolate(x, size=size, mode="nearest-exact")


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, conv_dim: int = 256, mask_dim: int = 256, n_layers: int = 6,
                 n_heads: int = 8, n_points: int = 4,
                 transformer_features: tuple[str, ...] = ("res3", "res4", "res5"),
                 fpn_feature: str = "res2",
                 in_channels: dict | None = None, *, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        in_channels = in_channels or {"res2": 256, "res3": 512, "res4": 1024,
                                      "res5": 2048}
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.dtype, self.conv_dim, self.n_layers = dtype, conv_dim, n_layers
        self.transformer_features, self.fpn_feature = transformer_features, fpn_feature
        n_levels = len(transformer_features)
        for name in transformer_features:
            setattr(self, f"input_proj_{name}", Conv2d(in_channels[name], conv_dim, 1, **kw))
            setattr(self, f"input_proj_{name}_norm", GroupNorm(32, conv_dim, EPS, **kw))
        self.level_embed = nn.Parameter(torch.empty(n_levels, conv_dim, dtype=param_dtype))
        for i in range(n_layers):
            setattr(self, f"layer_{i}", DeformableEncoderLayer(
                conv_dim, conv_dim * 4, n_levels, n_heads, n_points, **kw))
        self.fpn_lateral = Conv2d(in_channels[fpn_feature], conv_dim, 1, bias=False, **kw)
        self.fpn_lateral_norm = GroupNorm(32, conv_dim, EPS, **kw)
        self.fpn_output = Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False, **kw)
        self.fpn_output_norm = GroupNorm(32, conv_dim, EPS, **kw)
        self.mask_features = Conv2d(conv_dim, mask_dim, 3, padding=1, **kw)

    def forward(self, features: dict[str, torch.Tensor]):
        n_levels = len(self.transformer_features)
        # high -> low resolution reversed to (res5, res4, res3) like the reference
        srcs, shapes, pos_list = [], [], []
        for name in reversed(self.transformer_features):
            f = features[name].permute(0, 3, 1, 2)  # NHWC -> NCHW view
            n, _, h, w = f.shape
            proj = getattr(self, f"input_proj_{name}_norm")(
                getattr(self, f"input_proj_{name}")(f))
            srcs.append(proj.permute(0, 2, 3, 1).reshape(n, h * w, self.conv_dim))
            shapes.append((h, w))
            pos_list.append(sine_position_embedding_2d(h, w, self.conv_dim,
                                                       device=f.device).to(self.dtype))
        shapes = tuple(shapes)
        src = torch.cat(srcs, dim=1)
        pos = torch.cat([p + self.level_embed[i].to(self.dtype)
                         for i, p in enumerate(pos_list)], dim=0)[None]
        refs = reference_points(shapes, n_levels, device=src.device)[None]
        for i in range(self.n_layers):
            src = getattr(self, f"layer_{i}")(src, pos, refs, shapes)

        # split back to maps, high -> low resolution (res5, res4, res3)
        maps, start = [], 0
        for h, w in shapes:
            maps.append(src[:, start:start + h * w].reshape(-1, h, w, self.conv_dim))
            start += h * w

        # FPN: fuse res2 with the upsampled finest transformer map (res3 scale)
        lateral = self.fpn_lateral_norm(self.fpn_lateral(
            features[self.fpn_feature].permute(0, 3, 1, 2)))
        up = resize_nearest(maps[-1].permute(0, 3, 1, 2), tuple(lateral.shape[-2:]))
        fused = F.relu(self.fpn_output_norm(self.fpn_output(lateral + up)))
        mask_features = self.mask_features(fused)
        return mask_features.permute(0, 2, 3, 1), maps
